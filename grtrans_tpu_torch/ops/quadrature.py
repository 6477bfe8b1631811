"""Gauss-Legendre quadrature: nodes on [0, 1] (numpy, cached) and batched
integrals (port of grtrans_tpu/ops/quadrature.py; the reference's GAULEG,
geokerr_wrapper.f:3492)."""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def gl_nodes(n):
    """(nodes, weights) for n-point Gauss-Legendre on [0, 1], as numpy."""
    x, w = np.polynomial.legendre.leggauss(n)
    return ((x + 1.0) / 2.0, w / 2.0)


def gl_tensors(n, like):
    """gl_nodes(n) as tensors of `like`'s dtype on its device."""
    x, w = gl_nodes(n)
    return (torch.as_tensor(x, dtype=like.dtype, device=like.device),
            torch.as_tensor(w, dtype=like.dtype, device=like.device))


def integrate(f, a, b, n=32):
    """int_a^b f(t) dt by n-point Gauss-Legendre, f vectorized; a and b
    broadcast (float64, on the device of the tensor among them)."""
    dev = next((v.device for v in (a, b) if isinstance(v, torch.Tensor)),
               None)
    if dev is None:
        raise TypeError("pass a or b as a tensor: it names the device")
    a, b = torch.broadcast_tensors(
        torch.as_tensor(a, dtype=torch.float64, device=dev),
        torch.as_tensor(b, dtype=torch.float64, device=dev))
    x, w = gl_tensors(n, a)
    t = a[..., None] + (b - a)[..., None] * x
    return (f(t) * w).sum(-1) * (b - a)


def cumulative_segments(f, pts, n=8):
    """F[..., i] = int_{pts[..., 0]}^{pts[..., i]} f along the sorted grid
    pts (..., npts), F[..., 0] = 0: n-point Gauss-Legendre on each segment
    of the exact integrand, O(h^2n) a segment."""
    x, w = gl_tensors(n, pts)
    a = pts[..., :-1]
    b = pts[..., 1:]
    t = a[..., None] + (b - a)[..., None] * x
    seg = (f(t) * w).sum(-1) * (b - a)
    return torch.cat([torch.zeros_like(pts[..., :1]), seg.cumsum(-1)], dim=-1)
