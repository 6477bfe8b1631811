"""Gauss-Legendre nodes on [0, 1] (numpy, cached; the reference's GAULEG,
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


