"""Sorted-table search, multilinear interpolation, the cumulative
trapezoid and SLATEC's POLINT / POLYVL (reference interpolate.f90:15-232,
math.f90:30-44, polint.f, polyvl.f), batched over any number of query
points.  Port of grtrans_tpu/ops/interp.py.

Cells are integer tensors, weights float64 tensors on the table's device.
The corner-packed tables of the renderer's lookups (pack_corners_2d,
bilinear_packed) are ops.quad_gather's, exposed here under grtrans_tpu's
names and signatures.
"""

import numpy as np
import torch

from grtrans_tpu_torch.ops import quad_gather
from grtrans_tpu_torch.ops.quad_gather import bilinear_packed  # noqa: F401


def get_weight(xarr, x):
    """Fractional index of x in the sorted 1-D table xarr: (ix, w) with
    xarr[ix] <= x <= xarr[ix+1] (ix clamped to [0, n-2]) and w the linear
    weight of xarr[ix+1]."""
    n = xarr.shape[0]
    ix = (torch.searchsorted(xarr, x.contiguous(), right=True)
          .to(torch.int32) - 1).clamp(0, n - 2)
    x0 = xarr[ix]
    x1 = xarr[ix + 1]
    w = (x - x0) / torch.where(x1 == x0, 1.0, x1 - x0)
    return ix, w


def interp_1d(yarr, xarr, x):
    """Linear interpolation of yarr(xarr) at x; beyond the table the end
    cells extrapolate."""
    ix, w = get_weight(xarr, x)
    return yarr[ix] * (1.0 - w) + yarr[ix + 1] * w


def bilinear(f, ix, iy, wx, wy):
    """Bilinear interpolation of f[..., nx, ny] in cells (ix, iy) with
    fractional weights (wx, wy) (interpolate.f90:108-140, interp2)."""
    f00 = f[..., ix, iy]
    f10 = f[..., ix + 1, iy]
    f01 = f[..., ix, iy + 1]
    f11 = f[..., ix + 1, iy + 1]
    return (f00 * (1 - wx) * (1 - wy) + f10 * wx * (1 - wy)
            + f01 * (1 - wx) * wy + f11 * wx * wy)


def trilinear(f, ix, iy, iz, wx, wy, wz):
    """Trilinear interpolation of f[..., nx, ny, nz] (interp3)."""
    c00 = f[..., ix, iy, iz] * (1 - wx) + f[..., ix + 1, iy, iz] * wx
    c10 = f[..., ix, iy + 1, iz] * (1 - wx) + f[..., ix + 1, iy + 1, iz] * wx
    c01 = f[..., ix, iy, iz + 1] * (1 - wx) + f[..., ix + 1, iy, iz + 1] * wx
    c11 = (f[..., ix, iy + 1, iz + 1] * (1 - wx)
           + f[..., ix + 1, iy + 1, iz + 1] * wx)
    c0 = c00 * (1 - wy) + c10 * wy
    c1 = c01 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def quadlinear(f, idx, w):
    """4-D multilinear interpolation of f[..., n0, n1, n2, n3]; idx and w
    are length-4 sequences of cells and weights (interp4, the
    time-interpolated snapshot lookup)."""
    i0, i1, i2, i3 = idx
    w0, w1, w2, w3 = w
    out = 0.0
    for d0 in (0, 1):
        for d1 in (0, 1):
            for d2 in (0, 1):
                for d3 in (0, 1):
                    ww = ((w0 if d0 else 1 - w0) * (w1 if d1 else 1 - w1)
                          * (w2 if d2 else 1 - w2) * (w3 if d3 else 1 - w3))
                    out = out + f[..., i0 + d0, i1 + d1, i2 + d2,
                                  i3 + d3] * ww
    return out


def tsum(x, y):
    """Cumulative trapezoidal integral of y(x) along the last axis,
    first element 0."""
    dx = x[..., 1:] - x[..., :-1]
    seg = 0.5 * (y[..., 1:] + y[..., :-1]) * dx
    return torch.cat([torch.zeros_like(y[..., :1]), seg.cumsum(-1)], dim=-1)


def stack_grid_fields(fields, order, *, device):
    """Named 2-D grids (n1, n2) stacked minor-most and flattened to an
    (n1 n2, len(order)) float64 table on `device`: a bilinear sample of
    every field is then 4 rows."""
    st = np.stack([np.asarray(fields[k], np.float64) for k in order], -1)
    return torch.as_tensor(st.reshape(-1, len(order)), device=device)


def bilinear_stacked(G, n2, i1, i2, w1, w2):
    """Bilinear sample of a stack_grid_fields table G ((n1 n2, nf), axis
    n2 minor) in cells (i1, i2) with weights (w1, w2).  Returns
    i1.shape + (nf,)."""
    i00 = i1 * n2 + i2
    return (G[i00] * ((1 - w1) * (1 - w2))[..., None]
            + G[i00 + n2] * (w1 * (1 - w2))[..., None]
            + G[i00 + 1] * ((1 - w1) * w2)[..., None]
            + G[i00 + n2 + 1] * (w1 * w2)[..., None])


def pack_corners_2d(fields, order, *, device):
    """The corner-packed table (n1 n2, 4 nf) of named 2-D grids, float64
    on `device` (quad_gather.pack_corners_2d of the stack in `order`):
    row (i1, i2) holds the cell's corners (0,0), (1,0), (0,1), (1,1).
    bilinear_packed samples it."""
    st = np.stack([np.asarray(fields[k], np.float64) for k in order], -1)
    return torch.as_tensor(quad_gather.pack_corners_2d(st), device=device)


def polint(x, y):
    """Newton divided-difference coefficients c (..., n) of the polynomial
    through (x_i, y_i), x and y (..., n), by SLATEC POLINT's recurrence
    (polint.f:44-57): p(t) = c0 + (t - x0)(c1 + (t - x1)(c2 + ...))."""
    n = x.shape[-1]
    cs = [y[..., 0]]
    for k in range(1, n):
        ck = y[..., k]
        for i in range(k):
            ck = (cs[i] - ck) / (x[..., i] - x[..., k])
        cs.append(ck)
    return torch.stack(cs, dim=-1)


def polyvl(xx, x, c, nder=0):
    """The POLINT polynomial at xx (SLATEC POLYVL): yfit, or with nder > 0
    (yfit, [p', p'', ...]) from the Newton form's derivative recurrence
    p_k^(d) = (t - x_k) p_{k+1}^(d) + d p_{k+1}^(d-1)."""
    n = x.shape[-1]
    p = [c[..., n - 1]] + [torch.zeros_like(c[..., 0])] * nder
    for k in range(n - 2, -1, -1):
        t = xx - x[..., k]
        for d in range(nder, 0, -1):
            p[d] = t * p[d] + d * p[d - 1]
        p[0] = c[..., k] + t * p[0]
    return p[0] if nder == 0 else (p[0], p[1:])
