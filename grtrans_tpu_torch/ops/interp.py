"""Sorted-table search and the cumulative trapezoid (reference
interpolate.f90:67-106, math.f90:30-44)."""

import torch


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


def tsum(x, y):
    """Cumulative trapezoidal integral of y(x) along the last axis,
    first element 0."""
    dx = x[..., 1:] - x[..., :-1]
    seg = 0.5 * (y[..., 1:] + y[..., :-1]) * dx
    return torch.cat([torch.zeros_like(y[..., :1]), seg.cumsum(-1)], dim=-1)
