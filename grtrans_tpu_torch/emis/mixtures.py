"""Multi-Maxwellian mixture emissivities MAXJUTT and MAXCOMP (reference
calc_maxjutt.f90 :8-67, calc_maxcomp.f90 :8-70).  Both approximate a
nonthermal (kappa-like) electron distribution by a weighted sum of
Maxwell-Juttner components on a geometric temperature ladder

    T_i = T_min * delta**i,   T_min = T / sum_i w_i delta**i

so that the total electron energy matches the fluid temperature.  The
coefficients are the w_i-weighted sum of polsynchth over the ladder.
MAXCOMP also replaces the emission block (j_I..j_V) by that of one
selected component while keeping the summed absorption."""

import numpy as np
import torch

from grtrans_tpu_torch.emis import polsynch


def _ladder(tcgs, otherargs):
    """Weights and ladder factors as Python floats, T_min as a tensor."""
    delta = float(otherargs[0])
    w = np.asarray(otherargs[1:], dtype=np.float64)
    w = w / np.sum(w)
    deltas = delta ** np.arange(w.shape[0], dtype=np.float64)
    tmin = tcgs / float(np.sum(w * deltas))
    return [float(v) for v in w], [float(v) for v in deltas], tmin


def maxjutt(nu, ncgs, bcgs, tcgs, ang, otherargs=(3.5, 1, 1, 1, 1, 1, 1)):
    """Weighted Maxwell-Juttner sum (calc_maxjutt.f90:8-67);
    otherargs = (delta, w_0, w_1, ..., w_{m-1})."""
    w, deltas, tmin = _ladder(tcgs, otherargs)
    total = 0.0
    for wi, di in zip(w, deltas):
        total = total + polsynch.polsynchth(nu, wi * ncgs, bcgs, tmin * di,
                                            ang)
    return total


def maxcomp(nu, ncgs, bcgs, tcgs, ang,
            otherargs=(3.5, 1, 1, 1, 1, 1, 1, 1)):
    """Maxwellian-decomposition emissivity (calc_maxcomp.f90:8-70);
    otherargs = (delta, selection, w_0, ..., w_{m-1}).  selection in 1..m
    (1-based like the reference) picks the component whose emission
    replaces the total's; selection <= 0 leaves the sum."""
    isel = int(otherargs[1])
    rest = (otherargs[0],) + tuple(otherargs[2:])
    w, deltas, tmin = _ladder(tcgs, rest)
    total = maxjutt(nu, ncgs, bcgs, tcgs, ang, rest)
    if 0 < isel <= len(w):
        sel = polsynch.polsynchth(nu, w[isel - 1] * ncgs, bcgs,
                                  tmin * deltas[isel - 1], ang)
        total = torch.cat([sel[..., :4], total[..., 4:]], dim=-1)
    return total
