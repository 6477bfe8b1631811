"""Chandrasekhar (1960, "Radiative Transfer", Table XXIV): emergent
intensity I(mu) and polarization degree delta(mu) for electron scattering
from a semi-infinite atmosphere, used for thin-disk polarization
(reference chandra_tab24.f90 + ch24_vals.txt).  The 21-point table is the
published data, limb darkening normalized so that the flux-weighted mean
is ~1."""

import torch

from grtrans_tpu_torch.ops.interp import get_weight

CH_MU = (0.00, 0.05, 0.10, 0.15, 0.20, 0.25, 0.30, 0.35, 0.40, 0.45, 0.50,
         0.55, 0.60, 0.65, 0.70, 0.75, 0.80, 0.85, 0.90, 0.95, 1.00)
CH_I = (0.41441, 0.47490, 0.52397, 0.57001, 0.61439, 0.65770, 0.70029,
        0.74234, 0.78398, 0.82530, 0.86637, 0.90722, 0.94789, 0.98842,
        1.02882, 1.06911, 1.10931, 1.14943, 1.18947, 1.22945, 1.26938)
CH_DELTA = (0.11713, 0.08979, 0.07448, 0.06311, 0.05410, 0.04667, 0.04041,
            0.03502, 0.03033, 0.02619, 0.02252, 0.01923, 0.01627, 0.01358,
            0.011123, 0.00888, 0.006818, 0.004919, 0.003155, 0.001522, 0.0)


def interp_chandra(mu):
    """(I(mu), delta(mu)) linearly interpolated; mu = emission cosine.
    The table is built on mu's device."""
    like = dict(dtype=mu.dtype, device=mu.device)
    ch_mu, ch_i, ch_d = (torch.tensor(t, **like)
                         for t in (CH_MU, CH_I, CH_DELTA))
    ix, w = get_weight(ch_mu, mu.clamp(0.0, 1.0))
    ix = ix.long()
    return (ch_i[ix] * (1 - w) + ch_i[ix + 1] * w,
            ch_d[ix] * (1 - w) + ch_d[ix + 1] * w)
