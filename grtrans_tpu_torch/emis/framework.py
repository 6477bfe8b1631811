"""Emissivity post-processing: the 11 -> (j, K) split, the rotation into
the observer's polarization basis and the Lorentz-invariant scalings
(reference emis.f90:797-838).  K layout [aI aQ aU aV rhoQ rhoU rhoV]."""

import torch

from grtrans_tpu_torch.emis.polsynch import NE


def from_columns(columns):
    """(..., NE) coefficient block, zero but for the given
    {column: values}; the values broadcast against each other."""
    shape = torch.broadcast_shapes(*(v.shape for v in columns.values()))
    first = next(iter(columns.values()))
    z = torch.zeros(shape, dtype=first.dtype, device=first.device)
    return torch.stack([columns[i].expand(shape) if i in columns else z
                        for i in range(NE)], dim=-1)


def split_e(e):
    """(..., 11) coefficient block -> (j (..., 4), K (..., 7))."""
    return e[..., 0:4], e[..., 4:11]


def rotate_emis(j, K, s2xi, c2xi):
    """Rotate the (Q, U) emission, absorption and Faraday components by
    the basis angle 2 xi (Shcherbakov & Huang 2011; emis.f90:797-829)."""
    ji, jq, ju, jv = j.unbind(-1)
    ai, aq, au, av, rq, ru, rv = K.unbind(-1)
    j = torch.stack([ji, c2xi * jq - s2xi * ju, s2xi * jq + c2xi * ju, jv],
                    dim=-1)
    K = torch.stack([ai, c2xi * aq - s2xi * au, s2xi * aq + c2xi * au, av,
                     c2xi * rq - s2xi * ru, s2xi * rq + c2xi * ru, rv], dim=-1)
    return j, K


def invariant_emis(j, K, g):
    """Lorentz-invariant scalings j -> j g^2, K -> K / g
    (emis.f90:831-838)."""
    return j * (g * g)[..., None], K / g[..., None]


def invariant_intensity(j, g, npow):
    """I_nu / nu^npow scaling of thin-disk surface emission
    (emis.f90:840-847)."""
    return j * (g ** npow)[..., None]
