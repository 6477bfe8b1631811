"""The HARM family's shared pieces (reference fluid_model_harm.f90):
the MKS(h) theta map's Newton inversion, MKS -> KS -> BL four-vector
transforms (:74-100 + kerr.uks2ubl), the LNRF storage and its inverse,
and scale_sim_units + Moscibrodzka electron temperatures
(fluid.f90:957-973)."""

import math

import numpy as np
import torch

from . import fluidbase as base
from .fluidbase import EmisInputs
from . import fourvector as fv
from . import kerr

def f64(x):
    """numpy array or number -> float64 CPU tensor."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def x2_of_theta(th, h, iters=30):
    """Invert theta(x2) by `iters` Newton steps (the map is monotonic);
    batched over the tensor th."""
    x2 = th / math.pi
    for _ in range(iters):
        f = math.pi * x2 + 0.5 * (1.0 - h) * torch.sin(2.0 * math.pi * x2) \
            - th
        df = math.pi * (1.0 + (1.0 - h) * torch.cos(2.0 * math.pi * x2))
        x2 = x2 - f / df.clamp_min(1e-10)
    return x2.clamp(0.0, 1.0)


def umks2uks_bl(um, r, x2, h, a):
    """MKS four-vector -> KS -> BL (fluid_model_harm.f90:74-100 +
    kerr.uks2ubl)."""
    dthdx2 = math.pi * (1.0 + (1.0 - h) * torch.cos(2.0 * math.pi * x2))
    uks = torch.stack([um[..., 0], r * um[..., 1], um[..., 2] * dthdx2,
                       um[..., 3]], dim=-1)
    return kerr.uks2ubl(uks, r, a)


def lnrf_storage(u_bl, b_bl, r, th, a):
    """BL four-vectors -> the stored columns (u0, LNRF velocities, b^mu):
    velocities are kept as LNRF components so that interpolation stays
    subluminal."""
    vrl, vtl, vpl = kerr.lnrf_frame(u_bl[..., 1] / u_bl[..., 0],
                                    u_bl[..., 2] / u_bl[..., 0],
                                    u_bl[..., 3] / u_bl[..., 0], r, a, th)
    return {"u0": u_bl[..., 0], "vrl": vrl, "vtl": vtl, "vpl": vpl,
            "b0": b_bl[..., 0], "br": b_bl[..., 1], "bth": b_bl[..., 2],
            "bph": b_bl[..., 3]}


def four_vectors(col, outside, r, th, a):
    """Sampled columns -> (u, b, bmag) in BL: outside-grid defaults
    (u = (1, 0, 0, 0), b = (0, 0, 0, 1)), LNRF -> BL, |b|."""
    u0 = torch.where(outside, 1.0, col["u0"])
    vrl = torch.where(outside, 0.0, col["vrl"])
    vtl = torch.where(outside, 0.0, col["vtl"])
    vpl = torch.where(outside, 0.0, col["vpl"])
    b = torch.stack([col["b0"], col["br"], col["bth"], col["bph"]], dim=-1)
    unit = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=b.dtype, device=b.device)
    b = torch.where(outside[..., None], unit, b)
    bmag = kerr.safe_sqrt(fv.dot(kerr.metric_cov(r, th, a), b, b))
    vr, vth, om = kerr.lnrf_frame_inv(vrl, vtl, vpl, r, a, th)
    u = torch.stack([u0, u0 * vr, u0 * vth, u0 * om], dim=-1)
    return u, b, bmag


def harm_convert(fv_, sp, mdot_code):
    """scale_sim_units + Moscibrodzka R(beta) electron temperature
    (convert_fluidvars_harm, fluid.f90:957-973)."""
    ncgs, bcgs, tempcgs, rhocgs = base.scale_sim_units(
        sp.mbh, sp.mdot, mdot_code, fv_.rho, fv_.p, fv_.bmag)
    trat = base.monika_e(fv_.rho, fv_.p, fv_.bmag, sp.mu, sp.mu / sp.gmin)
    tempcgs = tempcgs * trat
    rhocgs, ncgs, tempcgs = base.sigma_cut(bcgs, rhocgs, tempcgs, ncgs,
                                           sp.sigcut)
    return EmisInputs(ncgs=ncgs, tcgs=tempcgs, bcgs=bcgs, ncgsnth=ncgs)
