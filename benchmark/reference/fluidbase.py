"""Fluid-model framework: sampled state, emissivity inputs, source
parameters and the unit conversions of the snapshot models (reference
fluid.f90:49-75, 765-810, 874-892).  A model is an object with
`vals(x, k, a) -> FluidVars` and `convert(fv, sp) -> EmisInputs`, both
over (npix, npts) tensors."""

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from . import constants as pc

CONST, TAIL = 0, 1


class FluidVars(NamedTuple):
    """Fluid state sampled along rays; tensors (npix, npts[, 4])."""
    rho: torch.Tensor     # density-like primary variable (model units)
    p: torch.Tensor       # pressure / temperature-like variable
    bmag: torch.Tensor    # field strength (model units)
    u: torch.Tensor       # four-velocity (BL, contravariant)
    b: torch.Tensor       # magnetic four-vector (BL)
    rho2: torch.Tensor    # secondary density (nonthermal electrons)
    fnu: Optional[torch.Tensor] = None    # tabulated F_nu (PHATDISK)
    nbins: Optional[torch.Tensor] = None  # nonthermal electron bins (KORAL)
    kela: Optional[torch.Tensor] = None   # electron entropy (GRMHD models)
    be: Optional[torch.Tensor] = None     # Bernoulli / T_ion (KORAL)
    # further sampled columns by name (HARMPI's kelb..keld, a snapshot's
    # extra fields): what convert needs travels with the sample, not on
    # the model
    extra: Optional[Dict[str, torch.Tensor]] = None


class EmisInputs(NamedTuple):
    """cgs inputs to the emissivity functions."""
    ncgs: torch.Tensor
    tcgs: torch.Tensor
    bcgs: torch.Tensor
    ncgsnth: torch.Tensor
    fnu: Optional[torch.Tensor] = None       # (npix, npts, nfreq_tab)
    freq_tab: Optional[torch.Tensor] = None  # (nfreq_tab,)
    # binned nonthermal electron populations (SYNCHBIN)
    nbins: Optional[torch.Tensor] = None     # (npix, npts, nbin) [cm^-3]
    gammas: Optional[torch.Tensor] = None    # (nbin,) bin centers
    dgammas: Optional[torch.Tensor] = None   # (nbin,) bin widths


@dataclass
class SourceParams:
    """Reference source_params (fluid.f90:69-75)."""
    nfac: float = 1.0
    mbh: float = 10.0
    mdot: float = 1e15
    mu: float = 0.25
    gmin: float = 100.0
    gmax: float = 1e5
    p1: float = 3.5
    p2: float = 3.5
    jetalpha: float = 0.02
    stype: int = CONST
    sigcut: float = 1e10
    otherargs: Optional[tuple] = None
    coefindx: Optional[tuple] = None


def scale_sim_units(mbh, mdotcgs, mdot_code, rho, p, bmag):
    """GRMHD code units -> cgs (fluid.f90:765-790).  Returns (ncgs, bcgs,
    tempcgs, rhocgs)."""
    lcgs = pc.G * mbh * pc.msun / pc.c ** 2
    tcgs = lcgs / pc.c
    rhocgs = mdotcgs / mdot_code / lcgs ** 3 * tcgs * rho
    ncgs = rhocgs / pc.mp
    safe = torch.where(rho > 0, rho, 1.0)
    pcgs = p * rhocgs / safe * pc.c ** 2
    tempcgs = pcgs / ncgs.clamp_min(1e-37) / pc.k
    # rhocgs / rho is the density unit; at rho = 0 (a sample off the grid)
    # its sqrt would be sqrt(0), whose derivative is infinite, so that
    # sample takes the unit 1 and bcgs 0 (double where: finite gradient)
    empty = rho == 0
    bcgs = torch.where(empty, 0.0, bmag * torch.where(
        empty, 1.0, rhocgs / safe).sqrt() * pc.c * math.sqrt(4.0 * math.pi))
    return ncgs, bcgs, tempcgs, rhocgs


def sigma_cut(bcgs, rhocgs, tempcgs, ncgs, sigcut):
    """Zero out high-magnetization zones (fluid.f90:792-810).  Returns
    (rhocgs, ncgs, tempcgs)."""
    sigma = bcgs * bcgs / (rhocgs * 8.988e20 * 4.0 * math.pi).clamp_min(
        1e-37)
    hot = sigma >= sigcut
    return (torch.where(hot, 0.0, rhocgs), torch.where(hot, 0.0, ncgs),
            torch.where(hot, 1e9, tempcgs))


def monika_e(rho, p, b, rlow, rhigh):
    """Moscibrodzka+2016 R(beta) temperature-ratio prescription
    (fluid.f90:874-892); beta = p / (b^2 / 2) in code units."""
    live = b > 0.0
    b = torch.where(live, b, 1.0)     # the other branch's operand, finite
    beta = p / (b * b).clamp_min(1e-37) / 0.5
    b2 = beta * beta
    return torch.where(live, rhigh * b2 / (1.0 + b2) + rlow / (1.0 + b2),
                       rhigh)


def toroidal_b(g_cov, u, bmag):
    """Purely toroidal magnetic four-vector with |b| = bmag and b.u = 0
    (fluid.f90:1404-1416)."""
    gtt = g_cov[..., 0]
    gtp = g_cov[..., 3]
    gpp = g_cov[..., 9]
    aleph = -(gtp * u[..., 0] + gpp * u[..., 3]) \
        / (gtt * u[..., 0] + gtp * u[..., 3])
    bb = gtt * aleph * aleph + gpp + 2.0 * gtp * aleph
    pos = bb > 0.0
    bphi = torch.where(pos, bmag / torch.where(pos, bb, 1.0).sqrt(), 0.0)
    z = torch.zeros_like(bphi)
    return torch.stack([aleph * bphi, z, z, bphi], dim=-1)


def apply_source_params(ei, sp):
    """The stype gamma_min model (reference assign_source_params,
    fluid.f90:1641-1678) for stype CONST, the configurations' own: ei and
    the scalar sp.gmin."""
    if sp.stype != CONST:
        raise ValueError("the reference takes stype 'const' only")
    return ei, sp.gmin
