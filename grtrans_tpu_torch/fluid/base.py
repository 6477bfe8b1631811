"""Fluid-model framework: sampled state, emissivity inputs, source
parameters and the model registry (reference fluid.f90:49-75, 163-584).

A model is an object with `vals(x, k, a) -> FluidVars` and
`convert(fv, sp) -> EmisInputs`, both over (npix, npts) tensors; a model
with `timedep = True` takes the frame's time as `vals(x, k, a, time=t)`.
Registered: FFJET, HOTSPOT, NUMDISK, PHATDISK, POWERLAW, SARIAF,
SCHNITTMAN, SPHACC, THINDISK, TOY, and the GRMHD snapshot models HARM,
HARM3D, IHARM, HARMPI, THICKDISK, MB09, KORAL (KORALNTH), KORAL3D and its
KORAL3D_DISK / _TOPJET / _BOTJET regions."""

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import torch

from grtrans_tpu_torch import constants as pc

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
    bcgs = bmag * (rhocgs / safe).sqrt() * pc.c * math.sqrt(4.0 * math.pi)
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
    beta = p / (b * b).clamp_min(1e-37) / 0.5
    b2 = beta * beta
    return torch.where(b > 0.0,
                       rhigh * b2 / (1.0 + b2) + rlow / (1.0 + b2), rhigh)


def charles_e(rho, p, u, b, rlow, rhigh):
    """EHT-notes electron temperature (fluid.f90:814-843); p is the
    T_p + T_e type variable and u = T_p + 2 T_e (KORAL convention)."""
    beta = 2.0 * rho * pc.k * p / pc.mp / (b * b).clamp_min(1e-37)
    b2 = beta * beta
    trat = torch.where(b > 0.0,
                       rhigh * b2 / (1.0 + b2) + rlow / (1.0 + b2), rhigh)
    return u / (2.0 + trat)


def ressler_e(rho, kel):
    """Electron-entropy temperature (fluid.f90:894-904)."""
    gamma = 4.0 / 3.0
    thetae = pc.mp / pc.m * kel * rho ** (gamma - 1.0)
    return thetae * pc.m * pc.c2 / pc.k


def werner_e(rho, bmag):
    """Werner+2018 dissipation fraction (fluid.f90:906-911)."""
    sig = bmag ** 2 / rho.clamp_min(1e-37) / 5.0
    return 0.25 + 0.25 * (sig / (2.0 + sig)).sqrt()


def nonthermale_b2(alpha, gmin, p1, bmagrho, bcgs):
    """Jet nonthermal electron density where sigma > 1
    (fluid.f90:914-923)."""
    n = alpha * bcgs ** 2 / (8.0 * math.pi) / gmin \
        * (p1 - 2.0) / (p1 - 1.0) / 8.2e-7
    return torch.where(bmagrho > 1.0, n, 0.0)


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


def calc_gmin(p, thetae, eta):
    """Nonthermal gamma_min and number fraction for the stype='tail'
    model (reference calcgmin.f90).  Returns (gmin, nfrac)."""
    acenter = 0.5668090982352612
    anormal = 0.52624783
    azero = 3.0 / math.sqrt(2.0)
    astwo = math.log(math.sqrt(2.0))
    if p == 3.5:
        lin_cons, lin_coeff, lin_power = (16.0797900684, -13.5593749125,
                                          0.276589155355)
        inv_cons, inv_coeff, inv_power = (0.722506578136, 151.597731214,
                                          6.53997654139)
        inv_sin_coeff = inv_sin_freq = inv_sin_delay = 0.0
        lin_sin_coeff = lin_sin_freq = lin_sin_delay = 0.121815691108
    else:
        lin_cons, lin_coeff, lin_power = 21.38307186, -16.7811712, 0.15128533
        inv_cons, inv_coeff, inv_power = 0.74798712, 0.62609462, 0.81567379
        inv_sin_coeff, inv_sin_freq, inv_sin_delay = (0.00638946501,
                                                      -16.8034428,
                                                      3.72208398)
        lin_sin_coeff = lin_sin_freq = lin_sin_delay = 0.0
    lin_const = (lin_cons + lin_coeff * eta ** lin_power
                 + lin_sin_coeff * math.sin(eta * lin_sin_freq
                                            + lin_sin_delay))
    inv_const = (inv_cons + inv_coeff * eta ** inv_power
                 + inv_sin_coeff * math.sin(eta * inv_sin_freq
                                            + inv_sin_delay))
    gmin = (thetae * lin_const + inv_const).clamp_min(1.0)
    atheta = thetae * azero * torch.exp(
        astwo * torch.tanh(anormal * torch.log(thetae / acenter)))
    nfrac = eta * atheta * (p - 2.0) / (p - 1.0) * gmin ** (p - 2.0)
    return gmin, nfrac


def apply_source_params(ei, sp):
    """Apply the stype gamma_min model (reference assign_source_params,
    fluid.f90:1641-1678).  Returns (ei, gmin): CONST passes ei through
    with the scalar sp.gmin; TAIL replaces ncgsnth by the thermal tail
    and returns a per-sample gmin."""
    if sp.stype != TAIL:
        return ei, sp.gmin
    thetae = sp.mu * pc.k * ei.tcgs / (pc.m * pc.c2)
    gmin, nfrac = calc_gmin(sp.p2, thetae, sp.jetalpha)
    over = gmin > sp.gmax
    gmin_used = torch.where(over, sp.gmax / 2.0, gmin)
    # gmin clamped from above: fold the lost tail into the density
    factor = torch.where(
        over, (sp.gmax / 2.0 / torch.where(over, gmin, 1.0))
        ** (sp.p2 - 2.0), 1.0)
    ncgsnth = factor * torch.where(
        nfrac > 0.0, nfrac * ei.ncgs * gmin_used ** (1.0 - sp.p2), 0.0)
    return ei._replace(ncgsnth=ncgsnth), gmin_used


def one_snapshot(nt):
    """The reference's nt, the count of dump files read as a time series
    (the namelists' fnt), which grtrans_tpu's snapshot models accept: the
    port loads one snapshot and grows a series with append_slice."""
    if nt != 1:
        raise NotImplementedError(
            f"nt={nt}: load one snapshot and add slices with append_slice")


def not_read(name, **given):
    """Keywords that model `name` takes, as grtrans_tpu's does (so that a
    namelist's fargs filter alike), and never reads: each given as
    (value, default), and refused unless it keeps its default."""
    for key, (value, default) in given.items():
        if value != default:
            raise ValueError(f"{name} does not read {key} (got {value!r}; "
                             f"only the default {default!r} is taken)")


_REGISTRY: Dict[str, Callable] = {}


def register(name):
    """Register a model factory `f(device=..., **fargs)` under `name`.
    inspect.signature of the factory names the fargs it takes (a factory
    that passes **fargs on sets __wrapped__ to their consumer)."""
    def deco(factory):
        _REGISTRY[name.upper()] = factory
        return factory
    return deco


def import_all_models():
    """Import every model module, which fills the registry."""
    from grtrans_tpu_torch.fluid import (analytic, disks, ffjet,  # noqa: F401
                                         harm, harm3d, harmpi, hotspot,
                                         iharm, koral, mb09, sphacc,
                                         thickdisk)


def load_fluid_model(name, *, device, **kwargs):
    """Instantiate a fluid model by fname on `device`
    (fluid.f90:163-243)."""
    import_all_models()
    factory = _REGISTRY.get(name.upper())
    if factory is None:
        raise ValueError(f"unknown fluid model {name!r}; have "
                         f"{sorted(_REGISTRY)}")
    return factory(device=device, **kwargs)
