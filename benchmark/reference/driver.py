"""The per-ray rendering pipeline, batched over the rays handed to it
(reference grtrans_driver.f90:57-465): fluid state -> comoving tetrad ->
coefficients -> rotation and invariant scalings -> Stokes integration,
in float64, for the ray-integrating branch (standard=1) and the
synchrotron emissivities of the benchmark's configurations."""

import math

import torch

from . import constants as pc
from . import framework, polsynch
from . import polsynchpl as pl_mod
from . import solvers, tetrad
from .fluidbase import apply_source_params


def calc_emissivity(ename, nu, ei, ang, sp, gmin):
    """(npix, npts, 11) coefficient block for emissivity `ename`
    (reference emis.f90:461-571)."""
    ename = ename.upper()
    if ename == "POLSYNCHTH":
        return polsynch.polsynchth(nu, ei.ncgs, ei.bcgs, ei.tcgs, ang)
    if ename == "POLSYNCHPL":
        return pl_mod.polsynchpl(nu, ei.ncgsnth, ei.bcgs, ang, sp.p1, gmin,
                                 sp.gmax)
    raise ValueError(f"the reference has no emissivity {ename!r}")


def render_rays(geo, fv, ei, ename, freqs, mu0, alpha, beta, a, mbh, sp,
                iname="formal", nvals=4):
    """Observed Stokes of the rays of `geo` for a list of frequencies:
    (nfreq, npix, nvals), float64."""
    r = geo.x[..., 1]
    th = geo.x[..., 2]
    okf = torch.isfinite(fv.u).all(-1) & torch.isfinite(fv.b).all(-1)
    like = dict(dtype=fv.u.dtype, device=fv.u.device)
    u_safe = torch.where(okf[..., None], fv.u,
                         torch.tensor([1.0, 0.0, 0.0, 0.0], **like))
    b_safe = torch.where(okf[..., None], fv.b,
                         torch.tensor([0.0, 0.0, 0.0, 1.0], **like))
    s2xi, c2xi, ang, g, cosne, frame_ok = tetrad.comoving_ortho(
        r, th, a, alpha[:, None], beta[:, None], mu0, u_safe, b_safe, geo.k)
    ok = (geo.valid & okf & frame_ok & torch.isfinite(g)
          & torch.isfinite(s2xi) & torch.isfinite(c2xi)
          & torch.isfinite(ang))
    s2xi = torch.where(ok, s2xi, 0.0)
    c2xi = torch.where(ok, c2xi, 1.0)
    ang = torch.where(ok, ang, math.pi / 2.0)
    g = torch.where(ok, g, 1.0).clamp(1e-8, 1e8)
    lbh = pc.lbh(mbh)
    ei, gmin_eff = apply_source_params(ei, sp)
    out = []
    for fghz in freqs:
        nu = fghz / g
        e = calc_emissivity(ename, nu, ei, ang, sp, gmin_eff)
        if sp.coefindx is not None:
            e = e * torch.tensor((1.0,) * 4 + tuple(sp.coefindx),
                                 dtype=e.dtype, device=e.device)
        e = torch.where(ok[..., None], e, 0.0)
        e = torch.where(torch.isfinite(e), e, 0.0)
        j, K = framework.split_e(e)
        if nvals == 4:
            j, K = framework.rotate_emis(j, K, s2xi, c2xi)
        j, K = framework.invariant_emis(j, K, g)
        j = j * lbh
        K = K * lbh
        Iobs = solvers.observed_stokes(geo.lam, j, K, method=iname, mask=ok)
        out.append(Iobs[..., :nvals])
    return torch.stack(out, dim=0)
