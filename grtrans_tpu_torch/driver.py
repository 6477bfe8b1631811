"""The per-ray rendering pipeline, batched over all pixels (reference
grtrans_driver.f90:57-465): fluid state -> comoving tetrad ->
coefficients -> rotation and invariant scalings -> Stokes integration.
Port of grtrans_tpu/driver.py for the observer-Stokes path (nvals 1 or
4, extra=0, standard=1) in float64, for the synchrotron emissivities and
every ported integrator."""

import math

import torch

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch.emis import framework, polsynch
from grtrans_tpu_torch.emis import polsynchpl as pl_mod
from grtrans_tpu_torch.fluid.base import apply_source_params
from grtrans_tpu_torch.geometry import tetrad
from grtrans_tpu_torch.integrate import solvers


def calc_emissivity(ename, nu, ei, ang, cosne, sp, gmin=None):
    """(npix, npts, 11) coefficient block for emissivity `ename`
    (reference emis.f90:461-571).  gmin overrides sp.gmin."""
    ename = ename.upper()
    if gmin is None:
        gmin = sp.gmin
    if ename == "POLSYNCHTH":
        return polsynch.polsynchth(nu, ei.ncgs, ei.bcgs, ei.tcgs, ang)
    if ename == "SYMPOLTH":
        return polsynch.sympolemisth(nu, ei.ncgs, ei.bcgs, ei.tcgs, ang)
    if ename in ("SYNCHTHAV", "SYNCHTH"):
        return polsynch.synchemis(nu, ei.ncgs, ei.bcgs, ei.tcgs)
    if ename == "SYNCHTHAVNOABS":
        return polsynch.synchemisnoabs(nu, ei.ncgs, ei.bcgs, ei.tcgs)
    if ename == "POLSYNCHPL":
        return pl_mod.polsynchpl(nu, ei.ncgsnth, ei.bcgs, ang, sp.p1, gmin,
                                 sp.gmax)
    if ename == "SYNCHPL":
        return pl_mod.synchpl(nu, ei.ncgsnth, ei.bcgs, ang, sp.p1, gmin,
                              sp.gmax)
    if ename == "HYBRIDTHPL":
        return (polsynch.polsynchth(nu, ei.ncgs, ei.bcgs, ei.tcgs, ang)
                + pl_mod.polsynchpl(nu, ei.ncgsnth, ei.bcgs, ang, sp.p1,
                                    gmin, sp.gmax))
    raise NotImplementedError(f"emissivity {ename!r} is not ported")


def render_rays(geo, fv, ei, ename, freqs, mu0, alpha, beta, a, mbh, sp,
                iname="lsoda", nvals=4, standard=1, extra=0, debug=False):
    """Observed Stokes for one camera and a list of frequencies.

    geo: GeodesicBundle; fv: FluidVars; ei: EmisInputs (cgs); freqs:
    observed frequencies [Hz]; alpha, beta (npix,) tensors; mu0, a, mbh
    floats.  Returns (nfreq, npix, nvals)."""
    for name, value, ported in (("extra", extra, 0), ("debug", debug, False),
                                ("standard", standard, 1)):
        if value != ported:
            raise NotImplementedError(f"{name}={value!r} is not ported")
    if geo.x.shape[-2] == 1:
        raise NotImplementedError("single-point geodesics are not ported")
    r = geo.x[..., 1]
    th = geo.x[..., 2]
    # sanitize the fluid four-vectors before the tetrad projection
    okf = torch.isfinite(fv.u).all(-1) & torch.isfinite(fv.b).all(-1)
    like = dict(dtype=fv.u.dtype, device=fv.u.device)
    u_safe = torch.where(okf[..., None], fv.u,
                         torch.tensor([1.0, 0.0, 0.0, 0.0], **like))
    b_safe = torch.where(okf[..., None], fv.b,
                         torch.tensor([0.0, 0.0, 0.0, 1.0], **like))
    s2xi, c2xi, ang, g, cosne, frame_ok = tetrad.comoving_ortho(
        r, th, a, alpha[:, None], beta[:, None], mu0, u_safe, b_safe, geo.k)
    # fluid models produce NaN four-velocities where their flow is
    # unphysical; mask explicitly rather than rely on NaN propagation
    ok = (geo.valid & okf & frame_ok & torch.isfinite(g)
          & torch.isfinite(s2xi) & torch.isfinite(c2xi)
          & torch.isfinite(ang))
    s2xi = torch.where(ok, s2xi, 0.0)
    c2xi = torch.where(ok, c2xi, 1.0)
    ang = torch.where(ok, ang, math.pi / 2.0)
    cosne = torch.where(ok & torch.isfinite(cosne), cosne, 0.5)
    g = torch.where(ok, g, 1.0).clamp(1e-8, 1e8)
    lbh = pc.lbh(mbh)
    ei, gmin_eff = apply_source_params(ei, sp)

    out = []
    for fghz in freqs:
        nu = fghz / g
        e = calc_emissivity(ename, nu, ei, ang, cosne, sp, gmin=gmin_eff)
        if sp.coefindx is not None:
            # zero de-selected absorption/rotation coefficients
            # (emis.f90:557-558)
            e = e * torch.tensor((1.0,) * 4 + tuple(sp.coefindx),
                                 dtype=e.dtype, device=e.device)
        e = torch.where(ok[..., None], e, 0.0)
        e = torch.where(torch.isfinite(e), e, 0.0)
        j, K = framework.split_e(e)
        if nvals == 4:
            j, K = framework.rotate_emis(j, K, s2xi, c2xi)
        j, K = framework.invariant_emis(j, K, g)
        # cgs per unit geometric path (grtrans_driver.f90:217,228)
        Iobs = solvers.observed_stokes(geo.lam, j * lbh, K * lbh,
                                       method=iname, mask=ok)
        out.append(Iobs[..., :nvals])
    return torch.stack(out, dim=0)
