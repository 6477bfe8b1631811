"""Whole-run orchestration on one device: cameras over (mu, time, mdot,
freq) (reference pgrtrans.f90 grtrans_main, :12-245).

ivals has shape (ncams, npix, nvals) with the camera index running
fastest over freq, then mdot, then time, then mu (pgrtrans.f90:198-211).
"""

import torch

from grtrans_tpu_torch import driver
from grtrans_tpu_torch.fluid.base import (CONST, TAIL, SourceParams,
                                          load_fluid_model)
from grtrans_tpu_torch.geodesics import camera as cam_mod
from grtrans_tpu_torch.geodesics import geokerr


def _source_params(cfg, mdot):
    return SourceParams(nfac=mdot, mbh=cfg.mbh, mdot=mdot, mu=cfg.muval,
                        gmin=cfg.gmin, gmax=cfg.gmax, p1=cfg.p1, p2=cfg.p2,
                        jetalpha=cfg.jetalpha,
                        stype=CONST if cfg.stype == "const" else TAIL,
                        sigcut=cfg.sigcut, otherargs=cfg.epotherargs,
                        coefindx=cfg.epcoefindx)


def grtrans_run(cfg, model=None, *, device):
    """Render every camera of `cfg` on `device`.

    model: a loaded fluid model (else loaded from cfg.fname/cfg.fargs).
    Returns (ivals, ab, freqs): ivals (ncams, npix, nvals) and ab
    (2, npix) tensors on `device`, freqs the numpy frequency grid."""
    if getattr(model, "timedep", False) or (
            cfg.nload > 1 and getattr(model, "nt_slices", 1) > 1):
        raise NotImplementedError("time-dependent fluids are not ported")
    if cfg.prec != "f64":
        raise NotImplementedError(f"prec={cfg.prec!r} is not ported")
    a = cfg.spin
    a1, a2, b1, b2 = cfg.gridvals
    nro, nphi, nup = cfg.nn
    freqs = cfg.freqs()
    mus = cfg.mus()
    if model is None:
        model = load_fluid_model(cfg.fname, device=device, **cfg.fargs)

    def camera(mu0):
        return cam_mod.make_camera(a, float(mu0), a1, a2, b1, b2, nro, nphi,
                                   cfg.nrotype, cfg.rcut, device=device)

    # every mu-camera shares the pixel grid and so the observer u0
    use_uout = cfg.uout > camera(mus[0]).u0 * 1.0001
    ivals, ab = [], None
    for mu0 in mus:
        cam = camera(mu0)
        if cfg.i1 > 0 or cfg.i2 > 0:
            # pixel subrange (1-based inclusive, read_inputs.f90:22-23)
            lo = cfg.i1 - 1 if cfg.i1 > 0 else 0
            hi = cfg.i2 if cfg.i2 > 0 else cam.alpha.shape[0]
            cam = cam._replace(alpha=cam.alpha[lo:hi], beta=cam.beta[lo:hi],
                               l=cam.l[lo:hi], q2=cam.q2[lo:hi],
                               sm=cam.sm[lo:hi])
        if ab is None:
            ab = torch.stack([cam.alpha, cam.beta], dim=0)
        geo = geokerr.trace(a, float(mu0), cam.alpha, cam.beta, cam.l,
                            cam.q2, cam.sm, cam.u0, nup,
                            uout=cfg.uout if use_uout else None,
                            phi0=cfg.phi0)
        fv = model.vals(geo.x, geo.k, a)
        for _ in range(cfg.nt):
            for mdot in cfg.mdots():
                sp = _source_params(cfg, float(mdot))
                ei = model.convert(fv, sp)
                ivals.append(driver.render_rays(
                    geo, fv, ei, cfg.ename, [float(f) for f in freqs],
                    float(mu0), cam.alpha, cam.beta, a, cfg.mbh, sp,
                    iname=cfg.iname, nvals=cfg.nvals, standard=cfg.standard,
                    extra=cfg.extra))
    return torch.cat(ivals, dim=0), ab, freqs
