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


def grtrans_run(cfg, model=None, *, device, chunk=None, reuse_geo=False,
                **unported):
    """Render every camera of `cfg` on `device`.

    model: a loaded fluid model (else loaded from cfg.fname/cfg.fargs).
    chunk: render each camera in pixel blocks of at most this many pixels
    (the last block is simply shorter), which bounds device memory for
    cameras too large to trace in one piece; rays are independent, so the
    image is the unchunked one up to the roundoff of batched elementwise
    kernels.  reuse_geo is accepted for callers of
    grtrans_tpu.orchestrator.grtrans_run: the geodesics and the sampled
    fluid of a mu-camera (or of one of its pixel blocks) are always traced
    once and reused by every (time, mdot) render of it, whatever its
    value; a time-dependent model (model.timedep) is sampled anew for
    each frame, at time = it * cfg.dt.  Slow light (cfg.nload > 1 on a
    model that holds a time series, model.nt_slices > 1; reference
    pgrtrans.f90:177-191) samples every point at its own retarded time:
    the delay from the camera to each ray's first point, less its least
    value over the whole camera, is taken off the ray's time coordinate
    before each frame is sampled at time = it * cfg.dt.  standard=2 traces each ray to its
    first crossing of the equatorial plane and renders that one point.
    Returns (ivals, ab, freqs): ivals (ncams, npix, nvals [+ 19 for
    extra=1]) and ab (2, npix) tensors on `device`, freqs the numpy
    frequency grid."""
    if unported:
        raise NotImplementedError(
            f"grtrans_run options not ported: {sorted(unported)}")
    if cfg.prec != "f64":
        raise NotImplementedError(f"prec={cfg.prec!r} is not ported")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be a positive pixel count, got {chunk}")
    a = cfg.spin
    a1, a2, b1, b2 = cfg.gridvals
    nro, nphi, nup = cfg.nn
    freqs = cfg.freqs()
    freq_list = [float(f) for f in freqs]
    mus = cfg.mus()
    if model is None:
        model = load_fluid_model(cfg.fname, device=device, **cfg.fargs)
    timedep = getattr(model, "timedep", False)
    slow_light = cfg.nload > 1 and getattr(model, "nt_slices", 1) > 1

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
        npix = cam.alpha.shape[0]
        step = npix if chunk is None else min(chunk, npix)
        t0sh = None
        if slow_light and use_uout:
            # one minimum over the whole camera, not over a pixel block;
            # without uout the trace starts at the camera and t is global
            t0sh = geokerr.camera_delay(a, float(mu0), cam.alpha, cam.beta,
                                        cam.l, cam.q2, cam.sm, cam.u0,
                                        cfg.uout)
            t0sh = t0sh - t0sh.min()
        # scan[i]: the pixel blocks of the i-th (time, mdot) render
        scan = [[] for _ in range(cfg.nt * cfg.nmdot)]
        for lo in range(0, npix, step):
            blk = slice(lo, lo + step)
            alpha, beta = cam.alpha[blk], cam.beta[blk]
            ray = (a, float(mu0), alpha, beta, cam.l[blk], cam.q2[blk],
                   cam.sm[blk], cam.u0)
            if cfg.standard == 2:
                geo = geokerr.trace_polar(*ray, npts=1, phi0=cfg.phi0)
            else:
                geo = geokerr.trace(*ray, nup, phi0=cfg.phi0,
                                    uout=cfg.uout if use_uout else None)
            if t0sh is not None:
                t = geo.x[..., 0] - t0sh[blk, None]
                geo = geo._replace(x=torch.cat([t[..., None],
                                                geo.x[..., 1:]], dim=-1))
            if not (timedep or slow_light):
                fv = model.vals(geo.x, geo.k, a)
            renders = iter(scan)
            for it in range(cfg.nt):
                if timedep or slow_light:
                    fv = model.vals(geo.x, geo.k, a, time=it * cfg.dt)
                for mdot in cfg.mdots():
                    sp = _source_params(cfg, float(mdot))
                    ei = model.convert(fv, sp)
                    next(renders).append(driver.render_rays(
                        geo, fv, ei, cfg.ename, freq_list, float(mu0), alpha,
                        beta, a, cfg.mbh, sp, iname=cfg.iname,
                        nvals=cfg.nvals, standard=cfg.standard,
                        extra=cfg.extra))
        ivals.extend(torch.cat(parts, dim=1) for parts in scan)
    return torch.cat(ivals, dim=0), ab, freqs
