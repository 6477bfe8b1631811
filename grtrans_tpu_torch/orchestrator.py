"""Whole-run orchestration on one device: cameras over (mu, time, mdot,
freq) (reference pgrtrans.f90 grtrans_main, :12-245).

ivals has shape (ncams, npix, nvals) with the camera index running
fastest over freq, then mdot, then time, then mu (pgrtrans.f90:198-211).
"""

import time

import torch

from grtrans_tpu_torch import driver
from grtrans_tpu_torch.fluid.base import (CONST, TAIL, SourceParams,
                                          load_fluid_model)
from grtrans_tpu_torch.geodesics import cache as geo_cache
from grtrans_tpu_torch.geodesics import camera as cam_mod
from grtrans_tpu_torch.geodesics import geokerr
from grtrans_tpu_torch.geodesics.geokerr import GeodesicBundle


def _source_params(cfg, mdot):
    return SourceParams(nfac=mdot, mbh=cfg.mbh, mdot=mdot, mu=cfg.muval,
                        gmin=cfg.gmin, gmax=cfg.gmax, p1=cfg.p1, p2=cfg.p2,
                        jetalpha=cfg.jetalpha,
                        stype=CONST if cfg.stype == "const" else TAIL,
                        sigcut=cfg.sigcut, otherargs=cfg.epotherargs,
                        coefindx=cfg.epcoefindx)


def camera_uout(cfg, cam):
    """Where a camera's rays are traced from: cfg.uout when it lies inside
    the camera's own u0 (by more than 1e-4 of it), else None, the camera."""
    return cfg.uout if cfg.uout > cam.u0 * 1.0001 else None


def trace_camera(cfg, cam, mu0, blk=slice(None)):
    """The geodesics of the pixels `blk` of `cam`: for standard=2 to each
    ray's first crossing of the equatorial plane, else cfg.nn[2] points
    from camera_uout."""
    ray = (cfg.spin, float(mu0), cam.alpha[blk], cam.beta[blk], cam.l[blk],
           cam.q2[blk], cam.sm[blk], cam.u0)
    if cfg.standard == 2:
        return geokerr.trace_polar(*ray, npts=1, phi0=cfg.phi0)
    return geokerr.trace(*ray, cfg.nn[2], phi0=cfg.phi0,
                         uout=camera_uout(cfg, cam))


def grtrans_run(cfg, model=None, *, device, chunk=None, reuse_geo=False,
                gdfile=None, verbose=False, device_output=False,
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
    before each frame is sampled at time = it * cfg.dt.  standard=2 traces
    each ray to its first crossing of the equatorial plane and renders that
    one point.

    gdfile: a path for the mu-camera's traced geodesics (the reference's
    precomputed-geodesic file, geodesics.f90:155-187), with ".mu%.6f" of
    mu0 appended when nmu > 1.  A bundle whose content key matches (camera,
    trace parameters, i1/i2, whether the trace starts at uout) is loaded
    in place of the trace; else the camera is traced (block by block with
    `chunk`, assembled on the host) and the bundle saved.  The bundle holds
    the trace as traced: the slow-light shift is applied after a load as
    after a trace.  verbose: print the run's wall time.

    Returns (ivals, ab, freqs): ivals (ncams, npix, nvals [+ 19 for
    extra=1]) and ab (2, npix) tensors on `device`, freqs the numpy
    frequency grid.  device_output=True returns ivals as the list of each
    (mu, time, mdot) render's (nfreq, npix, nvals) tensor instead, in
    camera order, without the concatenation: grtrans_tpu's option, which
    there keeps the images off the host; here the default already leaves
    them on `device` unsynchronised, so it changes only the container."""
    if unported:
        raise NotImplementedError(
            f"grtrans_run options not ported: {sorted(unported)}")
    if cfg.prec != "f64":
        raise NotImplementedError(f"prec={cfg.prec!r} is not ported")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be a positive pixel count, got {chunk}")
    t_start = time.perf_counter()
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
    uout = camera_uout(cfg, camera(mus[0]))
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
        if slow_light and uout is not None:
            # one minimum over the whole camera, not over a pixel block;
            # without uout the trace starts at the camera and t is global
            t0sh = geokerr.camera_delay(a, float(mu0), cam.alpha, cam.beta,
                                        cam.l, cam.q2, cam.sm, cam.u0,
                                        uout)
            t0sh = t0sh - t0sh.min()

        bundle = None
        if gdfile is not None:
            # a chunked camera keeps its bundle on the host
            home = device if step == npix else "cpu"
            key = geo_cache.bundle_key(
                a, float(mu0), nup, uout, cfg.phi0,
                cfg.standard, cfg.gridvals, nro, nphi, cfg.nrotype, cfg.rcut,
                i1=cfg.i1, i2=cfg.i2)
            path = gdfile if len(mus) == 1 else f"{gdfile}.mu{float(mu0):.6f}"
            bundle = geo_cache.load_bundle(path, key, device=home)
            if bundle is None or bundle.x.shape[0] != npix:
                parts = [trace_camera(cfg, cam, mu0, slice(lo, lo + step))
                         for lo in range(0, npix, step)]
                bundle = GeodesicBundle(*(
                    torch.cat([getattr(g, f).to(home) for g in parts])
                    for f in GeodesicBundle._fields))
                geo_cache.save_bundle(path, bundle, key)
        # scan[i]: the pixel blocks of the i-th (time, mdot) render
        scan = [[] for _ in range(cfg.nt * cfg.nmdot)]
        for lo in range(0, npix, step):
            blk = slice(lo, lo + step)
            alpha, beta = cam.alpha[blk], cam.beta[blk]
            if bundle is None:
                geo = trace_camera(cfg, cam, mu0, blk)
            else:
                geo = GeodesicBundle(*(v[blk].to(device) for v in bundle))
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
    if not device_output:
        ivals = torch.cat(ivals, dim=0)
    if verbose:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        print(f"grtrans_run: {time.perf_counter() - t_start:.2f} s")
    return ivals, ab, freqs
