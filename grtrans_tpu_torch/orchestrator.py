"""Whole-run orchestration: cameras over (mu, time, mdot, freq) (reference
pgrtrans.f90 grtrans_main, :12-245), on one device or, with mesh=, each
process of a device mesh rendering its block of every camera's pixels.

ivals has shape (ncams, npix, nvals) with the camera index running
fastest over freq, then mdot, then time, then mu (pgrtrans.f90:198-211).
"""

import time

import torch
import torch.distributed as dist

from grtrans_tpu_torch import driver
from grtrans_tpu_torch.fluid.base import (CONST, TAIL, SourceParams,
                                          load_fluid_model)
from grtrans_tpu_torch.geodesics import cache as geo_cache
from grtrans_tpu_torch.geodesics import camera as cam_mod
from grtrans_tpu_torch.geodesics import geokerr
from grtrans_tpu_torch.geodesics.geokerr import GeodesicBundle
from grtrans_tpu_torch.parallel import sharding


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
                gdfile=None, verbose=False, device_output=False, mesh=None,
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
    them on `device` unsynchronised, so it changes only the container.

    mesh: a 1-D DeviceMesh (parallel/sharding.py pixel_mesh), with
    `device` this process's device of it; call on every process of the
    mesh with the same arguments.  Each process renders the block of every
    camera's pixels (after the i1/i2 cut) that NamedSharding(P("pix"))
    gives it in grtrans_tpu, so the mesh size must divide the pixel count;
    the model is replicated.  Slow light measures the delays from their
    least value over the whole camera (an all-reduce).  The results are
    those of the run without a mesh, whole on every process: the blocks
    are gathered once at the end.  gdfile under a mesh reads and writes the
    file of the run without one: every process reads a bundle that matches
    and keeps its block; else each traces its block, the first process of
    the mesh gathers and saves the bundle, and the others wait for it.  A
    mesh excludes chunk (a mesh shards the pixels; chunk bounds one
    device's memory)."""
    if unported:
        raise NotImplementedError(
            f"grtrans_run options not ported: {sorted(unported)}")
    if cfg.prec != "f64":
        raise NotImplementedError(f"prec={cfg.prec!r} is not ported")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be a positive pixel count, got {chunk}")
    if mesh is not None:
        # every check that can refuse the call comes before the first
        # collective, so that no process is left waiting in one
        if chunk is not None:
            raise ValueError("mesh= and chunk= are mutually exclusive: a "
                             "mesh shards the pixel axis; chunking bounds "
                             "one device's memory")
        sharding.check_device(mesh, device)
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

    def pixels(cam, s):
        return cam._replace(alpha=cam.alpha[s], beta=cam.beta[s],
                            l=cam.l[s], q2=cam.q2[s], sm=cam.sm[s])

    # every mu-camera shares the pixel grid and so the observer u0
    probe = camera(mus[0])
    uout = camera_uout(cfg, probe)
    # the pixel subrange (1-based inclusive, read_inputs.f90:22-23), and
    # this process's block of it under a mesh
    cut = slice(max(cfg.i1 - 1, 0), cfg.i2 if cfg.i2 > 0 else None)
    mine = slice(None)
    if mesh is not None:
        mine = slice(*sharding.pixel_block(mesh, probe.alpha[cut].shape[0]))
    ivals, ab = [], None
    for mu0 in mus:
        cam = pixels(camera(mu0), cut)
        if ab is None:
            ab = torch.stack([cam.alpha, cam.beta], dim=0)
        cam = pixels(cam, mine)
        npix = cam.alpha.shape[0]
        step = npix if chunk is None else min(chunk, npix)
        t0sh = None
        if slow_light and uout is not None:
            # one minimum over the whole camera, not over a pixel block;
            # without uout the trace starts at the camera and t is global
            t0sh = geokerr.camera_delay(a, float(mu0), cam.alpha, cam.beta,
                                        cam.l, cam.q2, cam.sm, cam.u0,
                                        uout)
            tmin = t0sh.min()
            if mesh is not None:
                tmin = sharding.all_reduce(mesh, tmin, dist.ReduceOp.MIN)
            t0sh = t0sh - tmin

        bundle = None
        if gdfile is not None:
            # a chunked camera keeps its bundle on the host
            home = device if step == npix else "cpu"
            key = geo_cache.bundle_key(
                a, float(mu0), nup, uout, cfg.phi0,
                cfg.standard, cfg.gridvals, nro, nphi, cfg.nrotype, cfg.rcut,
                i1=cfg.i1, i2=cfg.i2)
            path = gdfile if len(mus) == 1 else f"{gdfile}.mu{float(mu0):.6f}"
            if mesh is None:
                bundle = geo_cache.load_bundle(path, key, device=home)
                if bundle is None or bundle.x.shape[0] != npix:
                    parts = [trace_camera(cfg, cam, mu0,
                                          slice(lo, lo + step))
                             for lo in range(0, npix, step)]
                    bundle = GeodesicBundle(*(
                        torch.cat([getattr(g, f).to(home) for g in parts])
                        for f in GeodesicBundle._fields))
                    geo_cache.save_bundle(path, bundle, key)
            else:
                bundle = _mesh_bundle(cfg, cam, mu0, mesh, mine, path, key,
                                      device)
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
    if mesh is not None:
        whole = sharding.gather_pixels(mesh, torch.cat(ivals, dim=0), dim=1)
        ivals = list(whole.split([iv.shape[0] for iv in ivals]))
    if not device_output:
        ivals = torch.cat(ivals, dim=0)
    if verbose:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        print(f"grtrans_run: {time.perf_counter() - t_start:.2f} s")
    return ivals, ab, freqs


def _mesh_bundle(cfg, cam, mu0, mesh, mine, path, key, device):
    """This process's block `mine` of the camera's bundle at `path` (the
    file of the run without a mesh) under the mesh; `cam` holds the block.
    Every process reads the file; unless every one found a bundle that
    matches, each traces its block, the first process of the mesh gathers
    the blocks and saves the bundle, and the others wait at a barrier."""
    group = mesh.get_group(0)
    found = geo_cache.load_bundle(path, key, device="cpu")
    npix = cam.alpha.shape[0] * mesh.size()
    hit = torch.tensor([int(found is not None and found.x.shape[0] == npix)],
                       device=device)
    if sharding.all_reduce(mesh, hit, dist.ReduceOp.MIN).item():
        return GeodesicBundle(*(v[mine].to(device) for v in found))
    bundle = trace_camera(cfg, cam, mu0)
    root = dist.get_global_rank(group, 0)
    first = mesh.get_local_rank() == 0
    whole = []
    for v in bundle:
        parts = [torch.empty_like(v) for _ in range(mesh.size())]
        dist.gather(v.contiguous(), parts if first else None, dst=root,
                    group=group)
        whole.append(torch.cat(parts) if first else None)
    if first:
        geo_cache.save_bundle(path, GeodesicBundle(*whole), key)
    dist.barrier(group=group)
    return bundle
