"""Where the time goes in one warm frame of the PyTorch port.

    python3 scripts/torch_profile.py
        [--config ffjet|sariaf|hotspot|thindisk|harm3d] [--nn 100 100 400]
        [--snapshot 288 128 128] [--out FILE]

Renders one configuration in float64 on one CUDA card: `ffjet`, the
FFJET/POLSYNCHPL flagship with the formal integrator (synthetic dump at
the real table size); `sariaf`, the Sgr A* RIAF (SARIAF + HYBRIDTHPL,
lsoda integrator, three frequencies); `hotspot`, one frame of the
Broderick & Loeb (2006) orbiting spot (HOTSPOT + POLSYNCHPL, formal); or
`thindisk`, the polarized thin disk (THINDISK + BBPOL, standard=2: one
point a ray, four frequencies, 1024x1024 pixels unless --nn says
otherwise); or `harm3d`, a GRMHD snapshot frame (HARM3D + POLSYNCHTH,
formal) on a seeded synthetic snapshot of --snapshot zones, for which the
fluid sampling is also split into its query geometry (`_query`, with the
fixed-count root finder of the theta map profiled alone as well) and the
table gather (one quad_gather_rows launch).  A warm-up frame, one whole frame, then its stages one by one
(geodesic trace, fluid sampling, render_rays, and, where rays are
integrated, the Stokes march of the last frequency inside render_rays on
its own), each under torch.profiler.  Prints one JSON object (also
written to --out): per stage the host wall time (inflated by the
profiler's per-op cost), the device busy time (sum of kernel durations on
the card), the idle share 1 - busy / wall, the number of kernel launches,
and the kernels with the most device time.  Needs a CUDA device; fails
without one.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from grtrans_tpu_torch import convert, driver  # noqa: E402
from grtrans_tpu_torch.config import GrtransConfig  # noqa: E402
from grtrans_tpu_torch.fluid.base import load_fluid_model  # noqa: E402
from grtrans_tpu_torch.fluid.ffjet import load_ffjet_file  # noqa: E402
from grtrans_tpu_torch.geodesics import camera, geokerr  # noqa: E402
from grtrans_tpu_torch.integrate import solvers  # noqa: E402
from grtrans_tpu_torch.orchestrator import (_source_params,  # noqa: E402
                                            grtrans_run)
from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump  # noqa: E402


def ffjet_setup(nn, dev):
    """(config, model) of the FFJET flagship."""
    with tempfile.TemporaryDirectory() as tmp:
        dfile = Path(tmp) / "ffjet.bin"
        write_ffjet_dump(dfile)
        model = convert.ffjet_from_arrays(*load_ffjet_file(dfile), dev)
    return GrtransConfig(
        fname="FFJET", ename="POLSYNCHPL", nvals=4, spin=0.998, standard=1,
        nn=nn, uout=0.01, mbh=3.4e9, mumin=0.906, mumax=0.906,
        fmin=3.45e11, fmax=3.45e11, gridvals=(-40.0, 20.0, -20.0, 40.0),
        iname="formal"), model


def sariaf_setup(nn, dev):
    """(config, model) of the Sgr A* RIAF with thermal + power-law
    synchrotron."""
    cfg = GrtransConfig(
        fname="SARIAF", ename="HYBRIDTHPL", nvals=4, spin=0.9, standard=1,
        nn=nn, mbh=4e6, mumin=0.5, mumax=0.5, nfreq=3, fmin=1e11, fmax=1e12,
        iname="lsoda", gridvals=(-15.0, 15.0, -15.0, 15.0),
        fargs=dict(n0=4e7, t0=1.6e11, beta=10.0))
    return cfg, load_fluid_model(cfg.fname, device=dev, **cfg.fargs)


def hotspot_setup(nn, dev):
    """(config, model) of the orbiting hotspot, one frame."""
    cfg = GrtransConfig(
        fname="HOTSPOT", ename="POLSYNCHPL", nvals=4, spin=0.9, standard=1,
        nn=nn, mbh=4e6, mumin=0.5, mumax=0.5, fmin=2.3e11, fmax=2.3e11,
        iname="formal", gridvals=(-12.0, 12.0, -12.0, 12.0),
        fargs=dict(rspot=1.5, r0spot=6.0, n0spot=4e7))
    return cfg, load_fluid_model(cfg.fname, device=dev, **cfg.fargs)


def thindisk_setup(nn, dev):
    """(config, model) of the polarized thin disk."""
    cfg = GrtransConfig(
        fname="THINDISK", ename="BBPOL", nvals=4, spin=0.9, standard=2,
        nn=nn, uout=0.01, mbh=10.0, mumin=0.26, mumax=0.26, nfreq=4,
        fmin=2.41e16, fmax=6.31e18, gridvals=(-21.0, 21.0, -21.0, 21.0),
        fargs=dict(mbh=10.0, mdot=0.1))
    return cfg, load_fluid_model(cfg.fname, device=dev, **cfg.fargs)


SNAPSHOT_NX = [288, 128, 128]


def harm3d_setup(nn, dev):
    """(config, model) of the GRMHD snapshot frame at Sgr A*."""
    from grtrans_tpu_torch.testing.grmhd_dump import A, harm3d_dump
    cfg = GrtransConfig(
        fname="HARM3D", ename="POLSYNCHTH", nvals=4, spin=A, standard=1,
        nn=nn, uout=0.04, mbh=4.3e6, mumin=0.5, mumax=0.5, fmin=2.3e11,
        fmax=2.3e11, iname="formal", mdotmin=4e13, mdotmax=4e13,
        gridvals=(-15.0, 15.0, -15.0, 15.0), gmin=10.0, muval=0.25)
    return cfg, load_fluid_model("HARM3D", device=dev,
                                 dump=harm3d_dump(*SNAPSHOT_NX))


SETUPS = {"harm3d": harm3d_setup, "ffjet": ffjet_setup, "sariaf": sariaf_setup,
          "hotspot": hotspot_setup, "thindisk": thindisk_setup}
DEFAULT_NN = {"thindisk": (1024, 1024, 1)}


def profiled(fn, top=8):
    """Run fn() under the profiler; returns (result, stats dict)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kern) / 1e3
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return out, {"wall_ms": wall, "device_busy_ms": busy,
                 "idle_share": 1.0 - busy / wall if wall else None,
                 "kernel_launches": len(kern),
                 "top_kernels_ms": [[n[:90], t] for n, t in tops]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(SETUPS), default="ffjet")
    ap.add_argument("--nn", type=int, nargs=3, default=None)
    ap.add_argument("--snapshot", type=int, nargs=3, default=SNAPSHOT_NX,
                    help="zones of the harm3d config's synthetic snapshot")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    SNAPSHOT_NX[:] = args.snapshot
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA device")
    dev = torch.device("cuda", 0)
    nro, nphi, npts = args.nn or DEFAULT_NN.get(args.config,
                                                (100, 100, 400))
    cfg, model = SETUPS[args.config]((nro, nphi, npts), dev)
    spin, mu0 = cfg.spin, cfg.mumin
    freqs = [float(f) for f in cfg.freqs()]
    grtrans_run(cfg, model, device=dev)                   # warm-up
    _, whole = profiled(lambda: grtrans_run(cfg, model, device=dev))

    cam = camera.make_camera(spin, mu0, *cfg.gridvals, nro, nphi,
                             device=dev)
    sp = _source_params(cfg, float(cfg.mdotmin))
    stages = {}
    ray = (spin, mu0, cam.alpha, cam.beta, cam.l, cam.q2, cam.sm, cam.u0)
    if cfg.standard == 2:
        geo, stages["trace_polar"] = profiled(lambda: geokerr.trace_polar(
            *ray, npts=1, phi0=cfg.phi0))
    else:
        geo, stages["trace"] = profiled(lambda: geokerr.trace(
            *ray, npts, phi0=cfg.phi0,
            uout=cfg.uout if cfg.uout > cam.u0 * 1.0001 else None))
    frame_time = dict(time=0.0) if getattr(model, "timedep", False) else {}
    fv, stages["fluid_vals"] = profiled(
        lambda: model.vals(geo.x, geo.k, spin, **frame_time))
    ei = model.convert(fv, sp)
    if args.config == "harm3d":
        # vals = query geometry (root finder inside) + gather + assemble
        q, stages["vals: _query"] = profiled(lambda: model._query(geo.x, spin))
        _, stages["vals: theta root finder (part of _query)"] = profiled(
            lambda: model.x123_of_blks(q["r"], q["th"], q["th"]))
        table, names = model._stacked_fields()
        ns = table.shape[0] // model.nt_slices
        cols, stages["vals: gather (quad_gather_rows)"] = profiled(
            lambda: model._gather_cols(table, ns, model.uniqx2.shape[0],
                                       model.uniqx3.shape[0], q, len(names)))
        _, stages["vals: _assemble"] = profiled(
            lambda: model._assemble(cols, names, q, spin))
        del q, cols

    # the Stokes march is profiled on its own, on the arguments that
    # render_rays hands it for the last frequency (profilers do not nest)
    captured = {}
    observed_stokes = solvers.observed_stokes

    def capture(*a, **k):
        captured["args"] = (a, k)
        return observed_stokes(*a, **k)

    solvers.observed_stokes = capture
    try:
        _, stages["render_rays"] = profiled(lambda: driver.render_rays(
            geo, fv, ei, cfg.ename, freqs, mu0, cam.alpha, cam.beta, spin,
            cfg.mbh, sp, iname=cfg.iname, nvals=cfg.nvals,
            standard=cfg.standard))
    finally:
        solvers.observed_stokes = observed_stokes
    if captured:                  # a single-point render integrates nothing
        a, k = captured["args"]
        _, stages["observed_stokes (one frequency, part of render_rays)"] \
            = profiled(lambda: observed_stokes(*a, **k))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    result = {"card": card, "config": args.config, "iname": cfg.iname,
              "nfreq": cfg.nfreq, "nn": [nro, nphi, npts], "frame": whole,
              "stages": stages}
    text = json.dumps(result, indent=1)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)


if __name__ == "__main__":
    main()
