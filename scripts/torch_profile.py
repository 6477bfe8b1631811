"""Where the time goes in one warm flagship frame of the PyTorch port.

    python3 scripts/torch_profile.py [--nn 100 100 400] [--out FILE]

Renders the FFJET/POLSYNCHPL flagship (float64, synthetic dump at the
real table size) on one CUDA card: a warm-up frame, one whole frame, then
its stages one by one (geodesic trace, fluid sampling, render_rays, and
the Stokes march inside render_rays on its own), each under
torch.profiler.  Prints one JSON object (also written to --out): per stage
the host wall time (inflated by the profiler's per-op cost), the device
busy time (sum of kernel durations on the card), the idle share
1 - busy / wall, the number of kernel launches, and the kernels with the
most device time.  Needs a CUDA device; fails without one.
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
from grtrans_tpu_torch.fluid.ffjet import load_ffjet_file  # noqa: E402
from grtrans_tpu_torch.geodesics import camera, geokerr  # noqa: E402
from grtrans_tpu_torch.integrate import solvers  # noqa: E402
from grtrans_tpu_torch.orchestrator import (_source_params,  # noqa: E402
                                            grtrans_run)
from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump  # noqa: E402

A, MU0 = 0.998, 0.906


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
    ap.add_argument("--nn", type=int, nargs=3, default=(100, 100, 400))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA device")
    dev = torch.device("cuda", 0)
    nro, nphi, npts = args.nn
    with tempfile.TemporaryDirectory() as tmp:
        dfile = Path(tmp) / "ffjet.bin"
        write_ffjet_dump(dfile)
        model = convert.ffjet_from_arrays(*load_ffjet_file(dfile), dev)
    cfg = GrtransConfig(
        fname="FFJET", ename="POLSYNCHPL", nvals=4, spin=A, standard=1,
        nn=(nro, nphi, npts), uout=0.01, mbh=3.4e9, mumin=MU0, mumax=MU0,
        fmin=3.45e11, fmax=3.45e11, gridvals=(-40.0, 20.0, -20.0, 40.0),
        iname="formal")
    grtrans_run(cfg, model, device=dev)                   # warm-up
    _, whole = profiled(lambda: grtrans_run(cfg, model, device=dev))

    cam = camera.make_camera(A, MU0, *cfg.gridvals, nro, nphi, device=dev)
    sp = _source_params(cfg, float(cfg.mdotmin))
    stages = {}
    geo, stages["trace"] = profiled(lambda: geokerr.trace(
        A, MU0, cam.alpha, cam.beta, cam.l, cam.q2, cam.sm, cam.u0, npts,
        uout=0.01, phi0=cfg.phi0))
    fv, stages["ffjet_vals"] = profiled(lambda: model.vals(geo.x, geo.k, A))
    ei = model.convert(fv, sp)

    # the Stokes march is profiled on its own, on the arguments that
    # render_rays hands it (profilers do not nest)
    captured = {}
    observed_stokes = solvers.observed_stokes

    def capture(*a, **k):
        captured["args"] = (a, k)
        return observed_stokes(*a, **k)

    solvers.observed_stokes = capture
    try:
        _, stages["render_rays"] = profiled(lambda: driver.render_rays(
            geo, fv, ei, cfg.ename, [cfg.fmin], MU0, cam.alpha, cam.beta, A,
            cfg.mbh, sp, iname="formal"))
    finally:
        solvers.observed_stokes = observed_stokes
    a, k = captured["args"]
    _, stages["observed_stokes (part of render_rays)"] = profiled(
        lambda: observed_stokes(*a, **k))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    result = {"card": card,
              "nn": [nro, nphi, npts], "frame": whole, "stages": stages}
    text = json.dumps(result, indent=1)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)


if __name__ == "__main__":
    main()
