"""GPU smoke run of the PyTorch port (grtrans_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, each of which raises on failure (non-zero exit, no result line):
  1. require CUDA; print the card's name and power limit; TF32 off;
  2. build the hand-written kernel csrc/quad_gather.cu for sm_90a;
  3. hold the kernel against its plain PyTorch version on the card at the
     main path's shapes (FFJET 4e6 queries x (16384, 36) table in f64 and
     f32; the POLSYNCHPL cutoff table (201, 12)), check the out-of-range
     flag, and time both with CUDA events;
  4. render the FFJET flagship (POLSYNCHPL, 100x100 pixels x 400 points,
     float64) on a synthetic dump at the real table size through
     grtrans_run(device="cuda"), with the launch count of every kernel
     reset just before and read just after; check the image and time two
     warm renders and their stages;
  5. check the card's render against the port's CPU render (the path the
     CPU tests hold against grtrans_tpu) at 16x16 x 64.
The line before the last is a JSON object of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
NN = (100, 100, 400)                  # flagship camera: pixels x points
N_QUERIES = NN[0] * NN[1] * NN[2]     # table samples per frame
FFJET_NX = 128                        # table (128^2, 4 x 9)
REPS = 20
KERNEL_TOL = {torch.float64: 1e-14, torch.float32: 1e-6}
CPU_GPU_RTOL = 1e-8                   # whole-image rel L1, card vs CPU


def flagship_config(GrtransConfig, dfile, nn):
    return GrtransConfig(
        fname="FFJET", ename="POLSYNCHPL", nvals=4, spin=0.998, standard=1,
        nn=nn, uout=0.01, mbh=3.4e9, mumin=0.906, mumax=0.906, nfreq=1,
        fmin=3.45e11, fmax=3.45e11, gridvals=(-40.0, 20.0, -20.0, 40.0),
        iname="formal", fargs=dict(dfile=str(dfile), ntscl=2.0, nrscl=70.0))


def cuda_ms(fn, reps=REPS):
    """Mean device time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(qg, name, ns, nc, nf, dtype, dev):
    """Kernel vs plain on the card; returns (max_abs_err, ms, plain_ms)."""
    rng = np.random.default_rng(SEED)
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, N_QUERIES), dtype=torch.int32,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, (N_QUERIES, nc)), dtype=dtype,
                        device=dev)
    out = qg.quad_gather(table, idx, w, nc, nf)
    ref = qg.quad_gather_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not err <= KERNEL_TOL[dtype] * scale:
        raise AssertionError(f"{name}: max|kernel - plain| {err} > "
                             f"{KERNEL_TOL[dtype]} * {scale}")
    if qg.error_flag(dev).item() != 0:
        raise AssertionError(f"{name}: out-of-range flag set")
    # plain, kernel, kernel, plain
    p1 = cuda_ms(lambda: qg.quad_gather_ref(table, idx, w, nc, nf))
    k1 = cuda_ms(lambda: qg.quad_gather(table, idx, w, nc, nf))
    k2 = cuda_ms(lambda: qg.quad_gather(table, idx, w, nc, nf))
    p2 = cuda_ms(lambda: qg.quad_gather_ref(table, idx, w, nc, nf))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"{name}: N={N_QUERIES} table=({ns}, {nc * nf}) {dtype}: "
          f"max_abs_err {err:.3e} (max|ref| {scale:.3e}); kernel "
          f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    return err, ms, plain_ms


def check_error_flag(qg, dev):
    table = torch.zeros((16, 4), dtype=torch.float64, device=dev)
    idx = torch.tensor([0, 16, 3], dtype=torch.int32, device=dev)
    w = torch.ones((3, 2), dtype=torch.float64, device=dev)
    out = qg.quad_gather(table, idx, w, 2, 2)
    flag = qg.error_flag(dev)
    torch.cuda.synchronize()
    if flag.item() != 1 or not torch.isnan(out[1]).all() \
            or not (out[[0, 2]] == 0).all():
        raise AssertionError("out-of-range index not flagged")
    flag.zero_()
    print("out-of-range index: flag set, row NaN, others untouched")


def image_stats(ivals):
    iv = ivals[0].double()
    I, Q, U = iv[:, 0], iv[:, 1], iv[:, 2]
    lit = I > 0
    lp = (Q[lit] ** 2 + U[lit] ** 2).sqrt() / I[lit]
    return I.max().item(), I.sum().item(), lp.max().item()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    run(torch.device("cuda", 0))


def run(dev):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from grtrans_tpu_torch import convert, driver
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid.ffjet import load_ffjet_file
    from grtrans_tpu_torch.geodesics import camera, geokerr
    from grtrans_tpu_torch.ops import quad_gather as qg
    from grtrans_tpu_torch.orchestrator import _source_params, grtrans_run
    from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    so = qg.build()
    qg.load_library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain at the main path's shapes
    err64, ms64, plain64 = check_kernel(qg, "ffjet f64", FFJET_NX ** 2, 4, 9,
                                        torch.float64, dev)
    check_kernel(qg, "ffjet f32", FFJET_NX ** 2, 4, 9, torch.float32, dev)
    check_kernel(qg, "polsynchpl f64", 201, 2, 6, torch.float64, dev)
    check_error_flag(qg, dev)

    with tempfile.TemporaryDirectory() as tmp:
        dfile = Path(tmp) / "ffjet.bin"
        write_ffjet_dump(dfile, nx=FFJET_NX, seed=SEED)
        grids, fields = load_ffjet_file(dfile)
        cfg = flagship_config(GrtransConfig, dfile, NN)
        npix = NN[0] * NN[1]
        model = convert.ffjet_from_arrays(grids, fields, dev)

        # 4. the main path, counted
        qg.quad_gather.launches = 0
        t0 = time.perf_counter()
        ivals, _, _ = grtrans_run(cfg, model, device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = qg.quad_gather.launches
        if launches == 0:
            raise AssertionError("main path never launched quad_gather")
        if qg.error_flag(dev).item() != 0:
            raise AssertionError("main path: out-of-range table index")
        if tuple(ivals.shape) != (1, npix, 4) or \
                not torch.isfinite(ivals).all():
            raise AssertionError(f"bad image {tuple(ivals.shape)}")
        imax, flux, lpmax = image_stats(ivals)
        if not (imax > 0 and 0.0 <= lpmax <= 1.0):
            raise AssertionError(f"I max {imax}, LP max {lpmax}")
        print(f"render {NN[0]}x{NN[1]}x{NN[2]} f64: first "
              f"{first_s * 1e3:.1f} ms, quad_gather launches {launches}; "
              f"I max {imax:.9e}, "
              f"total flux {flux:.9e}, LP max {lpmax:.6f}")

        torch.cuda.reset_peak_memory_stats(dev)
        warm, rerun = [], 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            again, _, _ = grtrans_run(cfg, model, device=dev)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            rerun = max(rerun, (again - ivals).abs().max().item())
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"warm render: {warm[0] * 1e3:.1f} ms, {warm[1] * 1e3:.1f} ms"
              f" per frame ({npix / min(warm) / 1e6:.6f} Mrays/s); peak "
              f"memory {peak / 2 ** 30:.3f} GiB; max|rerun - first| "
              f"{rerun:.3e}")

        # stage times of one frame (host clock, synchronized per stage)
        cam = camera.make_camera(0.998, 0.906, *cfg.gridvals, NN[0], NN[1],
                                 device=dev)
        sp = _source_params(cfg, float(cfg.mdotmin))
        stages = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = (time.perf_counter() - t0) * 1e3
            return out

        geo = stage("trace", lambda: geokerr.trace(
            0.998, 0.906, cam.alpha, cam.beta, cam.l, cam.q2, cam.sm,
            cam.u0, NN[2], uout=0.01, phi0=cfg.phi0))
        fv = stage("ffjet_vals", lambda: model.vals(geo.x, geo.k, 0.998))
        ei = stage("convert", lambda: model.convert(fv, sp))
        stage("render_rays", lambda: driver.render_rays(
            geo, fv, ei, cfg.ename, [cfg.fmin], 0.906, cam.alpha, cam.beta,
            0.998, cfg.mbh, sp, iname="formal"))
        print("stages (ms): " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in stages.items()))

        # 5. the card against the port's CPU path on a small camera
        small = flagship_config(GrtransConfig, dfile, (16, 16, 64))
        gpu, _, _ = grtrans_run(small, model, device=dev)
        cpu, _, _ = grtrans_run(small, convert.ffjet_from_arrays(
            grids, fields, "cpu"), device="cpu")
        rel = ((gpu.cpu() - cpu).abs().sum() / cpu.abs().sum()).item()
        print(f"16x16x64: card vs CPU rel L1 {rel:.3e} "
              f"(bar {CPU_GPU_RTOL})")
        if not rel <= CPU_GPU_RTOL:
            raise AssertionError(f"card vs CPU rel L1 {rel}")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "quad_gather", "route": "cuda",
        "source": "grtrans_tpu_torch/csrc/quad_gather.cu",
        "replaces": "grtrans_tpu/ops/pallas_gather.py:49",
        "launches": launches, "max_abs_err": err64, "ms": ms64,
        "plain_ms": plain64}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
