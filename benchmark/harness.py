"""One run of one cell: set-up, the measured (or traced) window, the check
of the window's images against the plain reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up makes the cell's data from the seed, builds the program's fluid
model and renders one warm-up call of the cell's shape.  The window then
calls grtrans_tpu_torch.orchestrator.grtrans_run back to back, one camera
a call (traffic: cells.calls), each image brought to the host, until
--seconds have passed; it ends when the last image is on the host.  A
traced run (--trace 1) runs the traffic's `trace_calls` calls under the
profiler instead and reads the per-layer metrics from the trace.  Once
the window has closed and the program's model is freed, the reference
renders a sample of the window's pixels again (checks/<cell>.json) and
the widest gap decides `correct`."""

import argparse
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import cells, tracing
from benchmark.reference import render as ref_render

FORBIDDEN = ("jax", "jaxlib", "flax", "grtrans_tpu")
# the program's own path in the precision below a configuration's: the
# control of the comparison (limits.py)
LOWER_PREC = {"f64": "mixed"}


def forbidden_modules():
    """Loaded modules of JAX or of the JAX package, by whole top-level
    name."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test: grtrans_tpu_torch, one camera a call."""

    def __init__(self, cell, data, device, prec):
        from grtrans_tpu_torch.config import GrtransConfig
        from grtrans_tpu_torch.orchestrator import grtrans_run
        self.cell, self.device, self.prec = cell, device, prec
        self.GrtransConfig, self.grtrans_run = GrtransConfig, grtrans_run
        self.model = cell.data_gen.program_model(data, device)

    def config(self, mu0, mdots):
        g = {k: tuple(v) if isinstance(v, list) else v
             for k, v in self.cell.grtrans().items()}
        return self.GrtransConfig(**g, mumin=mu0, mumax=mu0, nmu=1,
                                  nmdot=len(mdots), mdotmin=mdots[0],
                                  mdotmax=mdots[-1], prec=self.prec)

    def __call__(self, mu0, mdots):
        """The images (nmdot * nfreq, npix, nvals) of one call, on the
        host."""
        with torch.profiler.record_function(tracing.CALL):
            ivals, _, _ = self.grtrans_run(self.config(mu0, mdots),
                                           self.model, device=self.device)
        with torch.profiler.record_function(tracing.TO_HOST):
            return ivals.cpu()


def window(program, plan, seconds):
    """Calls from `plan` back to back until `seconds` have passed; returns
    ([(mu0, mdots, images)], seconds from the first call to the last image
    on the host)."""
    done = []
    t0 = time.perf_counter()
    for mu0, mdots in plan:
        done.append((mu0, mdots, program(mu0, mdots)))
        if time.perf_counter() - t0 >= seconds:
            break
    return done, time.perf_counter() - t0


def check(cell, data, done, seed, device):
    """The widest gap between the window's images and the reference's, on
    a sample drawn from the seed: `calls` of the window's calls and
    `pixels` pixels of each, every render (mdot, frequency) of a call,
    as a share of the reference's largest |I| there; and the count of
    values that are not finite in all the window's images.  Returns
    (numbers {name: (value, limit)}, renders failed)."""
    spec = cell.check
    limit = spec["limits"]["image_err"]
    rng = np.random.default_rng([seed, 1])
    cfg = cell.grtrans()
    npix = done[0][2].shape[1]
    bad = [(~torch.isfinite(iv)).flatten(1).sum(1) for _, _, iv in done]
    nonfinite = sum(int(b.sum()) for b in bad)
    failed = {(i, k) for i, b in enumerate(bad)
              for k in range(b.shape[0]) if b[k]}
    picks = sorted(rng.choice(len(done), min(spec["calls"], len(done)),
                              replace=False))
    model = cell.data_gen.reference_model(data, device)
    worst = 0.0
    for i in picks:
        mu0, mdots, iv = done[i]
        pix = np.sort(rng.choice(npix, min(spec["pixels"], npix),
                                 replace=False))
        ref = ref_render.render_pixels(cfg, model, mu0, mdots, pix, device)
        ref = ref.reshape(-1, len(pix), ref.shape[-1]).cpu()
        got = iv[:, torch.as_tensor(pix)]
        for k in range(ref.shape[0]):
            scale = ref[k, :, 0].abs().max().item()
            gap = (got[k] - ref[k]).abs().max().item()
            err = gap / scale if scale > 0.0 else math.inf
            if not math.isfinite(err):
                err = math.inf
            worst = max(worst, err)
            if err > limit:
                failed.add((i, k))
    del model
    return {"image_err": (worst, limit),
            "nonfinite_values": (nonfinite, 0)}, len(failed)


def card_name_and_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err}"


def run(cell, seed, seconds, trace, device, t_start, log=None):
    """One run of `cell`; returns the result dict (without printing)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cuda = torch.device(device).type == "cuda"
    data = cell.data_gen.make(cell.config["data"], seed, device)
    program = Program(cell, data, device, cell.config["prec"])
    program(*cells.warm_call(cell.traffic))
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    plan = cells.calls(cell.traffic, seed)
    # the window's host work is the launches of one thread: one intra-op
    # thread keeps the run from competing for the shared host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        n = cell.traffic["trace_calls"]
        done, tr = tracing.traced(
            lambda: [(mu0, mdots, program(mu0, mdots))
                     for mu0, mdots in (next(plan) for _ in range(n))],
            program.model)
        wall = tr.window_s()
    else:
        done, wall = window(program, plan, seconds)
    sync(device)
    torch.set_num_threads(threads)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    frames = sum(iv.shape[0] for _, _, iv in done)
    npix = done[0][2].shape[1]
    log(f"window {wall:.3f} s: {len(done)} calls, {frames} renders of "
        f"{npix} pixels")
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded after the window: {bad}")
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        tr.frames, tr.calls = frames, len(done)
        metrics = {}
        for m in cell.per_layer():
            value = cells.reader(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s())
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        log(f"trace: {len(tr.ops)} device ops, {tr.unlaunched} without a "
            f"launch on record")
        del tr
    else:
        values = {"mrays_per_s": frames * npix / wall / 1e6,
                  "peak_mem_gib": peak / 2.0 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    if cuda:
        log(f"card: {card_name_and_limit()}")

    # the program's state goes before the reference runs
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, failed = check(cell, data, done, seed, device)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    result = {"correct": all(v <= lim for v, lim in numbers.values()),
              "attempted": frames, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        log(f"check {k} {v!r} limit {lim!r}")
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    cell = cells.Cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, args.trace,
                 torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the process that reports: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
