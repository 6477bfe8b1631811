"""Time the gather kernels of two versions of csrc/quad_gather.cu against
each other on one NVIDIA card.

    git show REV:grtrans_tpu_torch/csrc/quad_gather.cu > base.cu
    python3 scripts/kernel_ab.py --base base.cu [--reps 20] [--json out.json]

Both sources are built with the port's nvcc flags and loaded side by side
(ops/_build.load); the base must have the current source's C interface
(ops/quad_gather.ARGTYPES), and a base whose extern "C" declarations differ
from it is refused before it is built.  Each forward kernel the port's render paths
run (tiled quad_gather at FFJET 4x9 f64 / f32, POLSYNCHPL 2x6, HARM 4x10,
KORAL 4x11; tiled quad_gather_rows at the snapshot's R = 4 of 2x10 in f64
and f32, on 4e6 random rows) is launched through both libraries' C
interfaces on the same operands, its outputs held equal, and
timed with CUDA events in the order base, new, new, base.  Prints a line a
shape, the card's name and power limit, and (with --json) writes the
times.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from grtrans_tpu_torch.ops import _build  # noqa: E402
from grtrans_tpu_torch.ops import quad_gather as qg  # noqa: E402

N = 4_000_000
SNAPSHOT_ROWS = 288 * 128 * 128
# name, table rows, R (None: quad_gather), nc, nf, dtype
SHAPES = (("ffjet f64", 16384, None, 4, 9, torch.float64),
          ("ffjet f32", 16384, None, 4, 9, torch.float32),
          ("polsynchpl f64", 201, None, 2, 6, torch.float64),
          ("harm 288x128 f64", 288 * 128, None, 4, 10, torch.float64),
          ("koral 288x128 f64", 288 * 128, None, 4, 11, torch.float64),
          ("snapshot R=4 f64", SNAPSHOT_ROWS, 4, 2, 10, torch.float64),
          ("snapshot R=4 f32", SNAPSHOT_ROWS, 4, 2, 10, torch.float32))


def ms_of(fn, reps):
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


def launcher(lib, table, idx, w, out, err, r, nc, nf):
    """fn() launching the tiled forward kernel of `lib` on the operands."""
    name = "quad_gather" if r is None else "quad_gather_rows"
    fn = getattr(lib, f"{name}_{qg.dtype_name(table)}")
    sizes = () if r is None else (r,)
    args = (table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            err.data_ptr(), idx.shape[0], table.shape[0], *sizes, nc, nf, 0)

    def run():
        _build.launch(fn, table.device, *args)
    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="the other version of csrc/quad_gather.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = {k: _build.load(src, qg.NVCC_FLAGS, qg.ARGTYPES)
            for k, src in (("base", args.base), ("new", qg.SOURCE))}
    dev = torch.device("cuda", 0)
    err = qg.error_flag(dev)
    rng = np.random.default_rng(0)
    res = {}
    for name, ns, r, nc, nf, dtype in SHAPES:
        shape = (N,) if r is None else (N, r)
        table = torch.as_tensor(rng.standard_normal((ns, nc * nf)),
                                dtype=dtype, device=dev)
        idx = torch.as_tensor(rng.integers(0, ns, shape), dtype=torch.int32,
                              device=dev)
        w = torch.as_tensor(rng.uniform(0.0, 1.0, shape + (nc,)),
                            dtype=dtype, device=dev)
        outs = {k: torch.empty((N, nf), dtype=dtype, device=dev)
                for k in libs}
        runs = {k: launcher(lib, table, idx, w, outs[k], err, r, nc, nf)
                for k, lib in libs.items()}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        if err.item() != 0 or not torch.equal(outs["base"], outs["new"]):
            diff = (outs["base"] - outs["new"]).abs().max().item()
            raise AssertionError(f"{name}: base and new differ ({diff})")
        times = {"base": [], "new": []}
        for k in ("base", "new", "new", "base"):
            times[k].append(ms_of(runs[k], args.reps))
        res[name] = times
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        print(f"{name}: N={N} R={r or 1} table=({ns}, {nc * nf}): base "
              + "/".join(f"{t:.4f}" for t in times["base"]) + " ms, new "
              + "/".join(f"{t:.4f}" for t in times["new"])
              + f" ms; new / base {mean['new'] / mean['base']:.4f}; outputs "
              "bitwise equal")
        del table, idx, w, outs, runs
        torch.cuda.empty_cache()
    print(f"card: {card}")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(card=card, ms=res), indent=1))


if __name__ == "__main__":
    main()
