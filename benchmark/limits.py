"""The readings a cell's correctness limit is set from, in one process:

    python3 benchmark/limits.py --workload <cell> --seeds <n> [<n> ...]
        [--calls 2]

For each seed: the cell's data, then the program as the configuration
states it and the control (the program in the precision below, its own
prec="mixed" path), each through `--calls` calls of the cell's traffic
at the cell's size; both are checked against the plain reference on the
same sample (harness.check).  Prints one JSON line a seed and program:
{"seed", "prec", "control", "image_err", "nonfinite_values"}.  Needs a
CUDA card; the benchmark's own runs do not run it."""

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import cells, harness  # noqa: E402


def readings(cell, seed, calls, device):
    """[(prec, control, numbers)] of one seed: the program as configured,
    then the control."""
    data = cell.data_gen.make(cell.config["data"], seed, device)
    out = []
    stated = cell.config["prec"]
    for prec, control in ((stated, False),
                          (harness.LOWER_PREC[stated], True)):
        program = harness.Program(cell, data, device, prec)
        plan = cells.calls(cell.traffic, seed)
        done = [(mu0, mdots, program(mu0, mdots))
                for mu0, mdots in (next(plan) for _ in range(calls))]
        del program
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        numbers, _ = harness.check(cell, data, done, seed, device)
        out.append((prec, control, numbers))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("limits.py: needs a CUDA device")
    cell = cells.Cell(args.workload)
    device = torch.device("cuda", 0)
    print(f"card: {harness.card_name_and_limit()}", file=sys.stderr)
    for seed in args.seeds:
        for prec, control, numbers in readings(cell, seed, args.calls,
                                               device):
            print(json.dumps({"seed": seed, "prec": prec, "control": control,
                              **{k: v for k, (v, _) in numbers.items()}}),
                  flush=True)


if __name__ == "__main__":
    main()
