"""Command line of the port, as the reference's `./grtrans` works: read
`files.in` (&files ifile, ofile), parse the six input namelists of
ifile, render, and write the cameras to ofile (grtrans_program.f90,
grtrans.f90:34-46):

    python -m grtrans_tpu_torch [files.in] [--device cuda|cpu]
                                [--prec f64|mixed]
    python -m grtrans_tpu_torch --inputs inputs.in --output grtrans.out

FITS when ofile ends in .fits, else the reference's raw binary layout
(camera.f90:322-341).  The render runs on the card unless --device cpu
asks for the CPU; without a card the default raises.  --prec mixed renders
grtrans_tpu's mixed precision (GrtransConfig.prec, which the namelists do
not carry; orchestrator.grtrans_run).  With debug=1 and
i1 = i2 the chosen pixel's intermediates are also written to
ofile + ".geodebug.npz" (tools.geodebug).
"""

import argparse
import dataclasses
import sys

import numpy as np
import torch

from grtrans_tpu_torch.io import namelist as nml
from grtrans_tpu_torch.io.binio import write_camera_bin
from grtrans_tpu_torch.io.fitsio import write_fits
from grtrans_tpu_torch.orchestrator import grtrans_run
from grtrans_tpu_torch.tools import geodebug


def main(argv=None):
    ap = argparse.ArgumentParser(prog="grtrans_tpu_torch")
    ap.add_argument("files_in", nargs="?", default="files.in",
                    help="&files namelist pointing at ifile/ofile")
    ap.add_argument("--inputs", help="inputs namelist (overrides files.in)")
    ap.add_argument("--output", help="output path (overrides files.in)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    ap.add_argument("--prec", choices=("f64", "mixed"),
                    help="precision of the render (default: f64)")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass "
                           "--device cpu to render on the CPU")
    if args.inputs:
        ifile, ofile = args.inputs, args.output or "grtrans.out"
    else:
        ifile, ofile = nml.read_files_in(args.files_in)
        if args.output:
            ofile = args.output
    cfg = nml.read_inputs(ifile)
    if args.prec:
        cfg = dataclasses.replace(cfg, prec=args.prec)
    ivals, ab, freqs = grtrans_run(cfg, device=args.device, verbose=True)

    if cfg.debug and cfg.i1 > 0 and cfg.i1 == cfg.i2:
        gpath = str(ofile) + ".geodebug.npz"
        geodebug.dump_ray(cfg, cfg.i1, gpath, device=args.device)
        print(f"grtrans_tpu_torch: wrote geodebug dump to {gpath}")

    ivals = ivals.cpu().numpy()
    ab = ab.cpu().numpy().T
    ncams = ivals.shape[0]
    nx, ny = cfg.nn[0], cfg.nn[1]
    if cfg.i1 > 0 or cfg.i2 > 0:
        nx, ny = ivals.shape[1], 1
    if str(ofile).endswith(".fits"):
        write_fits(ofile, ab, list(ivals), cfg.camera_key_dicts()[:ncams])
    else:
        keyvals = [np.array([freqs[i % len(freqs)]], np.float32)
                   for i in range(ncams)]
        write_camera_bin(ofile, ab, list(ivals), keyvals, nx, ny)
    print(f"grtrans_tpu_torch: wrote {ncams} camera(s) to {ofile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
