"""GPU smoke run of the PyTorch port (grtrans_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, each of which raises on failure (non-zero exit, no result line):
  1. require CUDA; print the card's name and power limit; TF32 off;
  2. build the hand-written kernels of csrc/formal_march.cu,
     csrc/quad_gather.cu, csrc/harmpi_invert.cu and
     csrc/render_polsynchth.cu for sm_90a (ptxas's registers and spills);
  3. hold quad_gather against its plain PyTorch version on the card at the
     main paths' shapes (FFJET 4e6 queries x (16384, 36) table in f64 and
     f32; the POLSYNCHPL cutoff table (201, 12); PHATDISK's pair-packed
     table (500, 2 x 101) at the 1024^2 queries of its frame, which the
     wrapper sends to the wide-row kernel; the 2-D tables of the tiled
     kernel's other shapes at 4e6 queries: HARM 4 x 10 on a 32 x 24 and a
     288 x 128 grid, KORAL 4 x 11, SPHACC 2 x 2, NUMDISK 4 x 1 and the
     per-sample-p POLSYNCHPL table 4 x 6) on uniformly random rows: the
     kernel the wrapper picks and, at the tiled shapes, the generic kernel
     (weights off 16 bytes) against the plain version, check the
     out-of-range flag, and time with CUDA events: the kernel the wrapper
     picks, the plain version and embedding_bag (the one-call PyTorch
     yardstick), beside the bound computed from the bytes the call must
     move;
  4. render the FFJET flagship (POLSYNCHPL, 100x100 pixels x 400 points,
     float64) on a synthetic dump at the real table size through
     grtrans_run(device="cuda"), with the launch count of every kernel
     reset just before and read just after; check the image and time a
     warm render and its stages; time the kernel once more on the
     index stream of that frame (neighbouring points of a ray share rows);
  5. check the card's render against the port's CPU render (the path the
     CPU tests hold against grtrans_tpu) at 16x16 x 64;
  6. render the Sgr A* RIAF (SARIAF + HYBRIDTHPL, thermal plus power-law
     synchrotron, lsoda integrator, 100x100 x 400 x 3 frequencies)
     through Grtrans(...).run() on the card, launches counted the same
     way; check shape, finiteness, brightness and polarization fraction;
     time a warm run and read its peak memory;
  7. the same configuration at 16x16 x 64 for each of the formal, lsoda,
     delo and quadrature integrators, card against the port's CPU run:
     the whole image from uout = 0.0025, Stokes I from the default uout;
  8. the light curve of an orbiting hotspot (HOTSPOT + POLSYNCHPL, the
     Broderick & Loeb 2006 spot around Sgr A*, 100x100 x 400 x 6 frames)
     through Grtrans(...).run(), launches counted: finite, modulated by
     the orbit, two quad_gather launches a frame, a rerun identical;
  9. thin-disk imaging (standard=2: one point a ray, at the equatorial
     crossing) at 1024x1024 pixels through Grtrans(...).run(): the
     polarized Novikov-Thorne disk (THINDISK + BBPOL, 4 frequencies; I >= 0
     and the polarization under Chandrasekhar's 11.8%), then the
     inhomogeneous disk (PHATDISK + INTERP at its default table sizes),
     which samples its table with quad_gather, launches counted;
 10. the card against the port's CPU run: the hotspot at 16x16 x 64 x 2
     frames, both disks at 32x32 x 1, and a SARIAF + POLSYNCHTH + formal
     render with extra=1 at 16x16 x 64 (Stokes and each of the 19 extra
     channels).
 11. quad_gather_rows, the multi-row gather of the GRMHD snapshot samplers: the
     kernel the wrapper picks (tiled, a warp's lanes sharing a row's copy)
     against the plain version at a 288x128x128 snapshot's table (4,718,592
     rows of 2 x 10) with 4e6 queries of R = 4 rows in f64 and f32, of R = 8
     rows on three slices, of R = 1 (HARMPI's 1 x 10), on a stream whose
     queries all name one row, each also on the simple kernel (the table
     off 16 bytes); the simple kernel where the wrapper sends it:
     KORAL3D's bins (R = 8 and R = 4 of 1 x 6, ragged last tile; also timed
     from CUDA graphs, without the host's launch cost) and rows the bulk copy
     cannot take (2 x 11 in f32); the wide-row kernel at ragged widths; the
     out-of-range flag of the wide, tiled and simple kernels (the last on a
     table off 16 bytes); timed in the order plain, embedding_bag, kernel, and
     back (embedding_bag on the table viewed as (2 NS, nf) is the library
     yardstick);
 12. a HARM3D snapshot frame (POLSYNCHTH, formal, 100x100 x 400, float64)
     on a seeded synthetic 288x128x128 snapshot through
     Grtrans(...).run(model=...): finite, I >= 0, total flux in Jy at Sgr
     A*, one quad_gather_rows launch a frame counted, warm time, stage
     walls, peak memory, rerun identical; the kernel timed once more on
     that frame's own index stream;
 13. slow light on the same camera: a three-slice series (nload = 3), equal
     to fast light on identical slices and brighter than the oldest slice
     on a brightening series; on a 26 M wide camera its flux lies between
     the fast-light fluxes of the oldest and the newest slice by more than
     1%; the kernel timed once more on the slow-light frame's own index
     stream (R = 8); camera_delay on the 30 M camera, whose corner rays
     turn within 1.4 uout of the trace's start: every ray within a few
     hundred M of the others, the card's delays equal to the CPU's;
 14. the card against the port's CPU run at 16x16 x 64 for HARM3D, IHARM,
     THICKDISK, KORAL3D with SYNCHBIN, HARM and HARMPI;
 15. a HARM 2-D snapshot frame at full width (288x128 synthetic dump, the
     HARM3D frame's camera and physics, 100x100 x 400, f64) through
     Grtrans(...).run(model=...), launches of the tiled quad_gather kernel
     counted; the kernel timed once more on that frame's index stream;
 16. the FFJET flagship run from files: its namelists and files.in
     written, `python -m grtrans_tpu_torch files.in` in a process of its
     own to FITS, then __main__.main() in this process to the reference
     binary, launches counted; both files read back equal to float32 of
     an in-process render;
 17. the flagship with gdfile=: a run that traces and saves the bundle,
     one that loads it, launches counted; the images bitwise equal and
     equal to a plain run; walls of save_bundle, load_bundle and the
     trace, and the bundle's size;
 18. geodebug: the flagship's brightest pixel dumped on the card and
     re-integrated there from the dump, equal to the image's pixel;
 19. pgriter: a secant fit of mdot to the flux of a render at 6e13 g/s,
     from 4e13, on the HARM3D snapshot of phase 12, loaded once; one
     quad_gather_rows launch a render;
 20. the multi-GPU paths on this one card: (a) the flagship through
     grtrans_run(mesh=pixel_mesh()) on a world of one over NCCL, equal to
     phase 4's image, launches counted, a warm frame timed beside phase
     4's; (b) the snapshot of phase 12 cut into 4 theta slabs of 32 rows,
     each with the row after it, sampled by grmhd3d.slab_sample: the
     summed columns equal to the whole table's gather, a full frame
     through the slabs equal to phase 12's image with one quad_gather_rows
     launch a slab counted, each slab's kernel timed on the frame's queries
     beside the whole table's and its bound; (c) sample_sharded on the
     world of one equal to vals; (d) dry-run part (c), the gradient of a
     SARIAF render's total flux with respect to (n0, t0) through the
     pixel-sharded render (the block's backward pass and one all_reduce),
     equal to the gradient without a mesh (rtol 1e-10);
 21. the backward kernels of the gathers with respect to their weights:
     (a) quad_gather_bwd_w (4e6 random rows of FFJET's (16384, 4 x 9) in
     f64 and f32 and of the POLSYNCHPL cutoff table (201, 2 x 6)) and
     quad_gather_rows_bwd_w (the snapshot's (4,718,592, 2 x 10), R = 4),
     the kernel the wrapper picks (tiled) and the first design (generic /
     simple, reached with g off 16 bytes), each against its plain twin
     (KERNEL_TOL of max|twin|) and the two against each other, the
     out-of-range flag of both, a table
     that requires a gradient refused, CUDA-event times of the picked
     kernel beside the twin, the backward of embedding_bag with respect to
     its per_sample_weights and the byte bound; (b) after phase 27, the
     same on the gradient paths' own index streams, every backward launch
     of one chunk of phases 22, 23 and 27 kept;
 22. path (a), the flagship forward and backward pass of grtrans_tpu's
     scripts/fwdbwd_bench.py: FFJET + POLSYNCHPL at 100x100 x 400 f64
     through tools.invert.InverseProblem (rays from uout = 0.01, as the
     flagship frame), d(sum|image| / (npix 4))/d(spin, mu0) with per-stage
     recompute, pixel chunks sized to the card's free
     memory (the count printed), launches counted a chunk (quad_gather
     forward and recompute, quad_gather_bwd_w), every backward launch on
     the kernel its picker chose (launch counts by kernel against the first
     chunk's operands, kept in a second pass), no plain twin called, warm
     time and peak memory; the gradient against central differences on
     the card (1e-2) and, at 16x16 x 64, against the port's CPU gradient
     (1e-8);
 23. path (b), a geometry-only gradient, d/d(mu0), on the HARM3D frame of
     phase 12 through quad_gather_rows and quad_gather_rows_bwd_w (one
     launch a chunk, on the picked kernel), checked the same way (the CPU
     comparison on a 32x24x16 snapshot);
 24. path (c), tools.emitter_observer.run on the card: (4.1, 2.3)
     recovered within 0.05, within 1e-6 of the same search on the CPU;
 25. the FFJET flagship of phase 4 at prec="mixed" (float32 trace with the
     inversions at every 4th point, fluid, coefficients and march; float64
     landmarks, sums, affine parameter and image), launches counted: float32
     quad_gather alone (FFJet's float32 table, the POLSYNCHPL cutoff table),
     no float64 gather, no twin; the image float64 and within 2e-3 of
     max|I| of phase 4's; warm mixed and float64 frames in turns (f64,
     mixed, mixed, f64) with the peak memory of each; the float32 kernel
     timed on the mixed frame's own index stream;
 26. the HARM3D frame of phase 12 at prec="mixed": one quad_gather_rows
     launch of the float32 kernel on the float32 stack a frame, no float64
     gather, no twin; the image within 2e-3 of phase 12's; warm frames of
     both in turns; the float32 kernel timed on the frame's index stream;
 27. the card against the port's CPU at prec="mixed" (FFJET flagship
     camera, SARIAF + POLSYNCHTH, HARM3D on a 32x24x16 snapshot; 16x16 x
     64; 2e-3 of max|I|); InverseProblem(prec="mixed") on the flagship
     camera at 16x16 x 64, d(loss)/d(spin, mu0) at (0.998, 0.906) finite
     and within 1e-2 of the float64 gradient, launches counted (float32
     quad_gather and quad_gather_bwd_w alone, the backward on the picked
     kernel, no twin); the mu0 gradients of THICKDISK, MB09, KORAL and
     KORAL3D (tests/test_torch_gradient_zoo.py's set-up) on the card,
     finite, within 1e-2 of central differences there and within 1e-3 of
     the CPU's;
 28. the Stokes march kernel (csrc/formal_march.cu) on the benchmark's
     frame: the FFJET flagship camera at 256x256 x 400, lsoda, float64 and
     prec="mixed", through grtrans_run, each render's march operands kept:
     one kernel launch a render (f64 / f32) and no twin call; the frame
     again with the torch march in the kernel's place, the two images
     compared (MARCH_TOL: f64 1e-9 of max|I|, the benchmark's limit;
     f32 4e-5, float32 rounding's with room) and the device
     memory's peak read before, inside and after each march; then the
     kernel and the torch march timed with CUDA events on the kept
     operands, their difference, and the kernel's bound: the bytes its
     unmasked cells touch over the memory rate against its float64 (f32)
     operations, estimated from the source, over the unfused rate;
 29. HARMPI's inversion kernels (csrc/harmpi_invert.cu) on the benchmark's
     frame: the samples of a 256x256 x 400 HARMPI BL = 3 camera at the
     benchmark cell's spin, uout and field of view (two kernel launches,
     no twin call), inverted on the benchmark's jetcoords grid by the
     kernels and by their torch twins, in float64 and in float32
     (prec="mixed"); x1 and x2 compared (INVERT_TOL), their zones on the
     benchmark's 288 x 128 grid compared (none may differ); then kernels
     and twins timed with CUDA events, beside the kernels' bound: their
     bytes over the memory rate against their operations over the unfused
     rate, the operations estimated from the source (INVERT_OPS) for the
     steps, band and branches that a replay of the frame's bisections
     counts;
 30. the POLSYNCHTH render kernel (csrc/render_polsynchth.cu) on the
     benchmark's HARM3D frame: the camera of the cell harm3d-incl-256-f64
     at 256x256 x 400, lsoda, mu0 0.6, on phase 12's snapshot, float64 and
     prec="mixed", through grtrans_run: one kernel launch a render (f64 /
     f32) and no twin call; then render_rays on the kept operands by the
     kernel and by its torch twin, launches and twin calls counted around
     each, the (j, K, ok) each hands the march compared column by column
     (RENDER_TOL of the column's max|twin|, the masks equal) and the
     images (RENDER_IMAGE_TOL); the kernel, render_rays less the march and
     the twin timed with CUDA events, beside the kernel's bound: its bytes
     over the memory rate against its operations over the unfused rate,
     the operations counted from the source by branch (RENDER_OPS) and
     weighted by the samples a replay of the frame finds on each.
The line before the last is a JSON object of the kernels, the float32
instantiations of the mixed paths among them (and of the gradient and
mixed paths; no NaN token: a non-finite number is null); the last line is
{"ok": true, "device": {...}}.
"""

import collections
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import roofline
from grtrans_tpu_torch import obs

SEED = 0
NN = (100, 100, 400)                  # flagship camera: pixels x points
N_QUERIES = NN[0] * NN[1] * NN[2]     # table samples per frame
FFJET_NX = 128                        # table (128^2, 4 x 9)
REPS = 20
KERNEL_TOL = {torch.float64: 1e-14, torch.float32: 1e-6}
CPU_GPU_RTOL = 1e-8                   # whole-image rel L1, card vs CPU
# each extra=1 channel's rel L1 over the image, card vs CPU (measured at most
# 1.2e-10 on an NVIDIA H100 80GB HBM3, 700.00 W): ratios of
# weighted sums, and a photosphere index that may move by one sample
EXTRA_RTOL = 1e-8
DISK_NN = (1024, 1024, 1)             # thin-disk camera: one point a ray
HOTSPOT_FRAMES = 6
SNAPSHOT_NX = (288, 128, 128)         # the EHT library's iharm3d resolution
HARM2D_NX = SNAPSHOT_NX[:2]           # its r-theta grid, for the 2-D models
SNAPSHOT_MDOT = 4e13                  # g/s: ~1 Jy at 230 GHz from Sgr A*
SGRA_DISTANCE_CM = 8.178e3 * 3.0857e18
ROWS_TOL = {torch.float64: 1e-14, torch.float32: 2e-6}
MESH_SLABS = 4                        # virtual theta slabs of phase 20


def riaf_kwargs(nn, iname):
    """The Sgr A* RIAF: SARIAF with thermal + power-law synchrotron."""
    return dict(fname="SARIAF", ename="HYBRIDTHPL", nvals=4, spin=0.9,
                standard=1, nn=nn, mbh=4e6, mumin=0.5, mumax=0.5, nfreq=3,
                fmin=1e11, fmax=1e12, iname=iname,
                gridvals=(-15.0, 15.0, -15.0, 15.0),
                fargs=dict(n0=4e7, t0=1.6e11, beta=10.0))


def hotspot_kwargs(nn, nt):
    """Broderick & Loeb (2006) spot on a 6 M orbit around Sgr A*."""
    return dict(fname="HOTSPOT", ename="POLSYNCHPL", nvals=4, spin=0.9,
                standard=1, nn=nn, mbh=4e6, mumin=0.5, mumax=0.5, nfreq=1,
                fmin=2.3e11, fmax=2.3e11, iname="formal", nt=nt, dt=16.0,
                gridvals=(-12.0, 12.0, -12.0, 12.0),
                fargs=dict(rspot=1.5, r0spot=6.0, n0spot=4e7))


def disk_kwargs(nn, **model):
    """The thin-disk camera: a 10 Msun hole seen 75 degrees from the
    axis."""
    return dict(spin=0.9, standard=2, nn=nn, uout=0.01, mbh=10.0,
                mumin=0.26, mumax=0.26,
                gridvals=(-21.0, 21.0, -21.0, 21.0), **model)


THINDISK = dict(fname="THINDISK", ename="BBPOL", nvals=4, nfreq=4,
                fmin=2.41e16, fmax=6.31e18, fargs=dict(mbh=10.0, mdot=0.1))
# the model's default table: 500 radii x 100 frequencies
PHATDISK = dict(fname="PHATDISK", ename="INTERP", nvals=1, nfreq=3,
                fmin=1e17, fmax=1e18,
                fargs=dict(a=0.9, mbh=10.0, mdot=0.1, nw=80, fmin=3e16,
                           fmax=3e18))


def snapshot_kwargs(fname, nn, **change):
    """The Sgr A* snapshot camera of tests/test_slowlight.py."""
    kw = dict(fname=fname, ename="POLSYNCHTH", nvals=4, spin=0.9375,
              standard=1, nn=nn, uout=0.04, mbh=4.3e6, mumin=0.5, mumax=0.5,
              nfreq=1, fmin=2.3e11, fmax=2.3e11, iname="formal",
              mdotmin=SNAPSHOT_MDOT, mdotmax=SNAPSHOT_MDOT,
              gridvals=(-15.0, 15.0, -15.0, 15.0), gmin=10.0, muval=0.25)
    kw.update(change)
    return kw


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


def graph_ms(fn, reps=REPS):
    """Device time of fn() per call: reps calls captured in one CUDA graph
    and replayed, so that the host's cost of a launch, which sets the pace
    of a loop of small launches, is left out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


# the card's published memory rate and peaks outside the tensor cores
HBM_BYTES_PER_S = roofline.HBM_BYTES_PER_S
PEAK_FLOPS = roofline.PEAK_FLOPS


def gather_bound_ms(n, ns, nc, nf, dtype):
    """Least time the card could take for one quad_gather: each input
    byte read once and each output byte written once over the memory
    rate, against 2 nc nf operations a query over the peak rate."""
    size = torch.finfo(dtype).bits // 8
    nbytes = n * 4 + n * nc * size + n * nf * size + ns * nc * nf * size
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * n * nc * nf / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# the plain twins, whose calls a path on the card must not make
TWINS = ("quad_gather_ref", "quad_gather_rows_ref", "quad_gather_bwd_w_ref",
         "quad_gather_rows_bwd_w_ref")


# the wrappers, whose launches are counted, each by dtype too
WRAPPERS = ("quad_gather", "quad_gather_rows", "quad_gather_bwd_w",
            "quad_gather_rows_bwd_w")


MARCH_NN = (256, 256, 400)            # the benchmark's frames
# operations of one substep on the march kernel's common path
# (non-degenerate matricant, Taylor emission), an estimate from its source,
# not a count: ~500 adds and multiplies besides exp x 3, expm1, sincos,
# sqrt x 3 and 3 divides, each taken as the ~25 instructions of its
# software sequence
MARCH_OPS_PER_SUBSTEP = 750
# kernel against twin, of max|I|: (on the same operands, the frame's
# image); f64: 1e-12 and the benchmark's image_err limit; f32: the bar of
# tests/test_torch_march_kernel.py, about ten times the largest reading
# (3.7e-6 on this frame), both sides doing the same float32 arithmetic
MARCH_TOL = {"f64": (1e-12, 1e-9), "f32": (4e-5, 4e-5)}


def march_bound_ms(lam, cell_ok, substeps, mixed):
    """Least time of one march kernel launch: the bytes of the samples its
    unmasked cells touch (lam, j, K), the mask, the float64 steps of the
    mixed leg and the output over the memory rate, against the estimated
    MARCH_OPS_PER_SUBSTEP a substep of an unmasked cell over the rate of
    unfused operations in the march's dtype: half PEAK_FLOPS, which counts
    a fused multiply-add as two, while the kernel is built with
    -fmad=false.  Returns (ms, "bytes" or "operations", bytes,
    operations)."""
    size = lam.element_size()
    touched = torch.zeros_like(lam, dtype=torch.bool)
    touched[:, :-1] |= cell_ok
    touched[:, 1:] |= cell_ok
    cells = cell_ok.sum().item()
    nbytes = (touched.sum().item() * 12 * size + cell_ok.numel()
              + (8 * cells if mixed else 0) + lam.shape[0] * 4 * size)
    ops = cells * substeps * MARCH_OPS_PER_SUBSTEP
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (PEAK_FLOPS[lam.dtype] / 2) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def march_row(name):
    return "ffjet {}x{}x{} lsoda {}".format(*MARCH_NN, name)


def march_phase(dev):
    """Phase 28: the march kernel on the benchmark's flagship frame."""
    from grtrans_tpu_torch import convert
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid import ffjet
    from grtrans_tpu_torch.integrate import solvers
    from grtrans_tpu_torch.ops import formal_march as fm
    from grtrans_tpu_torch.orchestrator import grtrans_run
    from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump

    kernel_march = solvers._kernel_march

    def frame(cfg, model, march):
        """One render with `march` in the kernel's place; its image, the
        obs counters it moved, the march operands and the peaks (GiB): of
        the frame before the march, inside the march, after it."""
        kept, peaks = [], {}

        def spy(*args):
            kept.append(args)
            torch.cuda.synchronize()
            peaks["before"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = march(*args)
            torch.cuda.synchronize()
            peaks["march"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            return out

        solvers._kernel_march = spy
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            before = obs.counters()
            ivals, _, _ = grtrans_run(cfg, model, device=dev)
            torch.cuda.synchronize()
            counts = obs.counters()
            counts.subtract(before)
            peaks["after"] = torch.cuda.max_memory_allocated(dev)
        finally:
            solvers._kernel_march = kernel_march
        return (ivals, counts, kept[0],
                {k: v / 2 ** 30 for k, v in peaks.items()})

    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        dfile = Path(tmp) / "ffjet.bin"
        write_ffjet_dump(dfile, nx=FFJET_NX, seed=SEED)
        model = convert.ffjet_from_arrays(*ffjet.load_ffjet_file(dfile),
                                          dev)
        base = flagship_config(GrtransConfig, dfile, MARCH_NN)
        for prec in ("f64", "mixed"):
            cfg = dataclasses.replace(base, iname="lsoda", prec=prec)
            grtrans_run(cfg, model, device=dev)          # warm
            ivals, counts, args, peaks = frame(cfg, model, kernel_march)
            name = "f32" if prec == "mixed" else "f64"
            if counts[f"march.kernel.launches.{name}"] != 1 or \
                    counts["march.kernel.launches"] != 1 or \
                    counts["march.twin.calls"] != 0:
                raise AssertionError(f"march {prec}: kernel launches "
                                     f"{counts['march.kernel.launches']}, "
                                     f"twin calls "
                                     f"{counts['march.twin.calls']}")
            twin_img, tcounts, _, twin_peaks = frame(
                cfg, model, lambda *a: solvers._twin_march(*a))
            if tcounts["march.twin.calls"] != 1:
                raise AssertionError("the twin frame took no twin")
            imax = twin_img[..., 0].abs().max().item()
            img_err = (ivals - twin_img).abs().max().item() / imax
            lam, j, K, cell_ok, I0, substeps, dlam64 = args

            def kernel():
                return fm.formal_march(lam, j, K, cell_ok, None, substeps,
                                       dlam64)

            def twin():
                return solvers._twin_march(*args)

            out, ref = kernel(), twin()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item() / ref[:, 0].abs().max().item()
            bound, bound_by, nbytes, ops = march_bound_ms(
                lam, cell_ok, substeps, prec == "mixed")
            t = dict(kernel=cuda_ms(kernel, reps=5), plain=cuda_ms(twin, 1),
                     kernel_again=cuda_ms(kernel, reps=5))
            ms = min(t["kernel"], t["kernel_again"])
            rows[march_row(name)] = dict(
                ms=ms, plain_ms=t["plain"], bound_ms=bound,
                bound_by=bound_by, bytes=nbytes, ops=ops,
                share=bound / ms, max_rel_err=err, image_rel_err=img_err,
                cells=cell_ok.sum().item(), peaks_gib=peaks,
                twin_peaks_gib=twin_peaks, times=t)
            print(f"march {name} {MARCH_NN}: kernel {ms:.3f} ms "
                  f"({t['kernel']:.3f}, {t['kernel_again']:.3f}), torch "
                  f"march {t['plain']:.1f} ms, bound {bound:.3f} ms by "
                  f"{bound_by} ({nbytes / 1e9:.3f} GB, {ops:.3e} ops "
                  f"estimated), "
                  f"share {bound / ms:.1%}; kernel vs twin {err:.3e} of "
                  f"max|I|, image {img_err:.3e}; peaks GiB kernel {peaks}, "
                  f"twin {twin_peaks}")
            tol = MARCH_TOL[name]
            if not (img_err <= tol[1] and err <= tol[0]):
                raise AssertionError(f"march {name}: kernel vs twin {err}, "
                                     f"image {img_err}")
    return rows


INVERT_NN = (256, 256, 400)           # the benchmark's HARMPI frame
# FP operations of the inversion kernels, counted from
# csrc/harmpi_invert.cu's source, with a transcendental function taken as
# the ~25 instructions of its software sequence and a division as ~10 (its
# reciprocal and Newton steps): estimates, not counts.  The number of each
# event (steps before the exit, steps above xbr, on the ftr band, with a
# quotient in thetaofx2) is counted by invert_work on the frame's samples.
TRANS, DIV = 25, 10
INVERT_OPS = dict(
    x1_step=TRANS + 7,          # mid, exp, + R0, the tests
    x1_above=2 * TRANS + 3,     # the power above xbr
    x2_step=2 * TRANS + 19,     # mid, fac's argument, tan, one atan, tests
    x2_outer=DIV,               # |mid| > 0.5: the side's quotient
    x2_band=4 * TRANS + 19,     # ftr's cos and two sin, the other side,
                                # the blend
    x2_band_outer=DIV,          # the other side's quotient
    # once a sample: two ror0nu, each two mins (three sin), a quotient and
    # the grid's powers (nu1 = -2 a reciprocal, nu2 = 0.75 a power)
    sample=2 * (8 * TRANS + 44 + 2 * DIV))
# r, th read and x1, x2 written, with r read by both kernels
INVERT_OPERANDS_PER_SAMPLE = 5
# x1, x2: kernels against twins, tests/test_torch_harmpi_invert.py's bars
INVERT_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


def invert_work(th, r, p, iters=60):
    """Replay the inversion kernels' bisections (csrc/harmpi_invert.cu) in
    torch on the samples, and count the events INVERT_OPS prices: each
    sample's steps up to its exit (mid equal to lo or hi), x1's above xbr,
    x2's on the ftr band (0 < fac < 1, where both sides of the blend are
    computed; r is finite and positive here, so nowhere else) and with
    |mid| > 0.5 (thetaofx2's quotient)."""
    from grtrans_tpu_torch.fluid import harmpi

    band_w = (1 - p.fracjet) - p.fracdisk

    def replay(f, target, lo, hi, events):
        lo = torch.full_like(target, lo)
        hi = torch.full_like(target, hi)
        live = torch.ones_like(target, dtype=torch.bool)
        n = dict.fromkeys(["steps", *events], 0)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            n["steps"] += live.sum()
            for name, mask in events.items():
                n[name] += (live & mask(mid)).sum()
            big = f(mid) > target
            last = (mid == lo) | (mid == hi)
            hi = torch.where(big, mid, hi)
            lo = torch.where(big, lo, mid)
            live &= ~last
        return {k: int(v) for k, v in n.items()}

    def band(mid):
        x = (mid.abs() - p.fracdisk) / band_w
        return (x > 0.0) & (x < 1.0)

    def outer(mid):
        return mid.abs() > 0.5

    x1 = replay(lambda v: harmpi.calcrmks(v, p), r, -2.0, 12.0,
                dict(above=lambda mid: mid > p.xbr))
    x2 = replay(lambda v: harmpi.calcthmksbl3(v, r, p), th, -1.0, 1.0,
                dict(band=band, outer=outer,
                     band_outer=lambda mid: band(mid) & outer(mid)))
    n = r.numel()
    ops = (n * INVERT_OPS["sample"]
           + x1["steps"] * INVERT_OPS["x1_step"]
           + x1["above"] * INVERT_OPS["x1_above"]
           + x2["steps"] * INVERT_OPS["x2_step"]
           + x2["outer"] * INVERT_OPS["x2_outer"]
           + x2["band"] * INVERT_OPS["x2_band"]
           + x2["band_outer"] * INVERT_OPS["x2_band_outer"])
    return dict(ops=ops, ops_per_sample=ops / n,
                x1_steps_per_sample=x1["steps"] / n,
                x1_above_share=x1["above"] / x1["steps"],
                x2_steps_per_sample=x2["steps"] / n,
                x2_band_share=x2["band"] / x2["steps"],
                x2_outer_share=x2["outer"] / x2["steps"])


def invert_phase(dev):
    """Phase 29: HARMPI's inversion kernels on the benchmark's frame, in
    float64 and in float32 (prec="mixed"): {dtype: row}."""
    import math

    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid import harmpi
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.orchestrator import grtrans_run
    from grtrans_tpu_torch.testing import grmhd_dump as gd

    spin = 0.9375
    cfg = GrtransConfig(
        fname="HARMPI", ename="POLSYNCHTH", nvals=4, spin=spin,
        nn=INVERT_NN, uout=0.04, mbh=4e6, mumin=0.6, mumax=0.6,
        fmin=2.3e11, fmax=2.3e11, iname="lsoda", mdotmin=1.2e17,
        mdotmax=1.2e17, gmin=-1.0, sigcut=1.0,
        gridvals=(-15.0, 15.0, -15.0, 15.0))
    model = load_fluid_model("HARMPI", device=dev,
                             dump=gd.harmpi_dump(bl=3, seed=SEED))
    kept = []
    invert = harmpi.x2_of_th_bl3

    def spy(th, r, p, *args, **kw):
        kept.append((th, r))
        return invert(th, r, p, *args, **kw)

    harmpi.x2_of_th_bl3 = spy
    try:
        reset_counts()
        grtrans_run(cfg, model, device=dev)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        harmpi.x2_of_th_bl3 = invert
    if counts["invert_kernel"] != 2 or counts["invert_twin"] != 0:
        raise AssertionError(f"HARMPI frame: {counts['invert_kernel']} "
                             f"inversion launches, {counts['invert_twin']} "
                             "twin calls (want 2 and 0)")
    del model
    th64, r64 = kept[0]
    del kept
    # the benchmark's grid (harmpi_sgra_eheat): from 0.87 r+ to 1000 M,
    # read_bl3_vars's jetcoords parameters, 288 x 128 zones
    rin = 0.87 * (1.0 + math.sqrt(1.0 - spin * spin))
    p = harmpi.bl3_params_from_header(
        dict(R0=0.0, hslope=0.3, startx1=math.log(rin)))
    x1out = harmpi.x1_of_r_twin(torch.tensor([1e3], dtype=torch.float64,
                                             device=dev), p).item()
    rows = {}
    for dtype in (torch.float64, torch.float32):
        th, r = th64.to(dtype), r64.to(dtype)
        n = r.numel()

        def kernels():
            return harmpi.x1_of_r(r, p), harmpi.x2_of_th_bl3(th, r, p)

        def twins():
            return (harmpi.x1_of_r_twin(r, p),
                    harmpi.x2_of_th_bl3_twin(th, r, p))

        (x1, x2), (t1, t2) = kernels(), twins()
        row = dict(samples=n, counts=counts)
        for name, ours, twin, lo, hi, nz in (("x1", x1, t1, math.log(rin),
                                              x1out, 288),
                                             ("x2", x2, t2, -1.0, 1.0, 128)):
            zone_k = torch.floor((ours - lo) / (hi - lo) * nz)
            zone_t = torch.floor((twin - lo) / (hi - lo) * nz)
            row[name] = dict(
                max_abs_err=(ours - twin).abs().max().item(),
                bit_equal=(ours == twin).double().mean().item(),
                zones_differ=(zone_k != zone_t).sum().item())
        del x1, x2, t1, t2
        t = dict(x1=cuda_ms(lambda: harmpi.x1_of_r(r, p), reps=5),
                 x2=cuda_ms(lambda: harmpi.x2_of_th_bl3(th, r, p), reps=5),
                 x1_twin=cuda_ms(lambda: harmpi.x1_of_r_twin(r, p), reps=1),
                 x2_twin=cuda_ms(lambda: harmpi.x2_of_th_bl3_twin(th, r, p),
                                 reps=1),
                 both=cuda_ms(kernels, reps=5))
        # outside the timing: the events of this frame's bisections
        work = invert_work(th, r, p)
        ops = work["ops"]
        nbytes = n * INVERT_OPERANDS_PER_SAMPLE * th.element_size()
        t_ops = ops / (PEAK_FLOPS[dtype] / 2) * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        ms = t["x1"] + t["x2"]
        row.update(ms=ms, plain_ms=t["x1_twin"] + t["x2_twin"],
                   bound_ms=bound,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   ops=ops, bytes=nbytes, share=bound / ms, work=work,
                   times=t)
        tag = "f64" if dtype == torch.float64 else "f32"
        print(f"harmpi inversion {tag} {n} samples: kernels {t['x1']:.3f} + "
              f"{t['x2']:.3f} ms (both {t['both']:.3f}), twins "
              f"{t['x1_twin']:.1f} + {t['x2_twin']:.1f} ms; bound "
              f"{bound:.3f} ms by {row['bound_by']} ({ops:.3e} ops "
              f"estimated from the replayed steps: {work}; "
              f"{nbytes / 1e9:.3f} GB), share {bound / ms:.1%}, estimated; "
              f"x1 {row['x1']}, x2 {row['x2']}")
        for name in ("x1", "x2"):
            if not (row[name]["max_abs_err"] <= INVERT_TOL[dtype]
                    and row[name]["zones_differ"] == 0):
                raise AssertionError(f"harmpi inversion {tag} {name}: "
                                     f"{row[name]}")
        rows[tag] = row
        del th, r
    return rows


RENDER_NN = (256, 256, 400)           # the benchmark's HARM3D frame
# FP operations of the render kernel (csrc/render_polsynchth.cu) by the
# branch a sample takes, counted from its source: an add, multiply,
# compare, negation or isfinite one each; a division, reciprocal or square
# root priced DIV, a transcendental function TRANS and pow two of them (its
# log and exp), INVERT_OPS' prices (estimates of their software sequences,
# not counts).  render_work counts on the frame the samples that take each
# branch.
POW = 2 * TRANS
RENDER_OPS = dict(
    valid=8,                          # u and b finite
    head=152 + 2 * TRANS + 4 * DIV,   # metric_cov, u lowered, the
                                      # transport's gammas, deltas, its
                                      # denominator and f, the Kulkarni
                                      # norms and their test
    basis=3 * DIV,                    # f / denom
    basis_pole=2 * DIV,               # pole-on: 1 / sqrt(g_phph)
    framed=286 + 20 * DIV + TRANS,    # the norms' roots, the tetrad, 13
                                      # projections, knorm and its test,
                                      # the basis perpendicular to k, the
                                      # angle's clamp and arccos, g, the
                                      # finite tests, g's clamp
    b_nonzero=6 + 5 * DIV,            # bdotb > 0: s2xi, c2xi, the cosine
    coef=127 + 25 * DIV + 10 * TRANS + 4 * POW,   # polsynchth but bnu and
                                      # the theta_e split (the emission
                                      # fits, jffunc, the Faraday terms),
                                      # coefindx, the zeroing, j g^2 lbh,
                                      # K / g lbh
    rotate=18,                        # rotate_emis (nvals = 4)
    bnu=6 + DIV,                      # T > 0: x = h nu / k T, the clamps
    bnu_rj=5,                         # x < 1e-6
    bnu_planck=6 + TRANS + DIV,       # expm1
    bnu_cold=1,                       # T = 0
    rel=18 + 5 * DIV + 2 * TRANS + POW,   # theta_e > 1e-2: K2, the tanh
                                      # step, shgmfunc, w11, w12
    nonrel=2,
    bessel_small=71 + 2 * TRANS + DIV,    # K0 and K1 at 1 / theta_e <= 2
    bessel_large=36 + 2 * TRANS + 6 * DIV,
    hor=2)                            # float32: the horizon cut
# j, K: kernel against twin, of each column's max|twin|
# (tests/test_torch_render_kernel.py's COEF_TOL); the image, of max|I|
# (the march kernel's bars, MARCH_TOL)
RENDER_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
RENDER_IMAGE_TOL = {torch.float64: 1e-12, torch.float32: 4e-5}


def render_work(args, ok, rotate, mixed, chunk=4096):
    """Count, on the frame of render_rays' arguments `args` and the
    kernel's mask `ok`, the samples that take each branch of RENDER_OPS,
    and price them.  A sample that stops inside a stage is priced as far
    as the replay sees it go (valid; u and b finite; the tetrad's frame_ok,
    its knorm test among them; ok), so the count is a least one: a sample
    that stops at knorm is priced to the frame test only.  The branches
    are read in float64 (the float32 leg's tests may fall otherwise on a
    few samples)."""
    import math

    from grtrans_tpu_torch import constants as pc
    from grtrans_tpu_torch.geometry import fourvector as fvec
    from grtrans_tpu_torch.geometry import kerr, tetrad

    geo, fv, ei, _, freqs, mu0, alpha, beta, a, _, _ = args
    kap_c = a * math.sqrt(1.0 - mu0 * mu0)
    n = collections.Counter()
    for p0 in range(0, geo.x.shape[0], chunk):
        s = slice(p0, p0 + chunk)
        r, th = geo.x[s, :, 1], geo.x[s, :, 2]
        u, b, k = fv.u[s], fv.b[s], geo.k[s]
        te, oks = ei.tcgs[s], ok[s]
        reach = geo.valid[s] & torch.isfinite(u).all(-1) \
            & torch.isfinite(b).all(-1)
        pole = ((alpha[s] + kap_c == 0.0) & (beta[s] == 0.0))[:, None]
        u = torch.where(reach[..., None], u, 0.0)
        b = torch.where(reach[..., None], b, 0.0)
        _, _, _, g, _, frame_ok = tetrad.comoving_ortho(
            r, th, a, alpha[s, None], beta[s, None], mu0, u, b, k)
        framed = reach & frame_ok
        bdotb = fvec.dot(kerr.metric_cov(r, th, a), b, b)
        g = torch.where(oks, g, 1.0).clamp(1e-8, 1e8)
        thetae = te * pc.k / (pc.m * pc.c2) + 1e-10
        rel = oks & (thetae > 1e-2)
        cold = oks & (te == 0.0)
        for name, mask in (("valid", geo.valid[s]), ("reach", reach),
                           ("pole", reach & pole), ("framed", framed),
                           ("b_nonzero", framed & (bdotb > 0.0)),
                           ("ok", oks), ("bnu_cold", cold), ("rel", rel),
                           ("bessel_small", rel & (1.0 / thetae <= 2.0))):
            n[name] += int(mask.sum())
        for fghz in freqs:
            x = (fghz / g) * pc.h / (te * pc.k)
            n["bnu_rj"] += int((oks & ~cold & (x < 1e-6)).sum())
    nf = len(freqs)
    o = RENDER_OPS
    ops = (n["valid"] * o["valid"]
           + nf * (n["reach"] * o["head"]
                   + (n["reach"] - n["pole"]) * o["basis"]
                   + n["pole"] * o["basis_pole"]
                   + n["framed"] * (o["framed"] + (o["hor"] if mixed else 0))
                   + n["b_nonzero"] * o["b_nonzero"]
                   + n["ok"] * (o["coef"] + (o["rotate"] if rotate else 0))
                   + n["bnu_cold"] * o["bnu_cold"]
                   + (n["ok"] - n["bnu_cold"]) * o["bnu"]
                   + n["rel"] * o["rel"]
                   + (n["ok"] - n["rel"]) * o["nonrel"]
                   + n["bessel_small"] * o["bessel_small"]
                   + (n["rel"] - n["bessel_small"]) * o["bessel_large"])
           + n["bnu_rj"] * o["bnu_rj"]
           + (nf * (n["ok"] - n["bnu_cold"]) - n["bnu_rj"])
           * o["bnu_planck"])
    total = geo.valid.numel()
    shares = {name: v / total / (nf if name == "bnu_rj" else 1)
              for name, v in n.items()}
    return dict(ops=ops, ops_per_sample=ops / total / nf, samples=total,
                shares=shares)


def render_phase(dev):
    """Phase 30: the POLSYNCHTH render kernel on the benchmark's HARM3D
    frame, in float64 and in float32 (prec="mixed"): {tag: row}."""
    from grtrans_tpu_torch import driver
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.integrate import solvers
    from grtrans_tpu_torch.ops import render_polsynchth as rp
    from grtrans_tpu_torch.orchestrator import grtrans_run
    from grtrans_tpu_torch.testing import grmhd_dump

    # the camera of the benchmark cell harm3d-incl-256-f64 (spin, uout,
    # mbh, field of view, 230 GHz, lsoda, gmin, muval, mdot) at mu0 0.6,
    # the middle of its traffic, on phase 12's snapshot
    model = load_fluid_model(
        "HARM3D", device=dev,
        dump=grmhd_dump.harm3d_dump(*SNAPSHOT_NX, seed=SEED))
    base = GrtransConfig(**snapshot_kwargs(
        "HARM3D", RENDER_NN, iname="lsoda", mbh=4e6, mumin=0.6, mumax=0.6))
    render, march = driver.render_rays, solvers.observed_stokes
    takes = driver._kernel_takes
    rows = {}
    for prec in ("f64", "mixed"):
        cfg = dataclasses.replace(base, prec=prec)
        mixed = prec == "mixed"
        dtype = torch.float32 if mixed else torch.float64
        tag = "f32" if mixed else "f64"
        grtrans_run(cfg, model, device=dev)              # warm
        kept = []

        def keep(*args, **kw):
            kept.append((args, kw))
            return render(*args, **kw)

        driver.render_rays = keep
        try:
            reset_counts()
            grtrans_run(cfg, model, device=dev)
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            driver.render_rays = render
        if counts["render_kernel"] != 1 or counts[f"render_kernel_{tag}"] \
                != 1 or counts["render_twin"] != 0:
            raise AssertionError(f"HARM3D {prec} frame: "
                                 f"{counts['render_kernel']} render kernel "
                                 f"launches ({tag}: "
                                 f"{counts[f'render_kernel_{tag}']}), "
                                 f"{counts['render_twin']} twin calls (want "
                                 "1, 1 and 0)")
        args, kw = kept.pop()

        def path(twin):
            """render_rays on the frame by the kernel or (twin) by its
            torch code: the image, the (j, K, ok) it hands the march and
            the counters it moved."""
            seen = []

            def catch(lam, j, K, method="formal", mask=None, **more):
                seen.append((j, K, mask))
                return march(lam, j, K, method=method, mask=mask, **more)

            solvers.observed_stokes = catch
            if twin:
                driver._kernel_takes = lambda *a: False
            try:
                reset_counts()
                ivals = render(*args, **kw)
                torch.cuda.synchronize()
                c = read_counts()
            finally:
                solvers.observed_stokes = march
                driver._kernel_takes = takes
            return ivals, seen[0], c

        ivals, (j, K, ok), c = path(False)
        if c["render_kernel"] != 1 or c["render_twin"] != 0:
            raise AssertionError(f"render {prec}: kernel path {c}")
        tivals, (tj, tK, tok), c = path(True)
        if c["render_twin"] != 1 or c["render_kernel"] != 0:
            raise AssertionError(f"render {prec}: twin path {c}")
        if not (j.dtype == tj.dtype == dtype and torch.equal(ok, tok)):
            raise AssertionError(f"render {prec}: dtypes {j.dtype}, "
                                 f"{tj.dtype}; masks equal "
                                 f"{torch.equal(ok, tok)}")
        cols = {}
        for name, ours, twin in (("j", j, tj), ("K", K, tK)):
            for col in range(twin.shape[-1]):
                ref = twin[..., col].abs().max().item()
                err = (ours[..., col] - twin[..., col]).abs().max().item()
                cols[f"{name}{col}"] = err / ref if ref > 0.0 else err
        bit_equal = ((j == tj).all(-1) & (K == tK).all(-1)).double().mean()
        imax = tivals[..., 0].abs().max().item()
        img_err = (ivals - tivals).abs().max().item() / imax
        del j, K, tj, tK, tok, ivals, tivals

        # times: the kernel alone on operands of its dtype, and
        # render_rays less the march on each path
        geo, fv, ei, _, freqs, mu0, alpha, beta, a, mbh, sp = args
        kargs = tuple(t.to(dtype) if t.is_floating_point() else t
                      for t in (geo.x, geo.k, geo.valid, fv.u, fv.b, alpha,
                                beta, ei.ncgs, ei.bcgs, ei.tcgs))
        rotate = kw.get("nvals", 4) == 4
        kkw = dict(a=a, mu0=mu0, fghz=freqs[0], mbh=mbh,
                   coefindx=sp.coefindx, rotate=rotate, mixed=mixed)

        def kernel():
            return rp.render_polsynchth(*kargs, **kkw)

        def no_march(lam, j, K, method="formal", mask=None, **more):
            return torch.zeros(j.shape[0], 4, dtype=j.dtype,
                               device=j.device)

        solvers.observed_stokes = no_march
        try:
            t = dict(kernel=cuda_ms(kernel, reps=5),
                     render=cuda_ms(lambda: render(*args, **kw), reps=5))
            driver._kernel_takes = lambda *a: False
            t["twin"] = cuda_ms(lambda: render(*args, **kw), reps=1)
        finally:
            solvers.observed_stokes = march
            driver._kernel_takes = takes
        t["kernel_again"] = cuda_ms(kernel, reps=5)
        ms = min(t["kernel"], t["kernel_again"])
        del kargs

        # the bound: x read whole (its 32-byte rows in float64, two rows a
        # sector in float32), k, u, b, n, B, T and valid read, j, K and ok
        # written, against the operations of the branches the frame takes
        # over the unfused rate
        n = ok.numel()
        size = torch.finfo(dtype).bits // 8
        nbytes = (n * ((4 + 12 + 3 + 11) * size + 2)
                  + 2 * alpha.numel() * size)
        work = render_work(args, ok, rotate, mixed)
        ops = work["ops"] / len(freqs)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / (PEAK_FLOPS[dtype] / 2) * 1e3
        bound = max(t_bytes, t_ops)
        rows[tag] = dict(
            ms=ms, plain_ms=t["twin"], bound_ms=bound,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bytes=nbytes, ops=ops, bytes_ms=t_bytes, ops_ms=t_ops,
            share=bound / ms, bytes_share=t_bytes / ms,
            max_rel_err=max(cols.values()), col_rel_err=cols,
            bit_equal=bit_equal.item(), ok_share=ok.double().mean().item(),
            image_rel_err=img_err, work=work, counts=counts, times=t)
        print(f"render {tag} {RENDER_NN}: kernel {ms:.3f} ms "
              f"({t['kernel']:.3f}, {t['kernel_again']:.3f}), render_rays "
              f"less the march {t['render']:.3f} ms, twin {t['twin']:.1f} "
              f"ms; bound {bound:.3f} ms by {rows[tag]['bound_by']} "
              f"({nbytes / 1e9:.3f} GB: {t_bytes:.3f} ms; {ops:.4e} ops, "
              f"{work['ops_per_sample']:.1f} a sample, counted from the "
              f"source by branch at the frame's shares {work['shares']}: "
              f"{t_ops:.3f} ms), share {bound / ms:.1%}; kernel vs twin "
              f"by column {cols}, bit for bit on {bit_equal.item():.6%} of "
              f"samples, image {img_err:.3e} of max|I|")
        if not (max(cols.values()) <= RENDER_TOL[dtype]
                and img_err <= RENDER_IMAGE_TOL[dtype]):
            raise AssertionError(f"render {tag}: kernel vs twin {cols}, "
                                 f"image {img_err}")
        del args, kw, ok
    del model
    return rows


def reset_counts():
    """Count the gather launches and twin calls from here on (the obs
    counters as they stand are the base)."""
    reset_counts.base = obs.counters()


reset_counts.base = collections.Counter()


def read_counts():
    """The launches by kernel and dtype, and the twin calls, since the
    last reset_counts()."""
    c = obs.counters()
    c.subtract(reset_counts.base)
    counts = dict(tiled=c["quad_gather.launches.tiled"],
                  wide=c["quad_gather.launches.wide"],
                  generic=c["quad_gather.launches.generic"],
                  rows_tiled=c["quad_gather_rows.launches.tiled"],
                  rows_simple=c["quad_gather_rows.launches.simple"],
                  bwd_tiled=c["quad_gather_bwd_w.launches.tiled"],
                  bwd_generic=c["quad_gather_bwd_w.launches.generic"],
                  rows_bwd_tiled=c["quad_gather_rows_bwd_w.launches.tiled"],
                  rows_bwd_simple=c["quad_gather_rows_bwd_w.launches.simple"],
                  twin_calls=sum(c[f"{name}.calls"] for name in TWINS),
                  march_kernel=c["march.kernel.launches"],
                  march_twin=c["march.twin.calls"],
                  invert_kernel=c["harmpi.invert.kernel.launches"],
                  invert_twin=c["harmpi.invert.twin.calls"],
                  render_kernel=c["render.kernel.launches"],
                  render_kernel_f64=c["render.kernel.launches.f64"],
                  render_kernel_f32=c["render.kernel.launches.f32"],
                  render_twin=c["render.twin.calls"])
    for name in WRAPPERS:
        counts[name] = c[f"{name}.launches"]
        for dt in ("f32", "f64"):
            counts[f"{name}_{dt}"] = c[f"{name}.launches.{dt}"]
    return counts


def rows_bound_ms(table, idx, w, nc, nf):
    """Least time for one quad_gather_rows: its bytes (roofline.gather_bytes:
    index, weights and output once and every distinct row once) over the
    memory rate, against 2 R nc nf operations a query over the peak rate;
    and the distinct rows."""
    n, r = idx.shape
    t_bytes = roofline.gather_bytes(table, idx, w, nc, nf) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * n * r * nc * nf / PEAK_FLOPS[w.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), idx.unique().numel()


def check_rows(qg, name, table, idx, w, nc, nf, reps=10, graph=False):
    """quad_gather_rows against its plain version on the card, on the
    kernel the wrapper picks and, where that is the tiled one, on the simple
    kernel (the table copied off 16 bytes), then CUDA event times of the
    picked one in the order plain, embedding_bag, kernel, and back; with
    `graph`, the kernel once more from CUDA graphs (graph_ms: device time
    without the host's launch cost), "kernel graph".  Returns the dict of
    mean times, the bound, the picked kernel's max_abs_err and name
    ("picked") and the simple kernel's (None where not run)."""
    n, r = idx.shape
    ns = table.shape[0]
    picked = qg.rows_kernel(r, nc, nf, table.element_size(),
                            table.data_ptr() % 16 == 0)

    def kernel():
        return qg.quad_gather_rows(table, idx, w, nc, nf)

    ref = qg.quad_gather_rows_ref(table, idx, w, nc, nf)
    # a ray's samples past its end carry NaN weights: NaN in both
    fin = torch.isfinite(ref)
    scale = ref[fin].abs().max().item()
    tol = ROWS_TOL[table.dtype]
    out = kernel()
    torch.cuda.synchronize()
    if not torch.equal(torch.isfinite(out), fin):
        raise AssertionError(f"{name}: {picked} kernel and plain differ in "
                             "where they are finite")
    err = (out - ref)[fin].abs().max().item()
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max|{picked} - plain| {err} > {tol} "
                             f"* {scale}")
    if qg.error_flag(table.device).item() != 0:
        raise AssertionError(f"{name}: out-of-range flag set")
    del out
    simple_err = None
    if picked == "tiled":
        # the simple kernel at the same shape, reached with the table off
        # 16 bytes
        before = obs.counters()["quad_gather_rows.launches.simple"]
        out = qg.quad_gather_rows(off_16(table), idx, w, nc, nf)
        torch.cuda.synchronize()
        if obs.counters()["quad_gather_rows.launches.simple"] != before + 1:
            raise AssertionError(f"{name}: a table off 16 bytes did not go "
                                 "to the simple kernel")
        if not torch.equal(torch.isfinite(out), fin):
            raise AssertionError(f"{name}: simple kernel and plain differ "
                                 "in where they are finite")
        simple_err = (out - ref)[fin].abs().max().item()
        if not simple_err <= tol * scale:
            raise AssertionError(f"{name}: max|simple - plain| {simple_err} "
                                 f"> {tol} * {scale}")
        if qg.error_flag(table.device).item() != 0:
            raise AssertionError(f"{name}: out-of-range flag set (simple)")
        del out
        torch.cuda.empty_cache()
    del ref
    bag_idx = (idx.long()[:, :, None] * nc
               + torch.arange(nc, device=idx.device)).reshape(n, r * nc)
    bag_table = table.view(ns * nc, nf)
    bag_w = w.reshape(n, r * nc)

    def plain():
        return qg.quad_gather_rows_ref(table, idx, w, nc, nf)

    def library():
        return torch.nn.functional.embedding_bag(
            bag_idx, bag_table, per_sample_weights=bag_w, mode="sum")

    lib_err = (library() - plain())[fin].abs().max().item()
    del fin
    times = {}
    order = [plain, library, kernel]
    for fn in order + order[::-1]:
        times.setdefault(fn.__name__, []).append(cuda_ms(fn, reps))
    if graph:
        for _ in range(2):
            times.setdefault("kernel graph", []).append(graph_ms(kernel,
                                                                 reps))
    bound, bound_by, distinct = rows_bound_ms(table, idx, w, nc, nf)
    res = {k: sum(v) / len(v) for k, v in times.items()}
    res.update(bound_ms=bound, bound_by=bound_by, max_abs_err=err,
               picked=picked, simple_max_abs_err=simple_err)
    also = "" if simple_err is None else \
        f", max|simple (table off 16 bytes) - plain| {simple_err:.3e}"
    print(f"{name}: N={n} R={r} table=({ns}, {nc * nf}) {table.dtype}, "
          f"{distinct} distinct rows: max|{picked} - plain| {err:.3e}{also} "
          f"(max|plain| {scale:.3e}, bar {tol:g} of it); ms "
          + "; ".join(f"{k} " + "/".join(f"{t:.4f}" for t in v)
                      for k, v in times.items())
          + f"; bound {bound:.4f} ms by {bound_by}; share of bound "
          f"{bound / res['kernel']:.3f} (the wrapper picks {picked}); "
          f"max|embedding_bag - plain| {lib_err:.2e}")
    return res


def random_rows(ns, n, r, nc, dtype, dev, seed=SEED):
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, ns, (n, r), generator=g, dtype=torch.int32,
                        device=dev)
    w = torch.rand((n, r, nc), generator=g, dtype=dtype, device=dev)
    return idx, w


def rows_phase(dev, qg):
    """Phase 11.  Returns the dict of shapes timed."""
    ns = SNAPSHOT_NX[0] * SNAPSHOT_NX[1] * SNAPSHOT_NX[2]
    nc, nf = 2, 10
    g = torch.Generator(device=dev).manual_seed(SEED)
    shapes = {}
    table = torch.randn((3 * ns, nc * nf), generator=g, dtype=torch.float64,
                        device=dev)
    idx, w = random_rows(ns, N_QUERIES, 4, nc, torch.float64, dev)
    shapes["snapshot R=4 f64"] = check_rows(
        qg, "snapshot R=4 f64", table[:ns], idx, w, nc, nf)
    t32 = table[:ns].float()
    shapes["snapshot R=4 f32"] = check_rows(
        qg, "snapshot R=4 f32", t32, idx, w.float(), nc, nf)
    del t32
    # every query on one row: one distinct row a tile, the deduplication's
    # worst case
    shapes["snapshot R=4 f64, one row"] = check_rows(
        qg, "snapshot R=4 f64, one row", table[:ns],
        torch.full_like(idx, ns // 2), w, nc, nf)
    idx, w = random_rows(3 * ns, N_QUERIES, 8, nc, torch.float64, dev)
    shapes["three slices R=8 f64"] = check_rows(
        qg, "three slices R=8 f64", table, idx, w, nc, nf)
    del table, idx, w
    torch.cuda.empty_cache()
    # HARMPI's shape: one row of the plain (zones, 10) table a sample
    table = torch.randn((ns, nf), generator=g, dtype=torch.float64,
                        device=dev)
    idx, w = random_rows(ns, N_QUERIES, 1, 1, torch.float64, dev)
    shapes["harmpi R=1 nc=1 f64"] = check_rows(
        qg, "harmpi R=1 nc=1 f64", table, idx, w, 1, nf)
    del table, idx, w
    torch.cuda.empty_cache()
    # KORAL3D's binned population: 8 (3-D) or 4 (2-D) rows of a plain
    # table; 100,003 queries leave a ragged last tile.  These launches
    # are short enough that a loop of them is paced by the host, so they
    # are also timed from CUDA graphs
    table = torch.randn((100_000, 6), generator=g, dtype=torch.float64,
                        device=dev)
    for r in (8, 4):
        idx, w = random_rows(100_000, 100_003, r, 1, torch.float64, dev)
        shapes[f"bins R={r} nc=1 f64"] = check_rows(
            qg, f"bins R={r} nc=1 f64", table, idx, w, 1, 6, graph=True)
    # rows the bulk copy cannot take: KORAL3D's 2 x 11 in float32
    table = torch.randn((1_000_000, 22), generator=g, dtype=torch.float32,
                        device=dev)
    idx, w = random_rows(1_000_000, 1_000_000, 4, 2, torch.float32, dev)
    before = obs.counters()["quad_gather_rows.launches.simple"]
    qg.quad_gather_rows(table, idx, w, 2, 11)
    if obs.counters()["quad_gather_rows.launches.simple"] != before + 1:
        raise AssertionError("2 x 11 float32 did not go to the simple kernel")
    shapes["koral3d R=4 2x11 f32"] = check_rows(
        qg, "koral3d R=4 2x11 f32", table, idx, w, 2, 11)
    del table, idx, w
    torch.cuda.empty_cache()
    # the wide-row kernel at widths ragged against the warp
    for nc_, nf_, dtype in ((2, 101, torch.float32), (3, 45, torch.float64),
                            (1, 257, torch.float64)):
        before = obs.counters()["quad_gather.launches.wide"]
        rng = np.random.default_rng(SEED)
        tb = torch.as_tensor(rng.standard_normal((300, nc_ * nf_)),
                             dtype=dtype, device=dev)
        ix = torch.as_tensor(rng.integers(0, 300, 100_003), dtype=torch.int32,
                             device=dev)
        ww = torch.as_tensor(rng.uniform(0, 1, (100_003, nc_)), dtype=dtype,
                             device=dev)
        compare_gather(qg, f"wide ({nc_} x {nf_}) {dtype}", tb, ix, ww, nc_,
                       nf_)
        if obs.counters()["quad_gather.launches.wide"] != before + 1:
            raise AssertionError("the wrapper did not pick the wide kernel")
    # the error flag of the wide and the rows kernels
    flag = qg.error_flag(dev)
    tb = torch.ones((16, 202), dtype=torch.float64, device=dev)
    out = qg.quad_gather(tb, torch.tensor([0, 16, 3], dtype=torch.int32,
                                          device=dev),
                         torch.ones((3, 2), dtype=torch.float64, device=dev),
                         2, 101)
    torch.cuda.synchronize()
    if flag.item() != 1 or not torch.isnan(out[1]).all() \
            or not (out[[0, 2]] == 2).all():
        raise AssertionError("wide kernel: out-of-range index not flagged")
    flag.zero_()
    idx = torch.zeros((200, 4), dtype=torch.int32, device=dev)
    idx[1, 2] = 16
    idx[199, 0] = -1
    bad = torch.zeros(200, dtype=torch.bool, device=dev)
    bad[[1, 199]] = True
    rows20 = torch.ones(16 * 20 + 1, dtype=torch.float64, device=dev)
    for kernel, table in (("tiled", rows20[:-1].view(16, 20)),
                          ("simple", rows20[1:].view(16, 20))):
        before = obs.counters()[f"quad_gather_rows.launches.{kernel}"]
        out = qg.quad_gather_rows(table, idx,
                                  torch.ones((200, 4, 2), dtype=torch.float64,
                                             device=dev), 2, 10)
        torch.cuda.synchronize()
        if obs.counters()[f"quad_gather_rows.launches.{kernel}"] != \
                before + 1:
            raise AssertionError(f"quad_gather_rows: the {kernel} kernel "
                                 "was not picked")
        if flag.item() != 1 or not torch.isnan(out[bad]).all() \
                or not (out[~bad] == 8).all():
            raise AssertionError(f"quad_gather_rows {kernel}: out-of-range "
                                 "index not flagged")
        flag.zero_()
    print("wide and rows kernels (tiled, simple on a table off 16 bytes): "
          "out-of-range index flagged, its query NaN, others untouched")
    return shapes


def time_gather(qg, name, table, idx, w, nc, nf):
    """CUDA-event times of the plain version, the one-call PyTorch
    yardstick (embedding_bag, used nowhere in the port) and the kernel the
    wrapper picks, in the order plain, library, kernel, kernel, library,
    plain.  Returns a dict of mean times in ms plus the bound."""
    n, ns = idx.shape[0], table.shape[0]
    bag_idx = idx.long()[:, None] * nc + torch.arange(nc, device=idx.device)
    bag_table = table.view(ns * nc, nf)

    def plain():
        return qg.quad_gather_ref(table, idx, w, nc, nf)

    def library():
        return torch.nn.functional.embedding_bag(
            bag_idx, bag_table, per_sample_weights=w, mode="sum")

    def kernel():
        return qg.quad_gather(table, idx, w, nc, nf)

    lib_err = (library() - plain()).abs().max().item()
    order = [plain, library, kernel, kernel, library, plain]
    times = {}
    for fn in order:
        times.setdefault(fn.__name__, []).append(cuda_ms(fn))
    bound, bound_by = gather_bound_ms(n, ns, nc, nf, table.dtype)
    res = {k: sum(v) / len(v) for k, v in times.items()}
    res.update(bound_ms=bound, bound_by=bound_by)
    print(f"{name}: N={n} table=({ns}, {nc * nf}) {table.dtype}: kernel "
          + "/".join(f"{t:.4f}" for t in times["kernel"])
          + " ms, plain " + "/".join(f"{t:.4f}" for t in times["plain"])
          + " ms, embedding_bag "
          + "/".join(f"{t:.4f}" for t in times["library"])
          + f" ms; bound {bound:.4f} ms by {bound_by} "
          f"(share of bound {bound / res['kernel']:.3f}); "
          f"max|embedding_bag - plain| {lib_err:.2e}")
    return res


def check_kernel(qg, name, ns, nc, nf, dtype, dev, n=N_QUERIES):
    """Kernel vs plain on the card on n uniformly random rows; returns
    (max_abs_err, times dict of time_gather)."""
    rng = np.random.default_rng(SEED)
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, n), dtype=torch.int32,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, (n, nc)), dtype=dtype,
                        device=dev)
    err = compare_gather(qg, name, table, idx, w, nc, nf)
    return err, time_gather(qg, name, table, idx, w, nc, nf)


def compare_gather(qg, name, table, idx, w, nc, nf):
    """quad_gather against its plain version on the card, on the kernel the
    wrapper picks and, where that is the tiled one, on the generic kernel
    (the weights copied off 16 bytes): each within KERNEL_TOL of
    max|plain|, no out-of-range flag.  Returns the picked kernel's
    max_abs_err."""
    ref = qg.quad_gather_ref(table, idx, w, nc, nf)
    scale = ref.abs().max().item()
    tol = KERNEL_TOL[table.dtype]
    runs = [("kernel", w)]
    if qg.gather_kernel(nc, nf, True) == "tiled":
        runs.append(("generic", off_16(w)))
    errs = {}
    for kernel, ww in runs:
        before = obs.counters()["quad_gather.launches.generic"]
        out = qg.quad_gather(table, idx, ww, nc, nf)
        torch.cuda.synchronize()
        if kernel == "generic" and \
                obs.counters()["quad_gather.launches.generic"] != before + 1:
            raise AssertionError(f"{name}: weights off 16 bytes did not go "
                                 "to the generic kernel")
        errs[kernel] = (out - ref).abs().max().item()
        if not errs[kernel] <= tol * scale:
            raise AssertionError(f"{name}: max|{kernel} - plain| "
                                 f"{errs[kernel]} > {tol} * {scale}")
        if qg.error_flag(table.device).item() != 0:
            raise AssertionError(f"{name}: out-of-range flag set ({kernel})")
        del out
    print(f"{name}: " + ", ".join(f"max|{k} - plain| {v:.3e}"
                                  for k, v in errs.items())
          + f" (max|plain| {scale:.3e}, bar {tol:g} of it)")
    return errs["kernel"]


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


def ffjet_phases(dev, qg):
    """Phases 4 and 5.  Returns (counts of the counted render, times of
    the kernel on that frame's index stream, the flagship: its config,
    model, image and warm frame time)."""
    from grtrans_tpu_torch import convert, driver
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid import ffjet
    from grtrans_tpu_torch.geodesics import camera, geokerr
    from grtrans_tpu_torch.orchestrator import _source_params, grtrans_run
    from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump

    with tempfile.TemporaryDirectory() as tmp:
        dfile = Path(tmp) / "ffjet.bin"
        write_ffjet_dump(dfile, nx=FFJET_NX, seed=SEED)
        grids, fields = ffjet.load_ffjet_file(dfile)
        cfg = flagship_config(GrtransConfig, dfile, NN)
        npix = NN[0] * NN[1]
        model = convert.ffjet_from_arrays(grids, fields, dev)

        # 4. the main path, counted
        reset_counts()
        t0 = time.perf_counter()
        ivals, _, _ = grtrans_run(cfg, model, device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts()
        launches = counts["quad_gather"]
        if launches == 0:
            raise AssertionError("FFJET path never launched quad_gather")
        if qg.error_flag(dev).item() != 0:
            raise AssertionError("FFJET path: out-of-range table index")
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
        t0 = time.perf_counter()
        again, _, _ = grtrans_run(cfg, model, device=dev)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        rerun = (again - ivals).abs().max().item()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"warm render: {warm * 1e3:.1f} ms per frame "
              f"({npix / warm / 1e6:.6f} Mrays/s); peak "
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
        # keep the operands FFJet.vals hands the kernel: the frame's own
        # index stream
        frame_args = []
        wrapper = ffjet.quad_gather

        def keep(*args):
            frame_args.append(args)
            return wrapper(*args)

        ffjet.quad_gather = keep
        try:
            fv = stage("ffjet_vals", lambda: model.vals(geo.x, geo.k, 0.998))
        finally:
            ffjet.quad_gather = wrapper
        ei = stage("convert", lambda: model.convert(fv, sp))
        stage("render_rays", lambda: driver.render_rays(
            geo, fv, ei, cfg.ename, [cfg.fmin], 0.906, cam.alpha, cam.beta,
            0.998, cfg.mbh, sp, iname="formal"))
        print("stages (ms): " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in stages.items()))
        table, idx, w, nc, nf = frame_args[0]
        distinct = idx.unique().numel()
        print(f"frame index stream: {idx.numel()} queries, {distinct} "
              f"distinct rows of {table.shape[0]}")
        err = compare_gather(qg, "ffjet f64, frame's rows", table, idx, w,
                             nc, nf)
        frame_times = dict(time_gather(qg, "ffjet f64, frame's rows", table,
                                       idx, w, nc, nf), max_abs_err=err)

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
    return counts, frame_times, dict(cfg=cfg, model=model, ivals=ivals,
                                     warm_ms=warm * 1e3)


def counted_run(qg, dev, name, kw, model=None):
    """Grtrans(**kw).run() on the card with every kernel's launch count set
    to 0 just before and read just after (kept whole in
    counted_run.counts); then one warm run for the wall time, the peak
    memory and a rerun that must be identical.  Returns (result,
    quad_gather launches)."""
    from grtrans_tpu_torch.api import Grtrans

    reset_counts()
    t0 = time.perf_counter()
    x = Grtrans(**kw).run(model=model)
    first_s = time.perf_counter() - t0
    counted_run.counts = read_counts()
    launches = counted_run.counts["quad_gather"]
    if qg.error_flag(dev).item() != 0:
        raise AssertionError(f"{name}: out-of-range table index")
    if not np.isfinite(x.ivals).all():
        raise AssertionError(f"{name}: image not finite")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    again = Grtrans(**kw).run(model=model)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    rerun = np.abs(again.ivals - x.ivals).max()
    ncams = x.ivals.shape[2]
    nn = kw["nn"]
    print(f"{name} {nn[0]}x{nn[1]}x{nn[2]} x {ncams} cameras, "
          f"{kw.get('prec', 'f64')}: first "
          f"{first_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms "
          f"({ncams * nn[0] * nn[1] / warm_s / 1e6:.6f} Mrays/s); "
          f"launches {counted_run.counts}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; max|rerun - first| {rerun:.3e}")
    if rerun != 0.0:
        raise AssertionError(f"{name}: rerun differs by {rerun}")
    return x, launches


def riaf_phases(dev, qg):
    """Phases 6 and 7.  Returns the counts of the counted run."""
    from grtrans_tpu_torch.api import Grtrans

    # 6. the RIAF through the API, counted
    kw = riaf_kwargs(NN, "lsoda")
    x, launches = counted_run(qg, dev, "RIAF lsoda", kw)
    counts = counted_run.counts
    if launches < kw["nfreq"]:
        raise AssertionError(f"RIAF path launched quad_gather {launches} "
                             f"times for {kw['nfreq']} frequencies")
    if x.ivals.shape != (NN[0] * NN[1], 4, kw["nfreq"]):
        raise AssertionError(f"bad RIAF image {x.ivals.shape}")
    imax = x.ivals[:, 0].max(0)
    if not ((imax > 1e-5) & (imax < 1.0)).all():
        raise AssertionError(f"RIAF I max {imax}: not of order 1e-3 cgs")
    if not ((x.lp >= 0.0) & (x.lp <= 1.0)).all():
        raise AssertionError(f"RIAF LP {x.lp} outside [0, 1]")
    print(f"RIAF: I max {imax}, spectrum {x.spec[0]}, LP {x.lp}, CP {x.cp}")

    # 7. every integrator, the card against the port's CPU run.  The gate
    # is on cameras that start at r = 400 (uout = 0.0025), where 64
    # points resolve the flow.  From the default uout = 1e-4 a 64-point
    # ray crosses r = 1e4 .. 400 in cells hundreds of M long and thousands
    # of radians of Faraday rotation deep, which turn last-bit differences
    # of exp, sin and cos into polarization angle: there Stokes I is held
    # and the whole image is printed.
    for iname in ("formal", "lsoda", "delo", "quadrature"):
        for uout, whole_image in ((0.0025, True), (1e-4, False)):
            small = dict(riaf_kwargs((16, 16, 64), iname), uout=uout)
            gpu = Grtrans(**small).run().ivals
            cpu = Grtrans(**small).run(device="cpu").ivals
            rel = np.abs(gpu - cpu).sum() / np.abs(cpu).sum()
            rel_i = np.abs(gpu[:, 0] - cpu[:, 0]).sum() \
                / np.abs(cpu[:, 0]).sum()
            print(f"RIAF 16x16x64 {iname} uout={uout:g}: card vs CPU rel "
                  f"L1 {rel:.3e}, Stokes I alone {rel_i:.3e} (bar "
                  f"{CPU_GPU_RTOL} on "
                  f"{'the whole image' if whole_image else 'Stokes I'})")
            if not (rel if whole_image else rel_i) <= CPU_GPU_RTOL:
                raise AssertionError(
                    f"RIAF {iname} uout={uout:g}: card vs CPU rel L1 {rel}, "
                    f"Stokes I {rel_i}")
    return counts


def hotspot_phase(dev, qg):
    """Phase 8.  Returns the counts of the counted run."""
    kw = hotspot_kwargs(NN, HOTSPOT_FRAMES)
    x, launches = counted_run(qg, dev, "hotspot", kw)
    if x.ivals.shape != (NN[0] * NN[1], 4, HOTSPOT_FRAMES):
        raise AssertionError(f"bad hotspot image {x.ivals.shape}")
    # POLSYNCHPL looks its cutoff table up at x_min and x_max: two launches
    # a frame and frequency
    if launches != 2 * HOTSPOT_FRAMES:
        raise AssertionError(f"hotspot path launched quad_gather {launches} "
                             f"times, not {2 * HOTSPOT_FRAMES}")
    lc = x.spec[0]
    mod = lc.std() / lc.mean()
    print(f"hotspot light curve {lc}, std/mean {mod:.4f}, LP {x.lp}")
    if not (lc.min() > 0 and mod > 0.1):
        raise AssertionError(f"hotspot light curve {lc}: no orbital "
                             "modulation")
    return counted_run.counts


def disk_phase(dev, qg):
    """Phase 9.  Returns the counts of the two counted runs."""
    npix = DISK_NN[0] * DISK_NN[1]
    x, _ = counted_run(qg, dev, "thin disk",
                       disk_kwargs(DISK_NN, **THINDISK))
    thin_counts = counted_run.counts
    if x.ivals.shape != (npix, 4, THINDISK["nfreq"]):
        raise AssertionError(f"bad thin-disk image {x.ivals.shape}")
    I = x.ivals[:, 0]
    lp = np.sqrt(x.ivals[:, 1] ** 2 + x.ivals[:, 2] ** 2)
    nz = I > I.max() * 1e-6
    if not ((I >= 0).all() and I.max() > 0
            and (lp[nz] <= 0.1180 * I[nz] * 1.001).all()):
        raise AssertionError("thin disk: negative I or polarization above "
                             "the Chandrasekhar maximum")
    print(f"thin disk: I max {I.max(0)}, spectrum {x.spec[0]}, LP {x.lp}, "
          f"largest pixel LP {(lp[nz] / I[nz]).max():.5f}, "
          f"{(I[:, 0] > 0).mean():.4f} of the rays hit the disk")

    x, phat_launches = counted_run(qg, dev, "phatdisk",
                                   disk_kwargs(DISK_NN, **PHATDISK))
    phat_counts = counted_run.counts
    if phat_counts["wide"] < 1:
        raise AssertionError("PHATDISK path never launched the wide-row "
                             "kernel")
    if x.ivals.shape != (npix, 1, PHATDISK["nfreq"]):
        raise AssertionError(f"bad PHATDISK image {x.ivals.shape}")
    if phat_launches < 1:
        raise AssertionError("PHATDISK path never launched quad_gather")
    I = x.ivals[:, 0]
    if not ((I >= 0).all() and (I.max(0) > 0).all()):
        raise AssertionError(f"PHATDISK I max {I.max(0)}")
    print(f"phatdisk: I max {I.max(0)}, spectrum {x.spec[0]}")
    return thin_counts, phat_counts


def card_vs_cpu_phase():
    """Phase 10: the hotspot, the disks and extra=1 on the card against
    the port's CPU run."""
    from grtrans_tpu_torch.api import Grtrans

    small_disk = (32, 32, 1)
    cases = {"hotspot 16x16x64 x 2 frames": hotspot_kwargs((16, 16, 64), 2),
             "thin disk 32x32x1": disk_kwargs(small_disk, **THINDISK),
             "phatdisk 32x32x1": disk_kwargs(small_disk, **PHATDISK)}
    for name, kw in cases.items():
        gpu = Grtrans(**kw).run().ivals
        cpu = Grtrans(**kw).run(device="cpu").ivals
        rel = np.abs(gpu - cpu).sum() / np.abs(cpu).sum()
        print(f"{name}: card vs CPU rel L1 {rel:.3e} (bar {CPU_GPU_RTOL})")
        if not rel <= CPU_GPU_RTOL:
            raise AssertionError(f"{name}: card vs CPU rel L1 {rel}")

    kw = dict(riaf_kwargs((16, 16, 64), "formal"), ename="POLSYNCHTH",
              uout=0.0025, extra=1)
    gpu = Grtrans(**kw).run().ivals
    cpu = Grtrans(**kw).run(device="cpu").ivals
    if gpu.shape != (256, 4 + 19, kw["nfreq"]):
        raise AssertionError(f"bad extra=1 image {gpu.shape}")
    rel = np.abs(gpu[:, :4] - cpu[:, :4]).sum() / np.abs(cpu[:, :4]).sum()
    rel_x = np.abs(gpu[:, 4:] - cpu[:, 4:]).sum((0, 2)) \
        / np.abs(cpu[:, 4:]).sum((0, 2))
    print(f"RIAF 16x16x64 formal extra=1: card vs CPU rel L1 of Stokes "
          f"{rel:.3e} (bar {CPU_GPU_RTOL}), of the 19 extra channels "
          + " ".join(f"{v:.1e}" for v in rel_x)
          + f" (bar {EXTRA_RTOL} each)")
    if not (rel <= CPU_GPU_RTOL and (rel_x <= EXTRA_RTOL).all()):
        raise AssertionError(f"extra=1: card vs CPU Stokes {rel}, extra "
                             f"channels {rel_x}")


def snapshot_phases(dev, qg):
    """Phases 12 and 13.  Returns (counts of the fast-light frame, counts
    of the slow-light frame, times of quad_gather_rows on each frame's own
    index stream, the model back on its one slice, the fast-light
    frame's image)."""
    from grtrans_tpu_torch import constants as pc
    from grtrans_tpu_torch import driver
    from grtrans_tpu_torch.api import Grtrans
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid import grmhd3d
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.geodesics import camera, geokerr
    from grtrans_tpu_torch.orchestrator import _source_params
    from grtrans_tpu_torch.testing import grmhd_dump

    t0 = time.perf_counter()
    dump = grmhd_dump.harm3d_dump(*SNAPSHOT_NX, seed=SEED)
    t1 = time.perf_counter()
    model = load_fluid_model("HARM3D", device=dev, dump=dump)
    table, names = model._stacked_fields()
    torch.cuda.synchronize()
    print(f"snapshot {SNAPSHOT_NX}: synthetic dump {t1 - t0:.1f} s on the "
          f"host, load + pack {time.perf_counter() - t1:.1f} s; table "
          f"{tuple(table.shape)} {table.dtype}, "
          f"{table.numel() * 8 / 1e6:.0f} MB")
    del dump

    # 12. the frame, counted
    kw = snapshot_kwargs("HARM3D", NN)
    npix = NN[0] * NN[1]
    x, _ = counted_run(qg, dev, "HARM3D snapshot", kw, model=model)
    fast_counts = counted_run.counts
    if fast_counts["quad_gather_rows"] != 1 or fast_counts["rows_tiled"] != 1:
        raise AssertionError(f"HARM3D frame launches {fast_counts}: expected "
                             "one quad_gather_rows launch, on the tiled "
                             "kernel")
    I = x.ivals[:, 0, 0]
    if x.ivals.shape != (npix, 4, 1) or not (I >= 0).all() or I.max() <= 0:
        raise AssertionError(f"bad HARM3D image {x.ivals.shape}, I min "
                             f"{I.min()}")
    flux_fast = x.spec[0, 0]
    jy = flux_fast * pc.lbh(kw["mbh"]) ** 2 / SGRA_DISTANCE_CM ** 2 * 1e23
    print(f"HARM3D: I max {I.max():.6e}, total flux {flux_fast:.6e} cgs = "
          f"{jy:.4f} Jy at Sgr A* (mdot {SNAPSHOT_MDOT:g} g/s), LP {x.lp}, "
          f"CP {x.cp}")
    if not 0.1 < jy < 10.0:
        raise AssertionError(f"HARM3D flux {jy} Jy: not of order 1 Jy")

    # stage walls of one frame, and the frame's own index stream
    cfg = GrtransConfig(**kw)
    a, mu0 = cfg.spin, cfg.mumin
    cam = camera.make_camera(a, mu0, *cfg.gridvals, NN[0], NN[1], device=dev)
    sp = _source_params(cfg, SNAPSHOT_MDOT)
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    geo = stage("trace", lambda: geokerr.trace(
        a, mu0, cam.alpha, cam.beta, cam.l, cam.q2, cam.sm, cam.u0, NN[2],
        uout=cfg.uout, phi0=cfg.phi0))
    frame_args = []
    wrapper = grmhd3d.quad_gather_rows

    def keep(*args):
        frame_args.append(args)
        return wrapper(*args)

    grmhd3d.quad_gather_rows = keep
    try:
        fv = stage("harm3d_vals", lambda: model.vals(geo.x, geo.k, a))
    finally:
        grmhd3d.quad_gather_rows = wrapper
    q = stage("vals: query geometry", lambda: model._query(geo.x, a))
    stage("vals: x2_of_theta alone",
          lambda: model.x123_of_blks(q["r"], q["th"], q["th"]))
    ei = stage("convert", lambda: model.convert(fv, sp))
    stage("render_rays", lambda: driver.render_rays(
        geo, fv, ei, cfg.ename, [cfg.fmin], mu0, cam.alpha, cam.beta, a,
        cfg.mbh, sp, iname="formal"))
    print("stages (ms): " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in stages.items()))
    tbl, idx, w, nc, nf = frame_args[0]
    frame_times = check_rows(qg, "snapshot R=4 f64, frame's rows", tbl, idx,
                             w, nc, nf)
    del geo, fv, ei, q, frame_args, tbl, idx, w

    # 13. slow light on a three-slice series
    base = {k: v[0] for k, v in model.f.items()}

    def scaled(fac):
        arrs = {k: v * fac if k in ("rho", "p") else v
                for k, v in base.items()}
        for k in ("b0", "br", "bth", "bph"):
            arrs[k] = base[k] * fac ** 0.5
        return arrs

    def series(facs):
        model._store(base)
        for fac in facs:
            model.append_slice(scaled(fac))
        model.tstep, model.toffset = 20.0, -20.0 * len(facs)

    slow_kw = dict(kw, nload=3)
    series([1.0, 1.0])
    same = Grtrans(**slow_kw).run(model=model)
    rel = np.abs(same.ivals - x.ivals).sum() / np.abs(x.ivals).sum()
    print(f"slow light on three identical slices vs fast light: rel L1 "
          f"{rel:.3e} (bar 1e-10)")
    if not rel <= 1e-10:
        raise AssertionError(f"slow light on identical slices differs from "
                             f"fast light by {rel}")
    series([1.5, 2.0])
    slow, _ = counted_run(qg, dev, "HARM3D slow light, 3 slices", slow_kw,
                          model=model)
    slow_counts = counted_run.counts
    if slow_counts["quad_gather_rows"] != 1 or slow_counts["rows_tiled"] != 1:
        raise AssertionError(f"slow-light frame launches {slow_counts}: "
                             "expected one launch of the tiled kernel")
    table, _ = model._stacked_fields()
    print(f"slow-light table {tuple(table.shape)}, "
          f"{table.numel() * 8 / 1e6:.0f} MB")
    del table
    # the slow-light frame's own index stream (R = 8)
    frame_args = []
    grmhd3d.quad_gather_rows = keep
    try:
        Grtrans(**slow_kw).run(model=model)
    finally:
        grmhd3d.quad_gather_rows = wrapper
    tbl, idx, w, nc, nf = frame_args[0]
    slow_times = check_rows(qg, "three slices R=8 f64, slow-light frame's "
                            "rows", tbl, idx, w, nc, nf)
    del frame_args, tbl, idx, w
    # the direction of the lag, on a camera whose rays all turn well inside
    # the trace's start: camera_delay (here as in grtrans_tpu) is off by the
    # camera's distance for the few corner rays of the 30 M camera that
    # turn within 1.4 uout, and their delay is the minimum the others are
    # measured from, which pushes every other sample past the oldest slice
    narrow = dict(kw, gridvals=(-13.0, 13.0, -13.0, 13.0))
    lag = Grtrans(**dict(narrow, nload=3)).run(model=model)
    model._store(base)
    oldest = Grtrans(**narrow).run(model=model)
    model._store(scaled(2.0))
    newest = Grtrans(**narrow).run(model=model)
    fluxes = (oldest.spec[0, 0], lag.spec[0, 0], newest.spec[0, 0])
    print(f"30 M camera: fast light {flux_fast:.6e}, slow light "
          f"{slow.spec[0, 0]:.6e} (cgs); 26 M camera: oldest slice "
          f"{fluxes[0]:.6e} < slow light {fluxes[1]:.6e} < newest slice "
          f"{fluxes[2]:.6e}; slow / oldest {fluxes[1] / fluxes[0]:.4f}")
    if not (flux_fast < slow.spec[0, 0]
            and fluxes[0] * 1.01 < fluxes[1] < fluxes[2] * 0.99):
        raise AssertionError(f"slow light does not lag the growing source: "
                             f"{fluxes}")
    # the 30 M camera's delays: its corner rays turn within 1.4 uout of the
    # trace's start, where grtrans_tpu's delay is short by the camera's
    # distance; here every ray lies within a few hundred M of the others
    cam = camera.make_camera(a, mu0, *cfg.gridvals, NN[0], NN[1], device=dev)
    ray = (a, mu0, cam.alpha, cam.beta, cam.l, cam.q2, cam.sm, cam.u0,
           cfg.uout)
    delay = geokerr.camera_delay(*ray)
    cpu = geokerr.camera_delay(*(v.cpu() if torch.is_tensor(v) else v
                                 for v in ray))
    spread = (delay.max() - delay.min()).item()
    rel = ((delay.cpu() - cpu).abs() / cpu).max().item()
    print(f"camera_delay, 30 M camera: {delay.numel()} rays held, "
          f"{delay.min().item():.6f} .. {delay.max().item():.6f} M (spread "
          f"{spread:.3f} M); card vs CPU max rel {rel:.3e} (bar 1e-12)")
    if not (spread < 500.0 and delay.min().item() > 1.0e7 and rel <= 1e-12):
        raise AssertionError(f"camera_delay: spread {spread} M, min "
                             f"{delay.min().item()}, card vs CPU {rel}")
    model._store(base)
    return fast_counts, slow_counts, frame_times, slow_times, model, x.ivals


def snapshot_card_vs_cpu_phase():
    """Phase 14: every snapshot family at 16x16 x 64, the card against the
    port's CPU run."""
    from grtrans_tpu_torch.api import Grtrans
    from grtrans_tpu_torch.testing import grmhd_dump as gd

    nn = (16, 16, 64)
    bins = dict(nrelbin=3, relgammamin=10.0, relgammamax=1e4)
    cases = {
        "HARM3D": (gd.harm3d_dump(seed=SEED), {}, {}),
        "IHARM (MMKS)": (gd.iharm_dump(metric=1, seed=SEED), {},
                         dict(mdotmin=1e18, mdotmax=1e18)),
        "THICKDISK": (gd.thickdisk_dump(seed=SEED), {}, {}),
        "KORAL3D + SYNCHBIN": (gd.koral_dump(48, 24, 12, nrelbin=3,
                                             seed=SEED), bins,
                               dict(ename="SYNCHBIN", mdotmin=1e8,
                                    mdotmax=1e8)),
        "HARM": (gd.harm_dump(seed=SEED), {}, {}),
        "HARMPI (BL=3)": (gd.harmpi_dump(bl=3, seed=SEED), {},
                          dict(mdotmin=1e18, mdotmax=1e18)),
    }
    for name, (dump, fargs, change) in cases.items():
        kw = snapshot_kwargs(name.split()[0], nn,
                             fargs=dict(dump=dump, **fargs), **change)
        gpu = Grtrans(**kw).run().ivals
        cpu = Grtrans(**kw).run(device="cpu").ivals
        rel = np.abs(gpu - cpu).sum() / np.abs(cpu).sum()
        print(f"{name} 16x16x64: card vs CPU rel L1 {rel:.3e} (bar "
              f"{CPU_GPU_RTOL}); I max {cpu[:, 0].max():.3e}")
        if not (rel <= CPU_GPU_RTOL and cpu[:, 0].max() > 0):
            raise AssertionError(f"{name}: card vs CPU rel L1 {rel}")


def harm2d_phase(dev, qg):
    """Phase 15: a HARM 2-D snapshot frame at full width.  Returns (counts
    of the counted frame, times of quad_gather on its index stream)."""
    from grtrans_tpu_torch import constants as pc
    from grtrans_tpu_torch.api import Grtrans
    from grtrans_tpu_torch.fluid import harm
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.testing import grmhd_dump

    t0 = time.perf_counter()
    dump = grmhd_dump.harm_dump(*HARM2D_NX, seed=SEED)
    t1 = time.perf_counter()
    model = load_fluid_model("HARM", device=dev, dump=dump)
    torch.cuda.synchronize()
    print(f"HARM 2-D snapshot {HARM2D_NX}: synthetic dump {t1 - t0:.1f} s "
          f"on the host, load + pack {time.perf_counter() - t1:.1f} s; table "
          f"{tuple(model.fquad.shape)} {model.fquad.dtype}, "
          f"{model.fquad.numel() * 8 / 1e6:.1f} MB")
    del dump
    kw = snapshot_kwargs("HARM", NN)
    x, _ = counted_run(qg, dev, "HARM 2-D snapshot", kw, model=model)
    counts = counted_run.counts
    if counts["tiled"] < 1:
        raise AssertionError(f"HARM 2-D frame launches {counts}: the tiled "
                             "quad_gather kernel never ran")
    I = x.ivals[:, 0, 0]
    if x.ivals.shape != (NN[0] * NN[1], 4, 1) or not (I >= 0).all() \
            or I.max() <= 0:
        raise AssertionError(f"bad HARM 2-D image {x.ivals.shape}, I min "
                             f"{I.min()}")
    jy = x.spec[0, 0] * pc.lbh(kw["mbh"]) ** 2 / SGRA_DISTANCE_CM ** 2 * 1e23
    print(f"HARM 2-D: I max {I.max():.6e}, total flux {x.spec[0, 0]:.6e} cgs "
          f"= {jy:.4f} Jy at Sgr A* (mdot {SNAPSHOT_MDOT:g} g/s), LP {x.lp}")
    # the frame's own index stream
    frame_args = []
    wrapper = harm.bilinear_packed

    def keep(table, n2, nf, *cells):
        frame_args.append((table, *qg.bilinear_operands(n2, *cells), 4, nf))
        return wrapper(table, n2, nf, *cells)

    harm.bilinear_packed = keep
    try:
        Grtrans(**kw).run(model=model)
    finally:
        harm.bilinear_packed = wrapper
    table, idx, w, nc, nf = frame_args[0]
    print(f"HARM 2-D frame index stream: {idx.numel()} queries, "
          f"{idx.unique().numel()} distinct rows of {table.shape[0]}")
    err = compare_gather(qg, "harm 2-D 288x128 f64, frame's rows", table,
                         idx, w, nc, nf)
    return counts, dict(time_gather(qg, "harm 2-D 288x128 f64, frame's rows",
                                    table, idx, w, nc, nf), max_abs_err=err)


def file_phases(dev, qg):
    """Phases 16-18: the flagship run from files through the command line
    (a process of its own to FITS, then main() in this process to the
    reference binary, counted), through gdfile bundles, and one pixel
    through geodebug.  Returns {path: counts}."""
    from grtrans_tpu_torch import convert
    from grtrans_tpu_torch.__main__ import main as cli_main
    from grtrans_tpu_torch.api import Grtrans
    from grtrans_tpu_torch.fluid import ffjet
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.geodesics import cache, camera, geokerr
    from grtrans_tpu_torch.io import binio, fitsio, namelist
    from grtrans_tpu_torch.orchestrator import grtrans_run
    from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump
    from grtrans_tpu_torch.tools import geodebug

    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dfile = tmp / "ffjet.bin"
        write_ffjet_dump(dfile, nx=FFJET_NX, seed=SEED)
        cfg = flagship_config(GrtransConfig, dfile, NN)
        npix = NN[0] * NN[1]
        ref = Grtrans()
        ref.cfg = cfg
        ref.run(device=dev)
        want = ref.ivals[:, :, 0].astype(np.float32)

        # 16. the command line: namelists written, a process of its own
        namelist.write_inputs(cfg, tmp / "inputs.in")
        namelist.write_files_in(tmp / "inputs.in", tmp / "cams.fits",
                                tmp / "files.in")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "grtrans_tpu_torch", str(tmp / "files.in")],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=600)
        cold_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"python -m grtrans_tpu_torch failed:\n"
                                 f"{proc.stderr[-3000:]}")
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cli_main([str(tmp / "files.in"), "--output", str(tmp / "cams.bin")])
        warm_s = time.perf_counter() - t0
        paths["cli_flagship"] = read_counts()
        cli_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        _, fits_cams, fits_keys = fitsio.read_fits(tmp / "cams.fits")
        _, bin_cams, bin_keys = binio.read_camera_bin(tmp / "cams.bin")
        got = {"FITS": fits_cams[0].reshape(4, npix).T, "binary": bin_cams[0]}
        for name, cam in got.items():
            tol = 1e-6 * np.abs(want)
            if cam.shape != want.shape or not (np.abs(cam - want)
                                               <= tol).all():
                raise AssertionError(f"CLI {name} file differs from the "
                                     "in-process render")
        if abs(fits_keys[0][0] / cfg.fmin - 1.0) > 1e-12 \
                or abs(bin_keys[0][0] / cfg.fmin - 1.0) > 1e-6:
            raise AssertionError(f"CLI keys {fits_keys[0]}, {bin_keys[0]}")
        print(f"CLI {NN[0]}x{NN[1]}x{NN[2]}: python -m grtrans_tpu_torch "
              f"(cold process, to FITS) {cold_s:.3f} s; main() in process "
              f"(to the binary) {warm_s * 1e3:.1f} ms, peak memory "
              f"{cli_peak:.3f} GiB, launches "
              f"{paths['cli_flagship']}; both files equal float32 of the "
              f"render; the process said: "
              f"{proc.stdout.strip().splitlines()[0]}")

        # 17. gdfile: trace and save, then load and render
        model = convert.ffjet_from_arrays(*ffjet.load_ffjet_file(dfile), dev)
        gd = tmp / "geo.npz"
        walls, peaks = {}, {}
        images = []
        for step in ("trace_save", "load"):
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            ivals, _, _ = grtrans_run(cfg, model, device=dev, gdfile=str(gd))
            torch.cuda.synchronize()
            walls[step] = time.perf_counter() - t0
            peaks[step] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            paths[f"gdfile_{step}"] = read_counts()
            images.append(ivals)
        plain, _, _ = grtrans_run(cfg, model, device=dev)
        if not torch.equal(images[0], images[1]):
            raise AssertionError("gdfile: the loaded bundle renders another "
                                 "image than the traced one")
        rel = ((images[1] - plain).abs().sum() / plain.abs().sum()).item()
        if not rel <= 1e-12:
            raise AssertionError(f"gdfile image vs plain run: rel L1 {rel}")
        size = gd.stat().st_size
        cam = camera.make_camera(0.998, 0.906, *cfg.gridvals, NN[0], NN[1],
                                 device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        geo = geokerr.trace(0.998, 0.906, cam.alpha, cam.beta, cam.l, cam.q2,
                            cam.sm, cam.u0, NN[2], uout=cfg.uout,
                            phi0=cfg.phi0)
        torch.cuda.synchronize()
        trace_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cache.save_bundle(tmp / "again.npz", geo)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = cache.load_bundle(tmp / "again.npz", device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if not all(torch.equal(x, y) for x, y in zip(geo, back)):
            raise AssertionError("gdfile: a bundle does not load as saved")
        print(f"gdfile {NN[0]}x{NN[1]}x{NN[2]}: run that traces and saves "
              f"{walls['trace_save']:.3f} s (peak memory "
              f"{peaks['trace_save']:.3f} GiB), run that loads "
              f"{walls['load']:.3f} s ({peaks['load']:.3f} GiB; launches "
              f"{paths['gdfile_load']}); "
              f"bundle {size / 1e6:.1f} MB on disk; save_bundle "
              f"{save_s:.3f} s, load_bundle {load_s:.3f} s, against "
              f"geokerr.trace {trace_s * 1e3:.1f} ms on a plain run; "
              f"images equal, rel L1 vs plain {rel:.3e}")
        del geo, back, images
        gd.unlink()
        (tmp / "again.npz").unlink()

        # 18. one pixel through geodebug, re-integrated on the card
        pixel = int(np.argmax(ref.ivals[:, 0, 0])) + 1
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        dump = geodebug.dump_ray(cfg, pixel, tmp / "ray.npz", model=model,
                                 device=dev)
        dump_s = time.perf_counter() - t0
        paths["geodebug_ray"] = read_counts()
        dump_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        again = geodebug.reintegrate(geodebug.load(tmp / "ray.npz"), 0,
                                     device=dev)[0]
        full = ref.ivals[pixel - 1, :, 0]
        err = np.abs(again - full).max() / np.abs(full).max()
        print(f"geodebug pixel {pixel}: dump_ray {dump_s * 1e3:.1f} ms, "
              f"peak memory {dump_peak:.3f} GiB, launches "
              f"{paths['geodebug_ray']}; {len(dump)} arrays, re-integrated "
              f"I {again[0]:.9e} vs the image's {full[0]:.9e}, max rel "
              f"{err:.3e} (bar 1e-10)")
        if not err <= 1e-10:
            raise AssertionError(f"geodebug re-integration off by {err}")
    return paths


def pgriter_phase(dev, qg, model):
    """Phase 19: a secant fit of mdot to a flux on the full-size HARM3D
    snapshot, the model loaded once (by the snapshot phase).  Returns the
    counts of the fit."""
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid import base
    from grtrans_tpu_torch.tools import pgriter

    cfg = GrtransConfig(**snapshot_kwargs("HARM3D", NN))
    target, _ = pgriter.flux_at(cfg, 6e13, model=model, device=dev)
    walls = []
    real_flux_at, real_factory = pgriter.flux_at, base._REGISTRY["HARM3D"]
    loads = []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real_flux_at(*args, **kw)
        walls.append(time.perf_counter() - t0)
        return out

    pgriter.flux_at = timed
    base._REGISTRY["HARM3D"] = lambda **kw: loads.append(1) or \
        real_factory(**kw)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        fitted, flux, hist = pgriter.fit_flux(cfg, target, 4e13, model=model,
                                              device=dev)
    finally:
        pgriter.flux_at = real_flux_at
        base._REGISTRY["HARM3D"] = real_factory
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"pgriter HARM3D {NN[0]}x{NN[1]}x{NN[2]}: mdot {fitted:.9e} g/s "
          f"(target's 6e13) in {len(hist)} renders, flux {flux:.9e} vs "
          f"{target:.9e}; walls (s) {[round(w, 3) for w in walls]}; peak "
          f"memory {peak:.3f} GiB; "
          f"launches {counts}; snapshot loads during the fit {len(loads)}")
    if not (abs(np.log(flux / target)) < 1e-3 and not loads
            and counts["quad_gather_rows"] == len(hist)):
        raise AssertionError(f"pgriter: flux {flux} vs {target}, loads "
                             f"{len(loads)}, counts {counts}")
    return counts


class SlabSampled:
    """A snapshot model whose vals() samples its stacked grid cut into S
    theta slabs, each with the row after it, on this one card: the
    columns of each slab by grmhd3d.slab_sample (one quad_gather_rows
    launch), summed; every other attribute is the model's."""

    def __init__(self, model, slabs):
        from grtrans_tpu_torch.fluid import grmhd3d
        grid, self.names = model.stacked_grid()
        nx2 = grid.shape[2]
        self.model, self.B = model, nx2 // slabs
        self.tables = [grmhd3d.slab_table(
            grid[:, :, lo:lo + self.B], grid[:, :, min(lo + self.B, nx2 - 1)])
            for lo in range(0, nx2, self.B)]

    def __getattr__(self, name):
        return getattr(self.model, name)

    def columns(self, q):
        from grtrans_tpu_torch.fluid import grmhd3d
        return sum(grmhd3d.slab_sample(self.model, q, table, s * self.B,
                                       self.B)
                   for s, table in enumerate(self.tables))

    def vals(self, x, k, a, time=0.0):
        q = self.model._query(x, a, time=time)
        return self.model._assemble(self.columns(q), self.names, q, a)


def max_rel_finite(ours, ref):
    """max|ours - ref| / max|ref| over the finite entries of ref, which
    must be those of ours."""
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(ours), fin):
        raise AssertionError("finite in one and not in the other")
    return ((ours - ref)[fin].abs().max() / ref[fin].abs().max()).item()


def mesh_phase(dev, qg, flagship, model, snapshot_image, whole_rows):
    """Phase 20: the multi-GPU paths on this one card.  Returns (counts of
    the flagship under the mesh, counts of the frame through the virtual
    slabs, the per-slab kernel times)."""
    import torch.distributed as dist

    from grtrans_tpu_torch.api import Grtrans
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid import grmhd3d
    from grtrans_tpu_torch.geodesics import camera, geokerr
    from grtrans_tpu_torch.orchestrator import grtrans_run
    from grtrans_tpu_torch.parallel import sharding

    # (a) the flagship through grtrans_run(mesh=): a world of one over NCCL
    t0 = time.perf_counter()
    mesh = sharding.pixel_mesh(device_type=dev.type)
    print(f"mesh {mesh} over {dist.get_backend(mesh.get_group(0))} in "
          f"{time.perf_counter() - t0:.2f} s")
    try:
        cfg, tmodel = flagship["cfg"], flagship["model"]
        reset_counts()
        ivals, _, _ = grtrans_run(cfg, tmodel, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        mesh_counts = read_counts()
        ref = flagship["ivals"]
        rel = ((ivals - ref).abs().sum() / ref.abs().sum()).item()
        t0 = time.perf_counter()
        grtrans_run(cfg, tmodel, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        print(f"FFJET {NN[0]}x{NN[1]}x{NN[2]} f64 through grtrans_run(mesh=) "
              f"on a world of one: rel L1 against phase 4 {rel:.3e} (bar "
              f"1e-12); launches {mesh_counts}; warm frame {warm:.1f} ms "
              f"(phase 4: {flagship['warm_ms']:.1f} ms)")
        if not (rel <= 1e-12 and mesh_counts["quad_gather"] > 0):
            raise AssertionError(f"mesh flagship: rel L1 {rel}, launches "
                                 f"{mesh_counts}")

        # (b) the snapshot of phase 12 on S virtual theta slabs
        slabs = SlabSampled(model, MESH_SLABS)
        kw = snapshot_kwargs("HARM3D", NN)
        gcfg = GrtransConfig(**kw)
        a, mu0 = gcfg.spin, gcfg.mumin
        cam = camera.make_camera(a, mu0, *gcfg.gridvals, NN[0], NN[1],
                                 device=dev)
        geo = geokerr.trace(a, mu0, cam.alpha, cam.beta, cam.l, cam.q2,
                            cam.sm, cam.u0, NN[2], uout=gcfg.uout,
                            phi0=gcfg.phi0)
        q = model._query(geo.x, a)
        table, names = model._stacked_fields()
        nx2, nx3 = model.uniqx2.shape[0], model.uniqx3.shape[0]
        whole = model._gather_cols(table, table.shape[0], nx2, nx3, q,
                                   len(names))
        rel_cols = max_rel_finite(slabs.columns(q), whole)
        print(f"HARM3D {tuple(table.shape)} on {MESH_SLABS} slabs of "
              f"{slabs.B} theta rows and a halo row "
              f"({tuple(slabs.tables[0].shape)} each): summed slab columns "
              f"against the whole gather max rel {rel_cols:.3e} (bar "
              f"{ROWS_TOL[torch.float64]:g})")
        if not rel_cols <= ROWS_TOL[torch.float64]:
            raise AssertionError(f"slab columns: {rel_cols}")
        reset_counts()
        x = Grtrans(**kw).run(model=slabs)
        slab_counts = read_counts()
        rel = (np.abs(x.ivals - snapshot_image).sum()
               / np.abs(snapshot_image).sum())
        t0 = time.perf_counter()
        Grtrans(**kw).run(model=slabs)
        warm = (time.perf_counter() - t0) * 1e3
        print(f"HARM3D {NN[0]}x{NN[1]}x{NN[2]} through the slabs: rel L1 "
              f"against phase 12 {rel:.3e} (bar 1e-12); launches "
              f"{slab_counts}; warm frame {warm:.1f} ms")
        if not (rel <= 1e-12
                and slab_counts["quad_gather_rows"] == MESH_SLABS):
            raise AssertionError(f"slab render: rel L1 {rel}, launches "
                                 f"{slab_counts}")
        # each slab's launch on this frame's queries, beside the whole
        # table's (phase 12)
        frame_args = []
        wrapper = grmhd3d.quad_gather_rows

        def keep(*args):
            frame_args.append(args)
            return wrapper(*args)

        grmhd3d.quad_gather_rows = keep
        try:
            slabs.columns(q)
        finally:
            grmhd3d.quad_gather_rows = wrapper
        per_slab = []
        for s, (tbl, idx, w, nc, nf) in enumerate(frame_args):
            t = check_rows(qg, f"slab {s} of {MESH_SLABS}, the HARM3D frame's "
                           "queries", tbl, idx, w, nc, nf)
            per_slab.append({k: t[k] for k in ("kernel", "plain", "library",
                                               "bound_ms", "bound_by",
                                               "max_abs_err")})
        print(f"per-slab quad_gather_rows ms "
              + ", ".join(f"{t['kernel']:.4f} (bound {t['bound_ms']:.4f})"
                          for t in per_slab)
              + f"; the whole table {whole_rows['kernel']:.4f} (bound "
              f"{whole_rows['bound_ms']:.4f})")
        del frame_args, slabs, whole

        # (c) sample_sharded on the world of one: the slab is the grid
        grid, _ = model.stacked_grid()
        fv = grmhd3d.sample_sharded(model, geo.x, a, grid, mesh)
        ref = model.vals(geo.x, geo.k, a)
        rel = max(max_rel_finite(getattr(fv, f), getattr(ref, f))
                  for f in ("rho", "p", "bmag", "u", "b"))
        print(f"sample_sharded on a world of one against vals: max rel "
              f"{rel:.3e} (bar {ROWS_TOL[torch.float64]:g})")
        if not rel <= ROWS_TOL[torch.float64]:
            raise AssertionError(f"sample_sharded: {rel}")

        # (d) dry-run part (c): the gradient of a SARIAF render's total
        # flux with respect to (n0, t0), the block's backward pass and one
        # all_reduce, against the gradient without a mesh
        from grtrans_tpu_torch.parallel import dryrun
        t0 = time.perf_counter()
        ours = dryrun.check_gradient(dev, mesh, 1, None).cpu()
        wall = time.perf_counter() - t0
        ref = dryrun.check_gradient(dev, None, 1, None).cpu()
        err = dryrun.max_rel_each(ours, ref)
        print(f"dry-run part (c) on a world of one: (loss, d/dn0, d/dt0) "
              f"{ours.tolist()}, max rel against no mesh {err:.3e} (bar "
              f"{dryrun.GRAD_RTOL}), {wall * 1e3:.1f} ms")
        if not (torch.isfinite(ours).all() and err <= dryrun.GRAD_RTOL):
            raise AssertionError(f"sharded gradient: {err}")
    finally:
        dist.destroy_process_group()
    return mesh_counts, slab_counts, dict(
        whole_ms=whole_rows["kernel"], whole_bound_ms=whole_rows["bound_ms"],
        per_slab=per_slab)


GRAD_FD_STEPS = {"spin": 1e-4, "mu0": 1e-5}   # tests/test_torch_gradients.py
GRAD_FD_RTOL = 1e-2                   # card gradient vs central differences
# card gradient vs the port's CPU one.  Not 1e-8: a ray near the shadow has
# features a few 1e-7 wide in (spin, mu0), and where rounding moves one
# across the point the gradient takes the feature's slope, so the total
# moves with the rounding: on one CPU by up to 3.5e-7 between batches of 1
# and of 256 pixels (PyTorch's vectorised exp and log round a vector's
# tail differently), by 2.4e-4 between two CPUs (PyTorch 2.13 and 2.11),
# by 5.9e-5 between the card and its host's CPU at the flagship point
# (my CPU and chip runs)
GRAD_CPU_RTOL = 1e-3
GRAD_NN = (16, 16, 64)                # the card-vs-CPU gradient camera
# path (a) starts its rays where the flagship frame does (flagship_config):
# from the camera's own u0 = 2e-9 (r = 5e8, fwdbwd_bench's start) the
# affine parameter's prefix sum rounds at ~1e-7, and a ray's image moves in
# steps of ~1e-3 of itself each 2e-7 of mu0 (my CPU runs), which no secant
# can hold a gradient against
FLAGSHIP_UOUT = 0.01


def bwd_bound_ms(idx, nc, nf, dtype):
    """Least time for one backward of the weights: index, output gradient
    and dw once and every distinct row once over the memory rate, against
    2 R nc nf operations a query over the peak rate."""
    n = idx.shape[0]
    r = idx.numel() // n
    size = torch.finfo(dtype).bits // 8
    distinct = idx.unique().numel()
    nbytes = n * r * 4 + n * nf * size + n * r * nc * size \
        + distinct * nc * nf * size
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * n * r * nc * nf / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), distinct


# the backward wrappers, their first design's name and the read_counts key
# of each kernel
BWD = {"quad_gather_bwd_w": ("generic", "bwd_"),
       "quad_gather_rows_bwd_w": ("simple", "rows_bwd_")}


def off_16(t):
    """A contiguous copy of t one element past 16 bytes: an operand that
    the pickers send to the first design."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def bwd_picked(qg, table, idx, g, nc, nf):
    """(wrapper name, the kernel its picker sends these operands to)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (table, g))
    if idx.dim() == 2:
        return "quad_gather_rows_bwd_w", qg.rows_bwd_kernel(
            idx.shape[1], nc, nf, table.element_size(), aligned)
    return "quad_gather_bwd_w", qg.bwd_kernel(nc, nf, aligned)


def check_bwd(qg, name, table, idx, g, nc, nf, reps=10):
    """The weights' backward against its plain twin on the card: the
    kernel the wrapper picks and the first design (generic / simple, g
    copied off 16 bytes), each within KERNEL_TOL of max|twin|, no
    out-of-range flag, and the two within KERNEL_TOL of each other (both
    sum the fields in one order); then CUDA event times of the picked one
    in the order plain, library, kernel, kernel, library, plain.  The library yardstick is the backward
    of embedding_bag(..., per_sample_weights=w, mode="sum") with respect to
    w (the forward left out: its graph is kept and its backward replayed).
    Returns the dict of mean times, the bound, max_abs_err (the picked
    kernel's), first_max_abs_err and the picked kernel's name."""
    wrapper, picked = bwd_picked(qg, table, idx, g, nc, nf)
    first, _ = BWD[wrapper]
    rows = wrapper == "quad_gather_rows_bwd_w"
    kern = getattr(qg, wrapper)
    twin = getattr(qg, wrapper + "_ref")
    n, ns = idx.shape[0], table.shape[0]
    r = idx.shape[1] if rows else 1
    ref = twin(table, idx, g, nc, nf)
    scale = ref.abs().max().item()
    tol = KERNEL_TOL[table.dtype]

    def kernel():
        return kern(table, idx, g, nc, nf)

    out = kernel()
    err = (out - ref).abs().max().item()
    if qg.error_flag(table.device).item() != 0:
        raise AssertionError(f"{name}: out-of-range flag set")
    # the first design on the same operands, reached with g off 16 bytes
    counter = f"{wrapper}.launches.{first}"
    before = obs.counters()[counter]
    first_out = kern(table, idx, off_16(g), nc, nf)
    torch.cuda.synchronize()
    if obs.counters()[counter] != before + 1:
        raise AssertionError(f"{name}: g off 16 bytes did not go to the "
                             f"{first} kernel")
    first_err = (first_out - ref).abs().max().item()
    apart = (out - first_out).abs().max().item()
    del out, first_out
    print(f"{name}: max|{picked} - plain| {err:.3e}, max|{first} - plain| "
          f"{first_err:.3e}, max|{picked} - {first}| {apart:.3e} "
          f"(max|plain| {scale:.3e}, bar {tol:g} of it)")
    if not max(err, first_err, apart) <= tol * scale:
        raise AssertionError(f"{name}: {err}, {first_err}, {apart} > {tol} "
                             f"* {scale}")
    if qg.error_flag(table.device).item() != 0:
        raise AssertionError(f"{name}: out-of-range flag set ({first})")
    bag_idx = (idx.long().reshape(n, r, 1) * nc
               + torch.arange(nc, device=idx.device)).reshape(n, r * nc)
    w = torch.ones((n, r * nc), dtype=table.dtype, device=table.device,
                   requires_grad=True)
    bag = torch.nn.functional.embedding_bag(
        bag_idx, table.view(ns * nc, nf), per_sample_weights=w, mode="sum")
    lib = torch.autograd.grad(bag, w, g, retain_graph=True)[0]
    lib_err = (lib.view_as(ref) - ref).abs().max().item()
    del lib, ref

    def plain():
        return twin(table, idx, g, nc, nf)

    def library():
        return torch.autograd.grad(bag, w, g, retain_graph=True)

    order = [plain, library, kernel]
    times = {}
    for fn in order + order[::-1]:
        times.setdefault(fn.__name__, []).append(cuda_ms(fn, reps=reps))
    bound, bound_by, distinct = bwd_bound_ms(idx, nc, nf, table.dtype)
    res = {k: sum(v) / len(v) for k, v in times.items()}
    res.update(bound_ms=bound, bound_by=bound_by, max_abs_err=err,
               first_max_abs_err=first_err, picked=picked, queries=n,
               distinct_rows=distinct)
    print(f"{name}: N={n} R={r} table=({ns}, {nc * nf}) {table.dtype}, "
          f"{distinct} distinct rows: ms "
          + "; ".join(f"{picked if k == 'kernel' else k} "
                      + "/".join(f"{t:.4f}" for t in v)
                      for k, v in times.items())
          + f" (library: embedding_bag's backward); bound {bound:.4f} ms by "
          f"{bound_by}; share of bound {bound / res['kernel']:.3f} (the "
          f"wrapper picks {picked}); max|embedding_bag - plain| "
          f"{lib_err:.2e}")
    del bag, w
    return res


def bwd_flag_check(qg, name, table, idx, g, nc, nf):
    """An out-of-range row in query 1: the flag set, NaN in that query's
    dw and in no other, on the picked kernel and on the first design (g
    off 16 bytes)."""
    wrapper, picked = bwd_picked(qg, table, idx, g, nc, nf)
    first, _ = BWD[wrapper]
    kern = getattr(qg, wrapper)
    bad = idx[:300].clone()
    bad.view(300, -1)[1, -1] = table.shape[0]
    flag = qg.error_flag(table.device)
    for kernel, g300 in ((picked, g[:300].contiguous()),
                         (first, off_16(g[:300]))):
        if bwd_picked(qg, table, bad, g300, nc, nf)[1] != kernel:
            raise AssertionError(f"{name}: {kernel} not picked")
        dw = kern(table, bad, g300, nc, nf)
        torch.cuda.synchronize()
        if flag.item() != 1 or not torch.isnan(dw[1]).all() \
                or torch.isnan(dw[[0, *range(2, 300)]]).any():
            raise AssertionError(f"{name} {kernel}: out-of-range row not "
                                 "flagged")
        flag.zero_()
    print(f"{name}: out-of-range row flagged, its dw NaN ({picked} and "
          f"{first})")


BWD_SHAPES = (   # name, rows, R (None: quad_gather_bwd_w), nc, nf, dtype
    ("quad_gather_bwd_w", FFJET_NX ** 2, None, 4, 9, torch.float64),
    ("quad_gather_bwd_w f32", FFJET_NX ** 2, None, 4, 9, torch.float32),
    ("quad_gather_bwd_w polsynchpl", 201, None, 2, 6, torch.float64),
    ("quad_gather_rows_bwd_w", int(np.prod(SNAPSHOT_NX)), 4, 2, 10,
     torch.float64))


def bwd_kernel_phase(dev, qg):
    """Phase 21 (a): both backward kernels against their twins at the
    shapes of the gradient paths (uniformly random rows, N = 4e6): FFJET
    (16384, 4 x 9) in f64 and f32, the POLSYNCHPL cutoff table (201, 2 x
    6) and the snapshot's phi-pair-packed table (4,718,592, 2 x 10), R =
    4; each the picked kernel; the out-of-range flag of it and of the
    first design; a table that requires a gradient refused."""
    rng = np.random.default_rng(SEED + 21)
    out = {}
    for name, ns, r, nc, nf, dtype in BWD_SHAPES:
        shape = (N_QUERIES,) if r is None else (N_QUERIES, r)
        table = torch.as_tensor(rng.standard_normal((ns, nc * nf)),
                                dtype=dtype, device=dev)
        idx = torch.as_tensor(rng.integers(0, ns, shape), dtype=torch.int32,
                              device=dev)
        g = torch.as_tensor(rng.standard_normal((N_QUERIES, nf)),
                            dtype=dtype, device=dev)
        label = f"{name}{'' if dtype == torch.float32 else ' f64'}, " \
            "random rows"
        out[name] = check_bwd(qg, label, table, idx, g, nc, nf)
        bwd_flag_check(qg, label, table, idx, g, nc, nf)
        table.requires_grad_()
        w = torch.ones(shape + (nc,), dtype=table.dtype, device=dev)
        fwd = qg.quad_gather if r is None else qg.quad_gather_rows
        try:
            fwd(table, idx, w, nc, nf)
        except NotImplementedError as e:
            print(f"{name}: a table that requires a gradient refused ({e})")
        else:
            raise AssertionError("a table that requires grad was gathered")
        del table, idx, g, w
    torch.cuda.empty_cache()
    return out


def capture_bwd(qg, run):
    """run() with the two backward wrappers wrapped so that each launch's
    operands are kept (as phase 12 keeps the frame's rows).  Returns the
    list of (wrapper name, operands).  The counts of a pass are read from
    another, counted pass."""
    kept = []
    originals = {name: getattr(qg, name) for name in BWD}

    def wrap(name, fn):
        def keep(*args, **kw):
            kept.append((name, args))
            return fn(*args, **kw)
        return keep

    for name, fn in originals.items():
        setattr(qg, name, wrap(name, fn))
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(qg, name, fn)
    return kept


def check_picked(qg, name, kept, counts):
    """Every backward launch of one pass (the operands `kept` of a captured
    pass, the launch counts of a counted one) went to the kernel its picker
    chose for those operands, and no twin ran."""
    expected = dict.fromkeys(("bwd_tiled", "bwd_generic", "rows_bwd_tiled",
                              "rows_bwd_simple"), 0)
    for _, args in kept:
        wrapper, picked = bwd_picked(qg, *args)
        expected[BWD[wrapper][1] + picked] += 1
    got = {k: counts[k] for k in expected}
    print(f"{name}: backward launches by kernel {got}, picked {expected}; "
          f"twin calls {counts['twin_calls']}")
    if got != expected or counts["twin_calls"]:
        raise AssertionError(f"{name}: backward launches {got}, the pickers "
                             f"chose {expected}; twin calls "
                             f"{counts['twin_calls']}")


def bwd_stream_phase(qg, streams):
    """Phase 21 (b): the backward kernels on the gradient paths' own index
    streams, kept in phases 22, 23 and 27: each launch of a pass on the
    picked kernel, as check_bwd."""
    out = {}
    for path, kept in streams.items():
        for i, (wrapper, (table, idx, g, nc, nf)) in enumerate(kept):
            name = (f"{wrapper} ({table.shape[0]}, {nc}x{nf}) "
                    f"{dtype_name(table)}, {path}'s rows #{i}")
            out[name] = check_bwd(qg, name, table, idx, g, nc, nf)
    return out


def dtype_name(t):
    return "f64" if t.dtype == torch.float64 else "f32"


def chunk_for(render_loss, npix, probe=500):
    """Pixels a chunk: a probe chunk's forward and backward gives the peak
    device memory a pixel, and a chunk takes half the free memory (a
    divisor of npix).  Returns (chunk, bytes a pixel)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    render_loss((0, probe))
    torch.cuda.synchronize()
    per_px = (torch.cuda.max_memory_allocated() - base) / probe
    free = torch.cuda.mem_get_info()[0]
    fit = max(int(0.5 * free / per_px), 1)
    chunk = max(d for d in range(1, npix + 1) if npix % d == 0 and d <= fit)
    return chunk, per_px


def grad_path(qg, dev, name, prob, params):
    """d(loss)/d(params) of loss = sum|image| / (npix * 4) (the
    fwdbwd_bench loss of grtrans_tpu's scripts), the image rendered by
    InverseProblem `prob` in pixel chunks, gradients accumulated: a counted
    run (launches a chunk, with the counts set to 0 before each chunk's
    forward and read after its backward), then a warm one timed with its
    peak memory; central differences of the same loss on the card; the
    first chunk once more with the backward operands kept, every backward
    launch of the counted chunk held to the kernel its picker chose for
    them.  Returns (summed counts, a record of the path, the kept
    operands)."""
    npix = prob.npix

    def leaves():
        return {k: torch.tensor(v, dtype=torch.float64, device=dev,
                                requires_grad=True)
                for k, v in params.items()}

    def chunk_loss(p, pix):
        return prob.render(p, pix=pix).abs().sum() / (npix * 4)

    def value_and_grad(chunk, counts=None):
        p = leaves()
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for lo in range(0, npix, chunk):
            if counts is not None:
                reset_counts()
            loss = chunk_loss(p, (lo, lo + chunk))
            loss.backward()
            if counts is not None:
                torch.cuda.synchronize()
                counts.append(read_counts())
            total += loss.detach()
        return total.item(), {k: v.grad.item() for k, v in p.items()}

    chunk, per_px = chunk_for(
        lambda pix: chunk_loss(leaves(), pix).backward(), npix)
    counts = []
    t0 = time.perf_counter()
    loss, grads = value_and_grad(chunk, counts)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    loss2, grads2 = value_and_grad(chunk)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    total = {k: sum(c[k] for c in counts) for k in counts[0]}
    if total["twin_calls"] != 0:
        raise AssertionError(f"{name}: a plain twin ran on the card")
    kept = capture_bwd(qg, lambda: chunk_loss(leaves(), (0, chunk)).backward())
    check_picked(qg, name, kept, counts[0])
    if not (np.isfinite(loss) and all(np.isfinite(v)
                                      for v in grads.values())):
        raise AssertionError(f"{name}: loss {loss}, gradients {grads}")
    if grads2 != grads:
        print(f"{name}: warm rerun's gradients {grads2} (first {grads})")
    # central differences, pixel by pixel at steps h and h / 2: the render
    # has jumps (rays that switch between plunging and turning near the
    # shadow, the tau = 10 cut, the table's inner edge), and a secant
    # across one measures the jump.  The pixels whose two secants agree
    # (1e-2) are the ones where the loss is smooth over the step; the
    # gradient of the loss summed over them is held against their secants'
    # sum.  The pixels' derivatives have both signs (the spin's total is a
    # few percent of the sum of their sizes), so the difference is measured
    # against the sum of their sizes, as the error of a sum is bounded
    def pixel_losses(q):
        with torch.no_grad():
            return torch.cat([prob.render(q, pix=(lo, lo + chunk)).abs()
                              .sum(-1) / (npix * 4)
                              for lo in range(0, npix, chunk)])

    fd, rel, smooth_frac = {}, {}, {}
    for k in grads:
        h = GRAD_FD_STEPS[k]
        sec = [(pixel_losses(dict(params, **{k: params[k] + s_}))
                - pixel_losses(dict(params, **{k: params[k] - s_})))
               / (2 * s_) for s_ in (h, h / 2)]
        floor = 1e-10 * loss / (npix * h)
        smooth = (torch.isfinite(sec[0]) & torch.isfinite(sec[1])
                  & ((sec[0] - sec[1]).abs()
                     <= 1e-2 * (sec[0].abs() + sec[1].abs()) + floor))
        p = leaves()
        for lo in range(0, npix, chunk):
            img = prob.render(p, pix=(lo, lo + chunk))
            part = (img.abs().sum(-1) / (npix * 4))[smooth[lo:lo + chunk]]
            part.sum().backward()
        ad = p[k].grad.item()
        fd[k] = sec[1][smooth].sum().item()
        rel[k] = abs(ad - fd[k]) / sec[1][smooth].abs().sum().item()
        fd[k + " (rel to the total)"] = abs(ad - fd[k]) / abs(fd[k])
        smooth_frac[k] = smooth.double().mean().item()
        fd[k + " (every pixel)"] = sec[1].sum().item()
        fd[k + " (smooth pixels, autograd)"] = ad
    print(f"{name}: {prob.nn[0]}x{prob.nn[1]}x{prob.nn[2]} f64, "
          f"{npix // chunk} chunk(s) of {chunk} pixels "
          f"({per_px / 2 ** 20:.3f} MiB a pixel in the probe); loss "
          f"{loss:.12e}, gradients {grads}; central differences "
          f"{fd} (steps {GRAD_FD_STEPS} and half of them; smooth pixels "
          f"{smooth_frac}), |autograd - secants| over the sum of the smooth "
          f"pixels' |secant| {rel} (bar {GRAD_FD_RTOL}); launches a chunk "
          f"{counts[0]}; first "
          f"{first_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms, peak "
          f"{peak / 2 ** 30:.3f} GiB")
    if not all(v <= GRAD_FD_RTOL for v in rel.values()) \
            or not all(v >= 0.9 for v in smooth_frac.values()):
        raise AssertionError(f"{name}: card gradient vs FD {rel}, smooth "
                             f"pixels {smooth_frac}")
    return total, dict(chunks=npix // chunk, chunk=chunk, loss=loss,
                       grads=grads, fd=fd, fd_rel=rel,
                       smooth_pixels=smooth_frac, per_chunk=counts[0],
                       first_ms=first_s * 1e3, warm_ms=warm_s * 1e3,
                       peak_gib=peak / 2 ** 30), kept


def grad_card_vs_cpu(name, make, params, qg):
    """The gradient of the same loss at GRAD_NN on the card and on the
    CPU (one chunk each), rel GRAD_CPU_RTOL."""
    got = {}
    for where in ("cuda", "cpu"):
        prob = make(torch.device(where))
        p = {k: torch.tensor(v, dtype=torch.float64, device=prob.device,
                             requires_grad=True) for k, v in params.items()}
        loss = prob.render(p).abs().sum() / (prob.npix * 4)
        loss.backward()
        got[where] = {k: v.grad.item() for k, v in p.items()
                      if v.grad is not None}
    rel = {k: abs(got["cuda"][k] - got["cpu"][k]) / abs(got["cpu"][k])
           for k in got["cpu"]}
    print(f"{name} at {GRAD_NN}: card {got['cuda']}, CPU {got['cpu']}, "
          f"rel {rel} (bar {GRAD_CPU_RTOL})")
    if not all(v <= GRAD_CPU_RTOL for v in rel.values()):
        raise AssertionError(f"{name}: card vs CPU gradient {rel}")


def fwdbwd_phase(dev, qg):
    """Phase 22, path (a): the flagship forward and backward pass of
    grtrans_tpu's scripts/fwdbwd_bench.py: FFJET + POLSYNCHPL at
    100x100 x 400 f64 through InverseProblem(fixed=dict(ntscl=2.0,
    nrscl=70.0)), gradient with respect to (spin, mu0) at (0.9, 0.9),
    pixel chunks accumulated; rays from uout = FLAGSHIP_UOUT."""
    from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump
    from grtrans_tpu_torch.tools.invert import InverseProblem

    with tempfile.TemporaryDirectory() as tmp:
        dfile = Path(tmp) / "ffjet.bin"
        write_ffjet_dump(dfile, nx=FFJET_NX, seed=SEED)

        def make(device, nn=NN):
            return InverseProblem(
                fname="FFJET", ename="POLSYNCHPL", iname="formal",
                freq=3.45e11, mbh=3.4e9, nn=nn,
                gridvals=(-40.0, 20.0, -20.0, 40.0),
                fixed=dict(dfile=str(dfile), ntscl=2.0, nrscl=70.0),
                uout=FLAGSHIP_UOUT, device=device)

        params = dict(spin=0.9, mu0=0.9)
        counts, rec, kept = grad_path(qg, dev, "fwdbwd_ffjet", make(dev),
                                      params)
        per = rec["per_chunk"]
        if per["quad_gather_bwd_w"] < 1 or per["quad_gather_rows_bwd_w"]:
            raise AssertionError(f"fwdbwd_ffjet: launches {per}")
        grad_card_vs_cpu("fwdbwd_ffjet", lambda d: make(d, GRAD_NN), params,
                         qg)
    return counts, rec, kept


def harm3d_grad_phase(dev, qg, model):
    """Phase 23, path (b): a geometry-only gradient, d(loss)/d(mu0), on
    the HARM3D frame of phase 12 (the 288x128x128 snapshot, loaded once,
    100x100 x 400 from uout = 0.04), through quad_gather_rows and its
    backward kernel; the card against the CPU on a 32x24x16 snapshot."""
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.testing import grmhd_dump
    from grtrans_tpu_torch.tools.invert import InverseProblem

    kw = snapshot_kwargs("HARM3D", NN)

    def make(device, nn=NN, snap=None):
        return InverseProblem(
            fname="HARM3D", ename=kw["ename"], iname=kw["iname"],
            freq=kw["fmin"], mbh=kw["mbh"], nn=nn, gridvals=kw["gridvals"],
            uout=kw["uout"], fixed=dict(spin=kw["spin"]),
            source=dict(nfac=SNAPSHOT_MDOT, mdot=SNAPSHOT_MDOT,
                        mu=kw["muval"], gmin=kw["gmin"]),
            model=snap, device=device)

    counts, rec, kept = grad_path(qg, dev, "grad_harm3d",
                                  make(dev, snap=model), dict(mu0=kw["mumin"]))
    per = rec["per_chunk"]
    if per["quad_gather_rows_bwd_w"] != 1 or per["quad_gather_bwd_w"]:
        raise AssertionError(f"grad_harm3d: launches {per}")
    dump = grmhd_dump.harm3d_dump(32, 24, 16, seed=SEED)
    snaps = {d: load_fluid_model("HARM3D", device=d, dump=dump)
             for d in ("cuda", "cpu")}
    grad_card_vs_cpu("grad_harm3d", lambda d: make(
        d, GRAD_NN, snaps[d.type]), dict(mu0=kw["mumin"]), qg)
    return counts, rec, kept


def emitter_phase(dev):
    """Phase 24, path (c): emitter_observer.run on the card recovers the
    impact parameters of tests/test_tools.py's emission point (4.1, 2.3)
    within 0.05 and lands within 1e-6 of the same search on the CPU."""
    from grtrans_tpu_torch.tools import emitter_observer as eo
    a, mu0, ustar, ab = 0.9, float(np.cos(np.deg2rad(45.0))), 0.125, (4.1,
                                                                        2.3)
    mu_c, ph_c, ok = eo._point_at_u(a, mu0, *(torch.tensor(
        v, dtype=torch.float64, device=dev) for v in ab), ustar)
    if not bool(ok):
        raise AssertionError("emitter_observer: the ray misses r = 8")
    guess = (ab[0] + 0.4, ab[1] - 0.4)
    t0 = time.perf_counter()
    res = eo.run(ustar, mu_c.item(), -ph_c.item(), guess, a=a, mu0=mu0,
                 device=dev)
    wall = time.perf_counter() - t0
    cpu = eo.run(ustar, mu_c.item(), -ph_c.item(), guess, a=a, mu0=mu0,
                 device="cpu")
    dx = np.abs(res.x - cpu.x).max()
    print(f"emitter_observer on the card: x {res.x.tolist()} (true {ab}), "
          f"fun {res.fun:.3e}, {res.nit} iterations, {res.nfev} evaluations "
          f"in {wall:.2f} s; CPU x {cpu.x.tolist()}, max|card - CPU| "
          f"{dx:.2e} (bar 1e-6)")
    if not (res.fun < 1e-6 and np.abs(res.x - ab).max() <= 0.05
            and dx <= 1e-6):
        raise AssertionError(f"emitter_observer: {res.x}, {res.fun}, {dx}")
    return dict(wall_s=wall, nfev=int(res.nfev))


MIXED_RTOL = 2e-3      # mixed vs f64, whole image, of max|I| (test_precision)
MIXED_GRAD_RTOL = 1e-2  # the mixed gradient vs f64's (16x16 x 64)
ZOO_GRAD = {           # tests/test_torch_gradient_zoo.py's part-A models
    "THICKDISK": ("THICKDISK", "thickdisk_dump", (16, 12, 8)),
    "MB09": ("MB09", "mb09_dump", (16, 12, 8)),
    "KORAL": ("KORAL", "koral_dump", (24, 12)),
    "KORAL3D": ("KORAL3D", "koral_dump", (24, 12, 6)),
}
ZOO_CPU_RTOL = 1e-3    # card vs CPU, the part-A mu0 gradients


def warm_pair(render, dev):
    """Warm walls (ms) and peak memory (GiB) of render("f64") and
    render("mixed"), in the order f64, mixed, mixed, f64 in this call."""
    walls, peaks = {"f64": [], "mixed": []}, {}
    for prec in ("f64", "mixed", "mixed", "f64"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        render(prec)
        torch.cuda.synchronize()
        walls[prec].append((time.perf_counter() - t0) * 1e3)
        peaks[prec] = max(peaks.get(prec, 0.0),
                          torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    return walls, peaks


def mixed_error(name, ours, ref, imax):
    """max|ours - ref| / imax (max|I| of ref), held to MIXED_RTOL."""
    ours = torch.as_tensor(ours).cpu()
    ref = torch.as_tensor(ref).cpu()
    if not torch.isfinite(ours).all():
        raise AssertionError(f"{name}: image not finite")
    err = ((ours - ref).abs().max() / imax).item()
    print(f"{name}: max|mixed - f64| / max|I| {err:.3e} (bar {MIXED_RTOL})")
    if not err <= MIXED_RTOL:
        raise AssertionError(f"{name}: mixed vs f64 {err}")
    return err


def mixed_flagship_phase(dev, qg, flagship):
    """Phase 25: the FFJET flagship of phase 4 at prec="mixed"."""
    from grtrans_tpu_torch.fluid import ffjet
    from grtrans_tpu_torch.orchestrator import grtrans_run

    cfg64, model, ref = flagship["cfg"], flagship["model"], flagship["ivals"]
    cfg = dataclasses.replace(cfg64, prec="mixed")
    reset_counts()
    t0 = time.perf_counter()
    ivals, _, _ = grtrans_run(cfg, model, device=dev)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    if (counts["quad_gather_f32"] < 1 or counts["quad_gather_f64"]
            or counts["quad_gather_rows"] or counts["twin_calls"]):
        raise AssertionError(f"mixed flagship launches {counts}: expected "
                             "float32 quad_gather alone, no twin")
    if qg.error_flag(dev).item() != 0:
        raise AssertionError("mixed flagship: out-of-range table index")
    if ivals.dtype != torch.float64 or tuple(ivals.shape) != tuple(
            ref.shape):
        raise AssertionError(f"mixed flagship image {ivals.dtype} "
                             f"{tuple(ivals.shape)}")
    err = mixed_error("mixed flagship 100x100x400 vs phase 4", ivals, ref,
                      ref[..., 0].abs().max().item())
    walls, peaks = warm_pair(lambda prec: grtrans_run(
        cfg if prec == "mixed" else cfg64, model, device=dev), dev)
    print(f"mixed flagship: first {first_ms:.1f} ms; warm frames (ms) "
          f"f64 {walls['f64']}, mixed {walls['mixed']}; peak GiB {peaks}; "
          f"launches {counts}")
    # the float32 kernel on the mixed frame's own index stream
    frame_args = []
    wrapper = ffjet.quad_gather

    def keep(*args):
        frame_args.append(args)
        return wrapper(*args)

    ffjet.quad_gather = keep
    try:
        grtrans_run(cfg, model, device=dev)
    finally:
        ffjet.quad_gather = wrapper
    table, idx, w, nc, nf = frame_args[0]
    if table.dtype != torch.float32:
        raise AssertionError(f"mixed flagship sampled a {table.dtype} table")
    name = "ffjet f32, mixed frame's rows"
    kerr = compare_gather(qg, name, table, idx, w, nc, nf)
    times = dict(time_gather(qg, name, table, idx, w, nc, nf),
                 max_abs_err=kerr)
    return counts, times, dict(image_err=err, first_ms=first_ms,
                               warm_ms=walls, peak_gib=peaks)


def mixed_snapshot_phase(dev, qg, model, image64):
    """Phase 26: the HARM3D frame of phase 12 at prec="mixed"."""
    from grtrans_tpu_torch.api import Grtrans
    from grtrans_tpu_torch.fluid import grmhd3d

    kw = snapshot_kwargs("HARM3D", NN)
    mixed = dict(kw, prec="mixed")
    x, _ = counted_run(qg, dev, "HARM3D snapshot, mixed", mixed, model=model)
    counts = counted_run.counts
    if (counts["quad_gather_rows"] != 1 or counts["quad_gather_rows_f32"] != 1
            or counts["quad_gather"] or counts["twin_calls"]):
        raise AssertionError(f"mixed HARM3D launches {counts}: expected one "
                             "float32 quad_gather_rows launch, no twin")
    if x.ivals.dtype != np.float64:
        raise AssertionError(f"mixed HARM3D image {x.ivals.dtype}")
    err = mixed_error("mixed HARM3D 100x100x400 vs phase 12", x.ivals,
                      image64, np.abs(image64[:, 0]).max())
    walls, peaks = warm_pair(lambda prec: Grtrans(
        **(mixed if prec == "mixed" else kw)).run(model=model), dev)
    print(f"mixed HARM3D: warm frames (ms) f64 {walls['f64']}, mixed "
          f"{walls['mixed']}; peak GiB {peaks}")
    frame_args = []
    wrapper = grmhd3d.quad_gather_rows

    def keep(*args):
        frame_args.append(args)
        return wrapper(*args)

    grmhd3d.quad_gather_rows = keep
    try:
        Grtrans(**mixed).run(model=model)
    finally:
        grmhd3d.quad_gather_rows = wrapper
    tbl, idx, w, nc, nf = frame_args[0]
    if tbl.dtype != torch.float32:
        raise AssertionError(f"mixed HARM3D sampled a {tbl.dtype} table")
    times = check_rows(qg, "snapshot R=4 f32, mixed frame's rows", tbl, idx,
                       w, nc, nf)
    return counts, times, dict(image_err=err, warm_ms=walls, peak_gib=peaks)


def mixed_card_vs_cpu_phase(dev, qg):
    """Phase 27: the card against the port's CPU at prec="mixed" (FFJET,
    SARIAF + POLSYNCHTH, HARM3D at 16x16 x 64); the mixed gradient of the
    FFJET flagship camera at 16x16 x 64 against the f64 one on the card;
    the part-A mu0 gradients (THICKDISK, MB09, KORAL, KORAL3D) on the card
    against central differences there and against the CPU's."""
    from grtrans_tpu_torch import convert
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid import ffjet
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.orchestrator import grtrans_run
    from grtrans_tpu_torch.testing import grmhd_dump
    from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump
    from grtrans_tpu_torch.tools.invert import InverseProblem

    rec = {}
    dump = grmhd_dump.harm3d_dump(32, 24, 16, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        dfile = Path(tmp) / "ffjet.bin"
        write_ffjet_dump(dfile, nx=FFJET_NX, seed=SEED)
        grids, fields = ffjet.load_ffjet_file(dfile)
        cases = {
            "FFJET": (flagship_config(GrtransConfig, dfile, GRAD_NN),
                      lambda d: convert.ffjet_from_arrays(grids, fields, d)),
            "SARIAF": (GrtransConfig(**dict(riaf_kwargs(GRAD_NN, "formal"),
                                            ename="POLSYNCHTH", nfreq=1,
                                            fmin=2.3e11, fmax=2.3e11)),
                       lambda d: None),
            "HARM3D": (GrtransConfig(**snapshot_kwargs("HARM3D", GRAD_NN)),
                       lambda d: load_fluid_model("HARM3D", device=d,
                                                  dump=dump)),
        }
        for name, (cfg64, make) in cases.items():
            cfg = dataclasses.replace(cfg64, prec="mixed")
            gpu, _, _ = grtrans_run(cfg, make(dev), device=dev)
            cpu, _, _ = grtrans_run(cfg, make("cpu"), device="cpu")
            err = ((gpu.cpu() - cpu).abs().max()
                   / cpu[..., 0].abs().max()).item()
            print(f"{name} mixed {GRAD_NN}: card vs CPU max|diff| / max|I| "
                  f"{err:.3e} (bar {MIXED_RTOL})")
            if gpu.dtype != torch.float64 or not err <= MIXED_RTOL:
                raise AssertionError(f"{name} mixed card vs CPU {err}")
            rec[f"{name} card vs CPU"] = err

        # the mixed gradient of step 9 on the flagship camera
        grads, counts = {}, None
        for prec in ("f64", "mixed"):
            prob = InverseProblem(
                fname="FFJET", ename="POLSYNCHPL", iname="formal",
                freq=3.45e11, mbh=3.4e9, nn=GRAD_NN,
                gridvals=(-40.0, 20.0, -20.0, 40.0),
                fixed=dict(dfile=str(dfile), ntscl=2.0, nrscl=70.0),
                uout=FLAGSHIP_UOUT, device=dev, prec=prec)
            def leaves():
                return {k: torch.tensor(v, dtype=torch.float64, device=dev,
                                        requires_grad=True)
                        for k, v in (("spin", 0.998), ("mu0", 0.906))}

            p = leaves()
            reset_counts()
            loss = prob.render(p).abs().sum() / (prob.npix * 4)
            loss.backward()
            torch.cuda.synchronize()
            if prec == "mixed":
                counts = read_counts()
                kept = capture_bwd(qg, lambda: (prob.render(leaves()).abs()
                                                .sum().backward()))
                check_picked(qg, "mixed gradient", kept, counts)
            grads[prec] = {k: v.grad.item() for k, v in p.items()}
    rel = {k: abs(grads["mixed"][k] - v) / abs(v)
           for k, v in grads["f64"].items()}
    print(f"mixed gradient {GRAD_NN} at (0.998, 0.906): mixed "
          f"{grads['mixed']}, f64 {grads['f64']}, rel {rel} (bar "
          f"{MIXED_GRAD_RTOL}); launches {counts}")
    if not all(np.isfinite(v) and rel[k] <= MIXED_GRAD_RTOL
               for k, v in grads["mixed"].items()):
        raise AssertionError(f"mixed gradient {grads}")
    if (counts["quad_gather_bwd_w_f32"] < 1 or counts["quad_gather_bwd_w_f64"]
            or counts["quad_gather_f64"] or counts["twin_calls"]):
        raise AssertionError(f"mixed gradient launches {counts}")
    rec.update(mixed_grad=grads, mixed_grad_rel=rel)

    # part A on the card: finite, against central differences and the CPU
    h = GRAD_FD_STEPS["mu0"]
    for name, (fname, maker, shape) in ZOO_GRAD.items():
        snap = getattr(grmhd_dump, maker)(*shape)
        got = {}
        for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
            prob = InverseProblem(
                fname=fname, ename="POLSYNCHTH", mbh=4.3e6, nn=(8, 8, 32),
                uout=0.04, gridvals=(-15.0, 15.0, -15.0, 15.0),
                fixed=dict(dump=snap),
                source=dict(mdot=4e13, mu=0.25, gmin=10.0), device=where)

            def loss(mu0):
                return prob.render({"spin": torch.tensor(
                    grmhd_dump.A, dtype=torch.float64, device=where),
                    "mu0": mu0}).abs().sum()

            mu0 = torch.tensor(0.6, dtype=torch.float64, device=where,
                               requires_grad=True)
            loss(mu0).backward()
            with torch.no_grad():
                fd = (loss(torch.tensor(0.6 + h, dtype=torch.float64,
                                        device=where))
                      - loss(torch.tensor(0.6 - h, dtype=torch.float64,
                                          device=where))).item() / (2 * h)
            got[key] = (mu0.grad.item(), fd)
        ad, fd = got["card"]
        fd_rel = abs(ad - fd) / abs(fd)
        cpu_rel = abs(ad - got["cpu"][0]) / abs(got["cpu"][0])
        print(f"{name} d/dmu0 on the card {ad:.9e}, central difference "
              f"{fd:.9e} (rel {fd_rel:.2e}, bar {GRAD_FD_RTOL}); CPU "
              f"{got['cpu'][0]:.9e} (rel {cpu_rel:.2e}, bar {ZOO_CPU_RTOL})")
        if not (np.isfinite(ad) and fd_rel <= GRAD_FD_RTOL
                and cpu_rel <= ZOO_CPU_RTOL):
            raise AssertionError(f"{name} mu0 gradient {got}")
        rec[f"{name} mu0"] = dict(card=ad, fd=fd, cpu=got["cpu"][0],
                                  fd_rel=fd_rel, cpu_rel=cpu_rel)
    return counts, rec, kept


def finite_or_none(obj):
    """obj with every non-finite float replaced by None (a JSON null), so
    that no line carries a bare NaN token."""
    if isinstance(obj, dict):
        return {k: finite_or_none(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite_or_none(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def by_path(paths, key):
    return {name: c[key] for name, c in paths.items()}


def build_phase():
    """Phase 2: build and load csrc/formal_march.cu, csrc/quad_gather.cu,
    csrc/harmpi_invert.cu and csrc/render_polsynchth.cu; print ptxas's
    registers and spills."""
    from grtrans_tpu_torch.ops import _build
    from grtrans_tpu_torch.ops import formal_march as fm
    from grtrans_tpu_torch.ops import harmpi_invert as hi
    from grtrans_tpu_torch.ops import quad_gather as qg
    from grtrans_tpu_torch.ops import render_polsynchth as rp

    for mod in (fm, qg, hi, rp):
        t0 = time.perf_counter()
        _build.load(mod.SOURCE, mod.NVCC_FLAGS, mod.ARGTYPES)
        so = _build.library_path(mod.SOURCE, mod.NVCC_FLAGS)
        print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")


def run(dev):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from grtrans_tpu_torch.ops import quad_gather as qg

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
    build_phase()

    # 3. kernel vs plain at the main paths' shapes
    shapes = {}
    for name, ns, nc, nf, dtype in (
            ("ffjet f64", FFJET_NX ** 2, 4, 9, torch.float64),
            ("ffjet f32", FFJET_NX ** 2, 4, 9, torch.float32),
            ("polsynchpl f64", 201, 2, 6, torch.float64)):
        err, times = check_kernel(qg, name, ns, nc, nf, dtype, dev)
        shapes[name] = dict(times, max_abs_err=err)
    err, times = check_kernel(qg, "phatdisk f64", 500, 2, 101, torch.float64,
                              dev, n=DISK_NN[0] * DISK_NN[1])
    shapes["phatdisk f64"] = dict(times, max_abs_err=err)
    # the 2-D tables of the tiled kernel's other shapes: HARM on a 32 x 24
    # and on the EHT library's 288 x 128 r-theta grid, KORAL on the latter,
    # SPHACC's default 600 radii, a 100 x 50 NUMDISK table, the (p, x)
    # table of the per-sample-p POLSYNCHPL lookup
    for name, ns, nc, nf in (
            ("harm 2-D f64", 32 * 24, 4, 10),
            ("harm 2-D 288x128 f64", HARM2D_NX[0] * HARM2D_NX[1], 4, 10),
            ("koral 2-D 288x128 f64", HARM2D_NX[0] * HARM2D_NX[1], 4, 11),
            ("sphacc f64", 600, 2, 2),
            ("numdisk f64", 5000, 4, 1),
            ("polsynchpl per-sample p f64", 131 * 201, 4, 6)):
        before = obs.counters()["quad_gather.launches.tiled"]
        err, times = check_kernel(qg, name, ns, nc, nf, torch.float64, dev)
        if obs.counters()["quad_gather.launches.tiled"] <= before:
            raise AssertionError(f"{name}: the wrapper did not pick the "
                                 "tiled kernel")
        shapes[name] = dict(times, max_abs_err=err)
    check_error_flag(qg, dev)

    ffjet_counts, frame_times, flagship = ffjet_phases(dev, qg)
    shapes["ffjet f64, frame's rows"] = frame_times
    paths = {"ffjet_flagship": ffjet_counts,
             "riaf_hybrid_lsoda": riaf_phases(dev, qg),
             "hotspot_light_curve": hotspot_phase(dev, qg)}
    paths["thindisk_bbpol"], paths["phatdisk_interp"] = disk_phase(dev, qg)
    card_vs_cpu_phase()
    shapes.update(rows_phase(dev, qg))
    (paths["harm3d_snapshot"], paths["harm3d_slow_light"], frame_times,
     slow_times, snapshot, snapshot_image) = snapshot_phases(dev, qg)
    shapes["snapshot R=4 f64, frame's rows"] = frame_times
    shapes["three slices R=8 f64, slow-light frame's rows"] = slow_times
    snapshot_card_vs_cpu_phase()
    paths["harm2d_snapshot"], shapes["harm 2-D 288x128 f64, frame's rows"] \
        = harm2d_phase(dev, qg)
    paths.update(file_phases(dev, qg))
    paths["pgriter_harm3d"] = pgriter_phase(dev, qg, snapshot)
    paths["mesh_ffjet"], paths["slab_harm3d"], slabs = mesh_phase(
        dev, qg, flagship, snapshot, snapshot_image, frame_times)
    bwd = bwd_kernel_phase(dev, qg)
    streams = {}
    paths["fwdbwd_ffjet"], fwdbwd, streams["fwdbwd_ffjet"] = fwdbwd_phase(
        dev, qg)
    paths["grad_harm3d"], grad_harm3d, streams["grad_harm3d"] = \
        harm3d_grad_phase(dev, qg, snapshot)
    emitter = emitter_phase(dev)
    grad_paths = ("fwdbwd_ffjet", "grad_harm3d")
    # 25-27. prec="mixed"
    paths["mixed_ffjet"], mixed_frame, mixed_flagship = mixed_flagship_phase(
        dev, qg, flagship)
    del flagship
    paths["mixed_harm3d"], mixed_rows, mixed_snapshot = mixed_snapshot_phase(
        dev, qg, snapshot, snapshot_image)
    del snapshot
    paths["mixed_grad_ffjet"], mixed_cpu, streams["mixed_grad_ffjet"] = \
        mixed_card_vs_cpu_phase(dev, qg)
    # 21 (b). the backward kernels on the gradient paths' own rows
    bwd_streams = bwd_stream_phase(qg, streams)
    del streams
    mixed_paths = ("mixed_ffjet", "mixed_harm3d", "mixed_grad_ffjet")
    # 28. the march kernel
    march = march_phase(dev)
    march64 = march[march_row("f64")]
    # 29. HARMPI's inversion kernels
    invert = invert_phase(dev)
    invert64 = invert["f64"]
    # 30. the POLSYNCHTH render kernel
    render = render_phase(dev)
    render64 = render["f64"]

    main = shapes["ffjet f64"]
    wide = shapes["phatdisk f64"]
    rows = shapes["snapshot R=4 f64"]
    source = "grtrans_tpu_torch/csrc/quad_gather.cu"
    gather_by_kernel = {k: sum(by_path(paths, k).values())
                        for k in ("tiled", "wide", "generic")}
    rows_by_kernel = {k: sum(by_path(paths, "rows_" + k).values())
                      for k in ("tiled", "simple")}
    print(card)
    print(json.dumps(finite_or_none({"kernels": [{
        "name": "quad_gather", "route": "cuda", "source": source,
        "replaces": "grtrans_tpu/ops/pallas_gather.py:49",
        "launches": sum(by_path(paths, "quad_gather").values()),
        "launches_by_path": by_path(paths, "quad_gather"),
        "launches_by_kernel": gather_by_kernel,
        "max_abs_err": main["max_abs_err"], "ms": main["kernel"],
        "plain_ms": main["plain"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library"],
        "shapes": shapes}, {
        "name": "quad_gather_wide", "route": "cuda", "source": source,
        "replaces": "grtrans_tpu/ops/pallas_gather.py:49",
        "launches": gather_by_kernel["wide"],
        "launches_by_path": by_path(paths, "wide"),
        "max_abs_err": wide["max_abs_err"], "ms": wide["kernel"],
        "plain_ms": wide["plain"], "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"], "library_ms": wide["library"]}, {
        "name": "quad_gather_rows", "route": "cuda", "source": source,
        "replaces": "grtrans_tpu/fluid/grmhd3d.py:212",
        "launches": sum(by_path(paths, "quad_gather_rows").values()),
        "launches_by_path": by_path(paths, "quad_gather_rows"),
        "launches_by_kernel": rows_by_kernel, "slabs": slabs,
        "max_abs_err": rows["max_abs_err"], "ms": rows["kernel"],
        "plain_ms": rows["plain"], "bound_ms": rows["bound_ms"],
        "bound_by": rows["bound_by"], "library_ms": rows["library"]}] + [{
        "name": name + suffix, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(paths[p][name + suffix] for p in on),
        "launches_by_path": {p: paths[p][name + suffix] for p in on},
        "launches_by_kernel": {
            k: sum(paths[p][BWD[name][1] + k] for p in on)
            for k in ("tiled", BWD[name][0])},
        "max_abs_err": t["max_abs_err"], "ms": t["kernel"],
        "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library"],
        "shapes": {k: v for k, v in list(bwd.items())
                   + list(bwd_streams.items())
                   if (k.startswith(name + " ") or k == name)
                   and ("f32" in k) == (suffix == "_f32")}}
            for name, suffix, replaces, t, on in (
                ("quad_gather_bwd_w", "",
                 "grtrans_tpu/ops/pallas_gather.py:49",
                 bwd["quad_gather_bwd_w"], grad_paths),
                ("quad_gather_rows_bwd_w", "",
                 "grtrans_tpu/fluid/grmhd3d.py:212",
                 bwd["quad_gather_rows_bwd_w"], grad_paths),
                ("quad_gather_bwd_w", "_f32",
                 "grtrans_tpu/ops/pallas_gather.py:49",
                 bwd["quad_gather_bwd_w f32"], ("mixed_grad_ffjet",)))]
        + [{
        "name": name + "_f32", "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(paths[p][name + "_f32"] for p in mixed_paths),
        "launches_by_path": {p: paths[p][name + "_f32"]
                             for p in mixed_paths},
        "max_abs_err": t["max_abs_err"], "ms": t["kernel"],
        "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library"]}
            for name, replaces, t in (
                ("quad_gather", "grtrans_tpu/ops/pallas_gather.py:49",
                 mixed_frame),
                ("quad_gather_rows", "grtrans_tpu/fluid/grmhd3d.py:212",
                 mixed_rows))]
        + [{
        "name": "formal_march", "route": "cuda",
        "source": "grtrans_tpu_torch/csrc/formal_march.cu",
        "replaces": "grtrans_tpu/integrate/solvers.py:532",
        "launches": sum(by_path(paths, "march_kernel").values()),
        "launches_by_path": by_path(paths, "march_kernel"),
        "twin_calls_by_path": by_path(paths, "march_twin"),
        "max_abs_err": march64["max_rel_err"], "ms": march64["ms"],
        "plain_ms": march64["plain_ms"], "bound_ms": march64["bound_ms"],
        "bound_by": march64["bound_by"], "shapes": march}, {
        "name": "harmpi_invert", "route": "cuda",
        "source": "grtrans_tpu_torch/csrc/harmpi_invert.cu",
        "replaces": "grtrans_tpu/fluid/harmpi.py:158",
        "launches": sum(by_path(paths, "invert_kernel").values())
        + invert64["counts"]["invert_kernel"],
        "launches_by_path": by_path(paths, "invert_kernel"),
        "twin_calls_by_path": by_path(paths, "invert_twin"),
        "max_abs_err": max(invert64["x1"]["max_abs_err"],
                           invert64["x2"]["max_abs_err"]),
        "ms": invert64["ms"], "plain_ms": invert64["plain_ms"],
        "bound_ms": invert64["bound_ms"], "bound_by": invert64["bound_by"],
        "shapes": {f"harmpi 256x256x400 bl3 {tag}": row
                   for tag, row in invert.items()}}, {
        "name": "render_polsynchth", "route": "cuda",
        "source": "grtrans_tpu_torch/csrc/render_polsynchth.cu",
        "replaces": "grtrans_tpu/driver.py:149",
        "launches": sum(by_path(paths, "render_kernel").values())
        + sum(row["counts"]["render_kernel"] for row in render.values()),
        "launches_by_path": by_path(paths, "render_kernel"),
        "twin_calls_by_path": by_path(paths, "render_twin"),
        "max_abs_err": render64["max_rel_err"], "ms": render64["ms"],
        "plain_ms": render64["plain_ms"], "bound_ms": render64["bound_ms"],
        "bound_by": render64["bound_by"],
        "shapes": {"harm3d {}x{}x{} lsoda {}".format(*RENDER_NN, tag): row
                   for tag, row in render.items()}}],
        "gradient_paths": {"fwdbwd_ffjet": fwdbwd,
                           "grad_harm3d": grad_harm3d,
                           "emitter_observer": emitter},
        "mixed_paths": {"ffjet_flagship": mixed_flagship,
                        "harm3d_snapshot": mixed_snapshot,
                        "card_vs_cpu_and_gradients": mixed_cpu}}),
                     allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
