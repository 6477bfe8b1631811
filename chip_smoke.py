"""GPU smoke run of the PyTorch port (grtrans_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, each of which raises on failure (non-zero exit, no result line):
  1. require CUDA; print the card's name and power limit; TF32 off;
  2. build the hand-written kernels of csrc/quad_gather.cu for sm_90a;
  3. hold quad_gather against its plain PyTorch version on the card at the
     main paths' shapes (FFJET 4e6 queries x (16384, 36) table in f64 and
     f32; the POLSYNCHPL cutoff table (201, 12); PHATDISK's pair-packed
     table (500, 2 x 101) at the 1024^2 queries of its frame, which the
     wrapper sends to the wide-row kernel; the 2-D tables of the tiled
     kernel's other shapes at 4e6 queries: HARM 4 x 10 on a 32 x 24 and a
     288 x 128 grid, KORAL 4 x 11, SPHACC 2 x 2, NUMDISK 4 x 1 and the
     per-sample-p POLSYNCHPL table 4 x 6) on uniformly random rows, check
     the out-of-range flag, and time with CUDA events: the kernel the
     wrapper picks, the generic kernel, the plain version and
     embedding_bag (the one-call PyTorch yardstick), beside the bound
     computed from the bytes the call must move;
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
 11. quad_gather_rows, the multi-row gather of the GRMHD snapshot
     samplers: its tiled kernel with and without deduplication (a warp's
     lanes sharing a row's copy, which the port runs) and its simple
     kernel against the plain version at a 288x128x128 snapshot's table
     (4,718,592 rows of 2 x 10) with 4e6 queries of R = 4 rows in f64 and
     f32, of R = 8 rows on three slices, of R = 1 (HARMPI's 1 x 10), on a
     stream whose queries all name one row; the simple kernel alone where
     the wrapper sends only it: KORAL3D's bins (R = 8 and R = 4 of 1 x 6,
     ragged last tile; also timed from CUDA graphs, without the host's
     launch cost) and rows the bulk copy cannot take (2 x 11 in f32); the
     wide-row kernel at ragged widths; the out-of-range flag of every
     kernel; timed in the order plain, embedding_bag, simple, tiled
     without and with deduplication, and back (embedding_bag on the table
     viewed as (2 NS, nf) is the library yardstick);
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
     world of one equal to vals.
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


HBM_BYTES_PER_S = 3.35e12             # H100 SXM device memory rate
# peak rates outside the tensor cores: float32 from the H100 data sheet,
# float64 at half of it
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}


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


def reset_counts(qg):
    qg.quad_gather.launches = 0
    qg.quad_gather.launches_by_kernel.clear()
    qg.quad_gather_rows.launches = 0
    qg.quad_gather_rows.launches_by_kernel.clear()


def read_counts(qg):
    by, rows = (qg.quad_gather.launches_by_kernel,
                qg.quad_gather_rows.launches_by_kernel)
    return dict(quad_gather=qg.quad_gather.launches, tiled=by["tiled"],
                wide=by["wide"], generic=by["generic"],
                quad_gather_rows=qg.quad_gather_rows.launches,
                rows_tiled=rows["tiled"], rows_simple=rows["simple"])


def rows_bound_ms(idx, w, ns, nc, nf):
    """Least time for one quad_gather_rows: index, weights and output once
    and every distinct row the queries name once, over the memory rate,
    against 2 R nc nf operations a query over the peak rate."""
    n, r = idx.shape
    size = w.element_size()
    distinct = idx.unique().numel()
    nbytes = n * r * 4 + n * r * nc * size + n * nf * size \
        + distinct * nc * nf * size
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * n * r * nc * nf / PEAK_FLOPS[w.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), distinct


def check_rows(qg, name, table, idx, w, nc, nf, reps=10, graph=False):
    """quad_gather_rows against its plain version on the card, each kernel
    that takes the shape (simple; tiled without and with deduplication),
    then CUDA event times in the order plain, embedding_bag, simple, tiled
    without and with deduplication, and back; with `graph`, the kernels
    once more from CUDA graphs (graph_ms: device time without the host's
    launch cost), "<kernel> graph".  Returns the dict of mean times
    ("kernel": the one the wrapper picks), bound and the largest
    max_abs_err of the kernels."""
    n, r = idx.shape
    ns = table.shape[0]
    tiled = qg.rows_kernel(r, nc, nf, table.element_size(),
                           table.data_ptr() % 16 == 0) == "tiled"

    def simple():
        return qg.quad_gather_rows(table, idx, w, nc, nf, simple=True)

    def nodedup():
        return qg.quad_gather_rows(table, idx, w, nc, nf, dedup=False)

    def warp():
        return qg.quad_gather_rows(table, idx, w, nc, nf)

    kernels = [simple, nodedup, warp] if tiled else [simple]
    ref = qg.quad_gather_rows_ref(table, idx, w, nc, nf)
    # a ray's samples past its end carry NaN weights: NaN in both
    fin = torch.isfinite(ref)
    scale = ref[fin].abs().max().item()
    tol = ROWS_TOL[table.dtype]
    errs = {}
    for fn in kernels:
        out = fn()
        torch.cuda.synchronize()
        if not torch.equal(torch.isfinite(out), fin):
            raise AssertionError(f"{name}: {fn.__name__} kernel and plain "
                                 "differ in where they are finite")
        errs[fn.__name__] = (out - ref)[fin].abs().max().item()
        if not errs[fn.__name__] <= tol * scale:
            raise AssertionError(f"{name}: max|{fn.__name__} - plain| "
                                 f"{errs[fn.__name__]} > {tol} * {scale}")
        if qg.error_flag(table.device).item() != 0:
            raise AssertionError(f"{name}: out-of-range flag set")
        del out
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
    order = [plain, library, *kernels]
    for fn in order + order[::-1]:
        times.setdefault(fn.__name__, []).append(cuda_ms(fn, reps))
    if graph:
        for fn in kernels + kernels[::-1]:
            times.setdefault(f"{fn.__name__} graph", []).append(
                graph_ms(fn, reps))
    bound, bound_by, distinct = rows_bound_ms(idx, w, ns, nc, nf)
    res = {k: sum(v) / len(v) for k, v in times.items()}
    picked = "warp" if tiled else "simple"
    res.update(kernel=res[picked], bound_ms=bound, bound_by=bound_by,
               max_abs_err=max(errs.values()), picked=picked)
    print(f"{name}: N={n} R={r} table=({ns}, {nc * nf}) {table.dtype}, "
          f"{distinct} distinct rows: max|kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (max|plain| {scale:.3e}, bar {tol:g} of it); ms "
          + "; ".join(f"{k} " + "/".join(f"{t:.4f}" for t in v)
                      for k, v in times.items())
          + f"; bound {bound:.4f} ms by {bound_by}; share of bound "
          + ", ".join(f"{fn.__name__} {bound / res[fn.__name__]:.3f}"
                      for fn in kernels)
          + f" (the wrapper picks {picked}); max|embedding_bag - plain| "
          f"{lib_err:.2e}")
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
    before = qg.quad_gather_rows.launches_by_kernel["simple"]
    qg.quad_gather_rows(table, idx, w, 2, 11)
    if qg.quad_gather_rows.launches_by_kernel["simple"] != before + 1:
        raise AssertionError("2 x 11 float32 did not go to the simple kernel")
    shapes["koral3d R=4 2x11 f32"] = check_rows(
        qg, "koral3d R=4 2x11 f32", table, idx, w, 2, 11)
    del table, idx, w
    torch.cuda.empty_cache()
    # the wide-row kernel at widths ragged against the warp
    for nc_, nf_, dtype in ((2, 101, torch.float32), (3, 45, torch.float64),
                            (1, 257, torch.float64)):
        before = qg.quad_gather.launches_by_kernel["wide"]
        rng = np.random.default_rng(SEED)
        tb = torch.as_tensor(rng.standard_normal((300, nc_ * nf_)),
                             dtype=dtype, device=dev)
        ix = torch.as_tensor(rng.integers(0, 300, 100_003), dtype=torch.int32,
                             device=dev)
        ww = torch.as_tensor(rng.uniform(0, 1, (100_003, nc_)), dtype=dtype,
                             device=dev)
        compare_gather(qg, f"wide ({nc_} x {nf_}) {dtype}", tb, ix, ww, nc_,
                       nf_)
        if qg.quad_gather.launches_by_kernel["wide"] != before + 1:
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
    for kernel in ("none", "warp", "simple"):
        out = qg.quad_gather_rows(tb[:, :20].contiguous(), idx,
                                  torch.ones((200, 4, 2), dtype=torch.float64,
                                             device=dev), 2, 10,
                                  simple=kernel == "simple",
                                  dedup=kernel == "warp")
        torch.cuda.synchronize()
        if flag.item() != 1 or not torch.isnan(out[bad]).all() \
                or not (out[~bad] == 8).all():
            raise AssertionError(f"quad_gather_rows {kernel}: out-of-range "
                                 "index not flagged")
        flag.zero_()
    print("wide and rows kernels (tiled without and with deduplication, "
          "simple): "
          "out-of-range index flagged, its query NaN, others untouched")
    return shapes


def time_gather(qg, name, table, idx, w, nc, nf):
    """CUDA-event times of the plain version, the one-call PyTorch
    yardstick (embedding_bag, used nowhere in the port), the generic
    kernel and the kernel the wrapper picks, in the order plain, library,
    generic, kernel, kernel, generic, library, plain.  Returns a dict of
    mean times in ms plus the bound."""
    n, ns = idx.shape[0], table.shape[0]
    bag_idx = idx.long()[:, None] * nc + torch.arange(nc, device=idx.device)
    bag_table = table.view(ns * nc, nf)

    def plain():
        return qg.quad_gather_ref(table, idx, w, nc, nf)

    def library():
        return torch.nn.functional.embedding_bag(
            bag_idx, bag_table, per_sample_weights=w, mode="sum")

    def generic():
        return qg.quad_gather(table, idx, w, nc, nf, generic=True)

    def kernel():
        return qg.quad_gather(table, idx, w, nc, nf)

    lib_err = (library() - plain()).abs().max().item()
    gen_err = (generic() - plain()).abs().max().item()
    order = [plain, library, generic, kernel, kernel, generic, library,
             plain]
    times = {}
    for fn in order:
        times.setdefault(fn.__name__, []).append(cuda_ms(fn))
    bound, bound_by = gather_bound_ms(n, ns, nc, nf, table.dtype)
    res = {k: sum(v) / len(v) for k, v in times.items()}
    res.update(bound_ms=bound, bound_by=bound_by)
    print(f"{name}: N={n} table=({ns}, {nc * nf}) {table.dtype}: kernel "
          + "/".join(f"{t:.4f}" for t in times["kernel"])
          + " ms, generic kernel "
          + "/".join(f"{t:.4f}" for t in times["generic"])
          + " ms, plain " + "/".join(f"{t:.4f}" for t in times["plain"])
          + " ms, embedding_bag "
          + "/".join(f"{t:.4f}" for t in times["library"])
          + f" ms; bound {bound:.4f} ms by {bound_by} "
          f"(share of bound {bound / res['kernel']:.3f}); "
          f"max|embedding_bag - plain| {lib_err:.2e}, "
          f"max|generic - plain| {gen_err:.2e}")
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
    out = qg.quad_gather(table, idx, w, nc, nf)
    ref = qg.quad_gather_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = KERNEL_TOL[table.dtype]
    print(f"{name}: max|kernel - plain| {err:.3e} (max|plain| {scale:.3e}, "
          f"bar {tol:g} of it)")
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max|kernel - plain| {err} > "
                             f"{tol} * {scale}")
    if qg.error_flag(table.device).item() != 0:
        raise AssertionError(f"{name}: out-of-range flag set")
    return err


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
        reset_counts(qg)
        t0 = time.perf_counter()
        ivals, _, _ = grtrans_run(cfg, model, device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts(qg)
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

    reset_counts(qg)
    t0 = time.perf_counter()
    x = Grtrans(**kw).run(model=model)
    first_s = time.perf_counter() - t0
    counted_run.counts = read_counts(qg)
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
    print(f"{name} {nn[0]}x{nn[1]}x{nn[2]} x {ncams} cameras, f64: first "
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
        reset_counts(qg)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cli_main([str(tmp / "files.in"), "--output", str(tmp / "cams.bin")])
        warm_s = time.perf_counter() - t0
        paths["cli_flagship"] = read_counts(qg)
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
            reset_counts(qg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            ivals, _, _ = grtrans_run(cfg, model, device=dev, gdfile=str(gd))
            torch.cuda.synchronize()
            walls[step] = time.perf_counter() - t0
            peaks[step] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            paths[f"gdfile_{step}"] = read_counts(qg)
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
        reset_counts(qg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        dump = geodebug.dump_ray(cfg, pixel, tmp / "ray.npz", model=model,
                                 device=dev)
        dump_s = time.perf_counter() - t0
        paths["geodebug_ray"] = read_counts(qg)
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
    reset_counts(qg)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        fitted, flux, hist = pgriter.fit_flux(cfg, target, 4e13, model=model,
                                              device=dev)
    finally:
        pgriter.flux_at = real_flux_at
        base._REGISTRY["HARM3D"] = real_factory
    counts = read_counts(qg)
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
        reset_counts(qg)
        ivals, _, _ = grtrans_run(cfg, tmodel, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        mesh_counts = read_counts(qg)
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
        reset_counts(qg)
        x = Grtrans(**kw).run(model=slabs)
        slab_counts = read_counts(qg)
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
    finally:
        dist.destroy_process_group()
    return mesh_counts, slab_counts, dict(
        whole_ms=whole_rows["kernel"], whole_bound_ms=whole_rows["bound_ms"],
        per_slab=per_slab)


def by_path(paths, key):
    return {name: c[key] for name, c in paths.items()}


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
    t0 = time.perf_counter()
    so = qg.build()
    qg.load_library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

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
        before = qg.quad_gather.launches_by_kernel["tiled"]
        err, times = check_kernel(qg, name, ns, nc, nf, torch.float64, dev)
        if qg.quad_gather.launches_by_kernel["tiled"] <= before:
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
    del snapshot, flagship

    main = shapes["ffjet f64"]
    wide = shapes["phatdisk f64"]
    rows = shapes["snapshot R=4 f64"]
    source = "grtrans_tpu_torch/csrc/quad_gather.cu"
    gather_by_kernel = {k: sum(by_path(paths, k).values())
                        for k in ("tiled", "wide", "generic")}
    rows_by_kernel = {k: sum(by_path(paths, "rows_" + k).values())
                      for k in ("tiled", "simple")}
    print(card)
    print(json.dumps({"kernels": [{
        "name": "quad_gather", "route": "cuda", "source": source,
        "replaces": "grtrans_tpu/ops/pallas_gather.py:49",
        "launches": sum(by_path(paths, "quad_gather").values()),
        "launches_by_path": by_path(paths, "quad_gather"),
        "launches_by_kernel": gather_by_kernel,
        "max_abs_err": main["max_abs_err"], "ms": main["kernel"],
        "plain_ms": main["plain"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library"],
        "generic_ms": main["generic"], "shapes": shapes}, {
        "name": "quad_gather_wide", "route": "cuda", "source": source,
        "replaces": "grtrans_tpu/ops/pallas_gather.py:49",
        "launches": gather_by_kernel["wide"],
        "launches_by_path": by_path(paths, "wide"),
        "max_abs_err": wide["max_abs_err"], "ms": wide["kernel"],
        "plain_ms": wide["plain"], "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"], "library_ms": wide["library"],
        "generic_ms": wide["generic"]}, {
        "name": "quad_gather_rows", "route": "cuda", "source": source,
        "replaces": "grtrans_tpu/fluid/grmhd3d.py:212",
        "launches": sum(by_path(paths, "quad_gather_rows").values()),
        "launches_by_path": by_path(paths, "quad_gather_rows"),
        "launches_by_kernel": rows_by_kernel, "slabs": slabs,
        "max_abs_err": rows["max_abs_err"], "ms": rows["kernel"],
        "plain_ms": rows["plain"], "bound_ms": rows["bound_ms"],
        "bound_by": rows["bound_by"], "library_ms": rows["library"],
        "simple_ms": rows["simple"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
