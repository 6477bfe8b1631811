"""Packed-row table gathers fused with their corner combine.

    quad_gather:       out[n, f] = sum_c w[n, c] * table[idx[n], c * nf + f]
    quad_gather_rows:  out[n, f] = sum_r sum_c w[n, r, c]
                                            * table[idx[n, r], c * nf + f]

`quad_gather` is the Hopper counterpart of the Pallas kernel
grtrans_tpu/ops/pallas_gather.py (`vmem_row_gather`) plus its epilogue
`quad_combine`; `quad_gather_rows` (R rows a query; R = 1 is quad_gather)
is what the GRMHD snapshot samplers of grtrans_tpu leave to one fused XLA
gather + weighted sum (fluid/grmhd3d.py `_gather_cols`).  Each wrapper
takes CPU tensors to its plain PyTorch version (`quad_gather_ref`,
`quad_gather_rows_ref`) and CUDA tensors to the hand-written kernels in
csrc/quad_gather.cu; there is no fallback between the two.

quad_gather has three kernels: a tiled one for the narrow shapes in use,
`TILED_SHAPES` (FFJET 4x9, the POLSYNCHPL cutoff table 2x6 and its
per-sample-p form 4x6, HARM 4x10, KORAL 4x11, SPHACC 2x2, NUMDISK 4x1),
which needs 16-byte aligned operands; a wide-row one (a warp a query) for
nf >= 32 (PHATDISK's 2x101); and a generic one (one thread per output
element) for everything else.  `gather_kernel` picks by shape and
alignment; `generic=True` forces the generic kernel so that it can be timed
against the others.

quad_gather_rows has two: a tiled one (persistent blocks, the rows of a
tile copied to shared memory by Hopper bulk copies, two tiles in flight,
lanes of a warp that name one row sharing its copy) for the (R, nc) of
`ROWS_TILED_SHAPES` with rows that are whole 16-byte pieces of a 16-byte
aligned table, and the simple one (sixteen lanes a query) for anything
else.  `rows_kernel` picks; `simple=True` forces the simple kernel and
`dedup=False` the tiled kernel without the warp's sharing of copies, so
that they can be timed; the port runs the default, `dedup=True`.

Gradients: each wrapper is a torch.autograd.Function wherever its
weights carry a gradient.  The backward with respect to the weights,

    quad_gather_bwd_w:       dw[n, c] = sum_f g[n, f] * table[idx[n], c * nf + f]
    quad_gather_rows_bwd_w:  dw[n, r, c] = sum_f g[n, f]
                                             * table[idx[n, r], c * nf + f]

is a hand-written kernel of its own on the card and its plain twin
(`quad_gather_bwd_w_ref`, `quad_gather_rows_bwd_w_ref`) on the CPU; the
index takes no gradient, and a table that requires one raises
NotImplementedError (every table is loaded data: no path of the renderer
differentiates one, so the scatter-add that would need is not written).
Each backward has two kernels: a tiled one on its forward's pipeline (the
R = 1 tile pipeline for `TILED_SHAPES`, the bulk-copy ring with warp dedup
for `ROWS_TILED_SHAPES`; table, g and dw on 16 bytes) and the first
design (a thread a weight, any shape), "generic" for R = 1 and "simple"
for rows.  `bwd_kernel` / `rows_bwd_kernel` pick; `generic=True` /
`simple=True` force the first design so that the two can be timed against
each other.

The library is compiled with nvcc on first use into
grtrans_tpu_torch/_build/, keyed by a hash of its source, and bound with
ctypes (the set-up span "setup.kernels"; the counter "kernel_builds"
counts nvcc runs).  Each of the four wrappers is the span "gather" and
counts its queries ("gather.queries") and, in the obs counters, its
kernel launches ("<wrapper>.launches"), split by kernel
("<wrapper>.launches.tiled", ...) and by instantiation
("<wrapper>.launches.f64", "<wrapper>.launches.f32").  The plain twins
count their calls ("<twin>.calls"), so that a run can show that no path on
the card reached them.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from grtrans_tpu_torch import obs

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "quad_gather.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_lib = None
_err_flags = {}


def dtype_name(table):
    """"f32" or "f64": the kernel instantiation a table's dtype takes."""
    return "f64" if table.dtype == torch.float64 else "f32"


def pair_rows(rows):
    """(n, f) numpy table -> (n, 2 f): row i holds rows i and i + 1, the
    packing of a linear interpolation along the rows (nc = 2, nf = f).
    The last row repeats itself; cell indices stop at n - 2, so its second
    half is never weighted in."""
    return np.concatenate([rows, np.concatenate([rows[1:], rows[-1:]])],
                          axis=1)


def pack_corners_2d(fields):
    """(n1, n2, nf) numpy grid -> (n1 * n2, 4 nf): row (i1, i2) holds the
    2x2 cell's corners (0,0), (1,0), (0,1), (1,1) in (i1, i2) offsets, the
    packing of a bilinear sample (nc = 4).  Edge rows are duplicated; cell
    indices stop at n - 2, so the pad is never weighted in."""
    A = np.asarray(fields)
    A1 = np.concatenate([A[1:], A[-1:]], axis=0)
    B0 = np.concatenate([A[:, 1:], A[:, -1:]], axis=1)
    B1 = np.concatenate([A1[:, 1:], A1[:, -1:]], axis=1)
    n1, n2, nf = A.shape
    return np.stack([A, A1, B0, B1], axis=2).reshape(n1 * n2, 4 * nf)


def bilinear_operands(n2, i1, i2, w1, w2):
    """The quad_gather index and weights of a bilinear sample of a
    pack_corners_2d table at cells (i1, i2), fractional weights (w1, w2)."""
    w = torch.stack([(1 - w1) * (1 - w2), w1 * (1 - w2),
                     (1 - w1) * w2, w1 * w2], dim=-1).reshape(-1, 4)
    return (i1 * n2 + i2).reshape(-1), w.contiguous()


def bilinear_packed(table, n2, nf, i1, i2, w1, w2):
    """Bilinear sample of a pack_corners_2d table at cells (i1, i2) with
    fractional weights (w1, w2) along the two axes, through quad_gather;
    the weights take the table's dtype (a float64 table sampled at float32
    points is read in float64, as grtrans_tpu's promotion reads it).
    Returns i1.shape + (nf,)."""
    idx, w = bilinear_operands(n2, i1, i2, w1, w2)
    out = quad_gather(table, idx, w.to(table.dtype), 4, nf)
    return out.reshape(i1.shape + (nf,))


def quad_gather_ref(table, idx, w, nc, nf):
    """Plain PyTorch version: (table[idx].view(N, nc, nf) * w).sum(corners)."""
    obs.count("quad_gather_ref.calls")
    n = idx.shape[0]
    return (table[idx.long()].view(n, nc, nf) * w[..., None]).sum(-2)


def quad_gather_bwd_w_ref(table, idx, g, nc, nf):
    """Plain PyTorch version of the weights' gradient: (N, nc)."""
    obs.count("quad_gather_bwd_w_ref.calls")
    n = idx.shape[0]
    return (table[idx.long()].view(n, nc, nf) * g[:, None, :]).sum(-1)



def _check_operands(table, idx, x, nc, nf, rows, grad=False):
    """Raise unless table is (NS, nc*nf) float32/float64, idx an int32
    tensor of 2 axes (rows) or 1, and x, in the table's dtype, the weights
    (idx.shape + (nc,)) or, with grad, the output's gradient (N, nf); all
    contiguous on one device, the CPU or a card."""
    if table.dim() != 2 or table.shape[1] != nc * nf:
        raise ValueError(f"table must be (NS, {nc * nf}), got "
                         f"{tuple(table.shape)}")
    if table.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"table dtype {table.dtype} not supported")
    idx_dim = 2 if rows else 1
    if idx.dim() != idx_dim or idx.dtype != torch.int32:
        raise TypeError(f"idx must be a {idx_dim}-D int32 tensor")
    want = (idx.shape[0], nf) if grad else (*idx.shape, nc)
    if tuple(x.shape) != want or x.dtype != table.dtype:
        raise ValueError(f"{'g' if grad else 'w'} must be {want} "
                         f"{table.dtype}, got {tuple(x.shape)} {x.dtype}")
    if not (table.device == idx.device == x.device):
        raise ValueError("table, idx and w must be on one device")
    if not (table.is_contiguous() and idx.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("table, idx and w must be contiguous")
    if table.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no quad_gather kernels for "
                                  f"{table.device}")


def _differentiable(table, w):
    """Whether the call must record a gradient: the weights require one.
    A table that requires one raises: the table gradient (a scatter-add
    over the rows) is not written."""
    if not torch.is_grad_enabled():
        return False
    if table.requires_grad:
        raise NotImplementedError(
            "quad_gather: the gradient with respect to the table is not "
            "implemented (tables are loaded data; only the weights take a "
            "gradient)")
    return w.requires_grad


class _QuadGather(torch.autograd.Function):
    """quad_gather with the weights' gradient from quad_gather_bwd_w."""

    @staticmethod
    def forward(ctx, table, idx, w, nc, nf, generic):
        ctx.save_for_backward(table, idx)
        ctx.shape = nc, nf
        return _gather(table, idx, w, nc, nf, generic)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        table, idx = ctx.saved_tensors
        dw = quad_gather_bwd_w(table, idx, g.contiguous(), *ctx.shape)
        return None, None, dw, None, None, None


def _gather(table, idx, w, nc, nf, generic):
    if table.device.type == "cpu":
        return quad_gather_ref(table, idx, w, nc, nf)
    return _launch(table, idx, w, nc, nf, generic)


def quad_gather(table, idx, w, nc, nf, generic=False):
    """table (NS, nc*nf) float32/float64; idx (N,) int32; w (N, nc) of the
    table's dtype; all contiguous on one device.  Returns (N, nf),
    differentiable in w."""
    _check_operands(table, idx, w, nc, nf, rows=False)
    obs.count("gather.queries", idx.shape[0])
    with obs.span("gather", op="quad_gather"):
        if _differentiable(table, w):
            return _QuadGather.apply(table, idx, w, nc, nf, generic)
        return _gather(table, idx, w, nc, nf, generic)


def quad_gather_bwd_w(table, idx, g, nc, nf, generic=False):
    """The gradient of quad_gather with respect to its weights, given the
    output's gradient g (N, nf): dw (N, nc).  The kernel on the card (the
    one `bwd_kernel` picks; `generic` forces the first design, for timing),
    the plain version on the CPU."""
    _check_operands(table, idx, g, nc, nf, rows=False, grad=True)
    obs.count("gather.queries", idx.shape[0])
    with obs.span("gather", op="quad_gather_bwd_w"):
        if table.device.type == "cpu":
            return quad_gather_bwd_w_ref(table, idx, g, nc, nf)
        n = idx.shape[0]
        dw = torch.empty((n, nc), dtype=table.dtype, device=table.device)
        kernel = bwd_kernel(nc, nf, _aligned(table, g, dw), generic)
        _launch_bwd("quad_gather_bwd_w", table, idx, g, dw,
                    (n, table.shape[0], nc, nf, _KERNELS.index(kernel)))
        _count_launch("quad_gather_bwd_w", kernel, table)
        return dw

TILED_SHAPES = ((4, 9), (2, 6), (4, 6), (4, 10), (4, 11), (2, 2), (4, 1))
WIDE_MIN_NF = 32
_KERNELS = ("tiled", "generic", "wide")


def _aligned(*tensors):
    """Whether every tensor starts on 16 bytes (the tiled kernels move
    16-byte pieces)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def gather_kernel(nc, nf, aligned, generic=False):
    """The quad_gather kernel for a (nc, nf) table: "tiled", "wide" or
    "generic".  `aligned`: table, weights and output start on 16 bytes."""
    if generic:
        return "generic"
    if (nc, nf) in TILED_SHAPES and aligned:
        return "tiled"
    if nf >= WIDE_MIN_NF and nc <= 32:
        return "wide"
    return "generic"


def bwd_kernel(nc, nf, aligned, generic=False):
    """The quad_gather_bwd_w kernel for a (nc, nf) table: "tiled" (the
    forward's tile pipeline) or "generic" (the first design, any shape).
    `aligned`: table, g and dw start on 16 bytes.  No gradient path
    launches the wide-row shapes, so there is no wide backward."""
    if generic or (nc, nf) not in TILED_SHAPES or not aligned:
        return "generic"
    return "tiled"


def quad_gather_rows_ref(table, idx, w, nc, nf):
    """Plain PyTorch version: the R gathered rows of each query, viewed
    (N, R, nc, nf), weighted and summed over rows and corners."""
    obs.count("quad_gather_rows_ref.calls")
    n, r = idx.shape
    rows = table[idx.long().reshape(-1)].view(n, r, nc, nf)
    return (rows * w[..., None]).sum((1, 2))


def quad_gather_rows_bwd_w_ref(table, idx, g, nc, nf):
    """Plain PyTorch version of the weights' gradient: (N, R, nc)."""
    obs.count("quad_gather_rows_bwd_w_ref.calls")
    n, r = idx.shape
    rows = table[idx.long().reshape(-1)].view(n, r, nc, nf)
    return (rows * g[:, None, None, :]).sum(-1)



class _QuadGatherRows(torch.autograd.Function):
    """quad_gather_rows with the weights' gradient from
    quad_gather_rows_bwd_w."""

    @staticmethod
    def forward(ctx, table, idx, w, nc, nf, simple, dedup):
        ctx.save_for_backward(table, idx)
        ctx.shape = nc, nf
        return _gather_rows(table, idx, w, nc, nf, simple, dedup)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        table, idx = ctx.saved_tensors
        dw = quad_gather_rows_bwd_w(table, idx, g.contiguous(), *ctx.shape)
        return None, None, dw, None, None, None, None


def quad_gather_rows(table, idx, w, nc, nf, simple=False, dedup=True):
    """table (NS, nc*nf) float32/float64; idx (N, R) int32; w (N, R, nc) of
    the table's dtype; all contiguous on one device.  Returns (N, nf),
    differentiable in w.  `simple` and `dedup` (lanes of a warp that name
    one row share its copy) only choose among the CUDA kernels."""
    _check_operands(table, idx, w, nc, nf, rows=True)
    obs.count("gather.queries", idx.shape[0])
    with obs.span("gather", op="quad_gather_rows"):
        if _differentiable(table, w):
            return _QuadGatherRows.apply(table, idx, w, nc, nf, simple,
                                         dedup)
        return _gather_rows(table, idx, w, nc, nf, simple, dedup)


def quad_gather_rows_bwd_w(table, idx, g, nc, nf, simple=False):
    """The gradient of quad_gather_rows with respect to its weights, given
    the output's gradient g (N, nf): dw (N, R, nc).  The kernel on the card
    (the one `rows_bwd_kernel` picks; `simple` forces the first design, for
    timing), the plain version on the CPU."""
    _check_operands(table, idx, g, nc, nf, rows=True, grad=True)
    obs.count("gather.queries", idx.shape[0])
    with obs.span("gather", op="quad_gather_rows_bwd_w"):
        if table.device.type == "cpu":
            return quad_gather_rows_bwd_w_ref(table, idx, g, nc, nf)
        n, r = idx.shape
        dw = torch.empty((n, r, nc), dtype=table.dtype, device=table.device)
        kernel = rows_bwd_kernel(r, nc, nf, table.element_size(),
                                 _aligned(table, g), simple)
        _launch_bwd("quad_gather_rows_bwd_w", table, idx, g, dw,
                    (n, table.shape[0], r, nc, nf,
                     _ROWS_KERNELS.index(kernel)))
        _count_launch("quad_gather_rows_bwd_w", kernel, table)
        return dw


def _count_launch(wrapper, kernel, table):
    """Count one launch of `wrapper`, by kernel and by instantiation."""
    obs.count(f"{wrapper}.launches")
    obs.count(f"{wrapper}.launches.{kernel}")
    obs.count(f"{wrapper}.launches.{dtype_name(table)}")


def _launch_bwd(name, table, idx, g, dw, sizes):
    """Launch the backward kernel `name` on the current stream; `sizes`
    are the C function's size arguments and the kernel variant."""
    lib = load_library()
    fn = getattr(lib, name + ("_f64" if table.dtype == torch.float64
                              else "_f32"))
    err = error_flag(table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), idx.data_ptr(), g.data_ptr(), dw.data_ptr(),
                err.data_ptr(), *sizes, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _gather_rows(table, idx, w, nc, nf, simple, dedup):
    if table.device.type == "cpu":
        return quad_gather_rows_ref(table, idx, w, nc, nf)
    lib = load_library()
    n, r = idx.shape
    out = torch.empty((n, nf), dtype=table.dtype, device=table.device)
    err = error_flag(table.device)
    kernel = rows_kernel(r, nc, nf, table.element_size(),
                         table.data_ptr() % 16 == 0, simple)
    fn = (lib.quad_gather_rows_f64 if table.dtype == torch.float64
          else lib.quad_gather_rows_f32)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                out.data_ptr(), err.data_ptr(), n, table.shape[0], r, nc, nf,
                _ROWS_KERNELS.index(kernel), int(dedup), stream)
    if rc != 0:
        raise RuntimeError(f"quad_gather_rows launch failed: CUDA error {rc}")
    _count_launch("quad_gather_rows", kernel, table)
    return out


# (R, nc): the snapshot's trilinear cell, slow light, HARMPI.  The binned
# populations (R = 8 or 4 of nc = 1) take the simple kernel: their ~1e5
# queries leave the persistent blocks too few tiles to pipeline, and the
# tiled kernel measured no faster there (PERF.md)
ROWS_TILED_SHAPES = ((4, 2), (8, 2), (1, 1))
ROWS_MAX_ROW_BYTES = 256    # two tiles of rows in shared memory
_ROWS_KERNELS = ("tiled", "simple")


def rows_kernel(r, nc, nf, itemsize, table_aligned, simple=False):
    """The quad_gather_rows kernel for R rows of a (nc, nf) table of
    `itemsize`-byte elements: "tiled" where each row is a whole number of
    16-byte pieces (the bulk copy's unit) of a 16-byte aligned table,
    "simple" otherwise."""
    rowbytes = nc * nf * itemsize
    if simple or (r, nc) not in ROWS_TILED_SHAPES or not table_aligned \
            or rowbytes % 16 or rowbytes > ROWS_MAX_ROW_BYTES:
        return "simple"
    return "tiled"


# The quad_gather_rows_bwd_w kernel: the forward's rule, "tiled" (the
# bulk-copy pipeline with the weights' epilogue) or "simple" (the first
# design); `table_aligned` then says that table and g start on 16 bytes
# (the wrapper's dw always does)
rows_bwd_kernel = rows_kernel


def error_flag(device):
    """The int32 device flag the kernel sets on an out-of-range index."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    flag = _err_flags.get(device)
    if flag is None:
        flag = _err_flags[device] = torch.zeros(1, dtype=torch.int32,
                                                device=device)
    return flag


def _launch(table, idx, w, nc, nf, generic):
    lib = load_library()
    n = idx.shape[0]
    out = torch.empty((n, nf), dtype=table.dtype, device=table.device)
    err = error_flag(table.device)
    # the tiled kernel moves 16-byte pieces; the others take any alignment
    kernel = gather_kernel(nc, nf, _aligned(table, w, out), generic)
    variant = _KERNELS.index(kernel)
    fn = (lib.quad_gather_f64 if table.dtype == torch.float64
          else lib.quad_gather_f32)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                out.data_ptr(), err.data_ptr(), n, table.shape[0], nc, nf,
                variant, stream)
    if rc != 0:
        raise RuntimeError(f"quad_gather launch failed: CUDA error {rc}")
    _count_launch("quad_gather", kernel, table)
    return out


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source=SOURCE):
    """Path of the compiled kernel library for the current source (or
    another version of it, `source`)."""
    digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libquad_gather_{digest}.so"


def build(source=SOURCE):
    """Compile csrc/quad_gather.cu (or another version of it, `source`,
    for scripts/kernel_ab.py) for sm_90a unless the library for this
    source exists.  Returns the library path; the compiler's output
    (ptxas register and spill report) is kept beside it as a .log."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    obs.count("kernel_builds")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C interface's argument types, by function (the _f32 and _f64 alike):
# table, idx, x, out, err, then the sizes, the variant and the stream
ARGTYPES = {
    "quad_gather": [_P] * 5 + [_LL, _I, _I, _I, _I, _P],
    "quad_gather_rows": [_P] * 5 + [_LL, _LL, _I, _I, _I, _I, _I, _P],
    "quad_gather_bwd_w": [_P] * 5 + [_LL, _LL, _I, _I, _I, _P],
    "quad_gather_rows_bwd_w": [_P] * 5 + [_LL, _LL, _I, _I, _I, _I, _P],
}


def bind(lib, names=tuple(ARGTYPES)):
    """Give the library's functions `names` their ctypes signatures."""
    for name in names:
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = ARGTYPES[name]
            fn.restype = ctypes.c_int
    return lib


def load_library():
    """Build (if needed) and load the kernel library with its ctypes
    signatures."""
    global _lib
    if _lib is None:
        with obs.setup("kernels") as rec:
            rec.attrs["built"] = not library_path().exists()
            _lib = bind(ctypes.CDLL(str(build())))
    return _lib
