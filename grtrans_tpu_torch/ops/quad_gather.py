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

The library is compiled with nvcc on first use into
grtrans_tpu_torch/_build/, keyed by a hash of its source, and bound with
ctypes.  `quad_gather.launches` and `quad_gather_rows.launches` count
kernel launches; `launches_by_kernel` of each splits them by kernel.
"""

import collections

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "quad_gather.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_lib = None
_err_flags = {}


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
    fractional weights (w1, w2) along the two axes, through quad_gather.
    Returns i1.shape + (nf,)."""
    out = quad_gather(table, *bilinear_operands(n2, i1, i2, w1, w2), 4, nf)
    return out.reshape(i1.shape + (nf,))


def quad_gather_ref(table, idx, w, nc, nf):
    """Plain PyTorch version: (table[idx].view(N, nc, nf) * w).sum(corners)."""
    n = idx.shape[0]
    return (table[idx.long()].view(n, nc, nf) * w[..., None]).sum(-2)


def quad_gather(table, idx, w, nc, nf, generic=False):
    """table (NS, nc*nf) float32/float64; idx (N,) int32; w (N, nc) of the
    table's dtype; all contiguous on one device.  Returns (N, nf)."""
    if table.dim() != 2 or table.shape[1] != nc * nf:
        raise ValueError(f"table must be (NS, {nc * nf}), got "
                         f"{tuple(table.shape)}")
    if table.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"table dtype {table.dtype} not supported")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError("idx must be a 1-D int32 tensor")
    if w.shape != (idx.shape[0], nc) or w.dtype != table.dtype:
        raise ValueError(f"w must be ({idx.shape[0]}, {nc}) {table.dtype}, "
                         f"got {tuple(w.shape)} {w.dtype}")
    if not (table.device == idx.device == w.device):
        raise ValueError("table, idx and w must be on one device")
    if not (table.is_contiguous() and idx.is_contiguous()
            and w.is_contiguous()):
        raise ValueError("table, idx and w must be contiguous")
    if table.device.type == "cpu":
        return quad_gather_ref(table, idx, w, nc, nf)
    if table.device.type != "cuda":
        raise NotImplementedError(f"no quad_gather for {table.device}")
    return _launch(table, idx, w, nc, nf, generic)


quad_gather.launches = 0
quad_gather.launches_by_kernel = collections.Counter()

TILED_SHAPES = ((4, 9), (2, 6), (4, 6), (4, 10), (4, 11), (2, 2), (4, 1))
WIDE_MIN_NF = 32
_KERNELS = ("tiled", "generic", "wide")


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


def quad_gather_rows_ref(table, idx, w, nc, nf):
    """Plain PyTorch version: the R gathered rows of each query, viewed
    (N, R, nc, nf), weighted and summed over rows and corners."""
    n, r = idx.shape
    rows = table[idx.long().reshape(-1)].view(n, r, nc, nf)
    return (rows * w[..., None]).sum((1, 2))


def quad_gather_rows(table, idx, w, nc, nf, simple=False, dedup=True):
    """table (NS, nc*nf) float32/float64; idx (N, R) int32; w (N, R, nc) of
    the table's dtype; all contiguous on one device.  Returns (N, nf).
    `simple` and `dedup` (lanes of a warp that name one row share its
    copy) only choose among the CUDA kernels."""
    if table.dim() != 2 or table.shape[1] != nc * nf:
        raise ValueError(f"table must be (NS, {nc * nf}), got "
                         f"{tuple(table.shape)}")
    if table.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"table dtype {table.dtype} not supported")
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise TypeError("idx must be a 2-D int32 tensor")
    if w.shape != (*idx.shape, nc) or w.dtype != table.dtype:
        raise ValueError(f"w must be {(*idx.shape, nc)} {table.dtype}, "
                         f"got {tuple(w.shape)} {w.dtype}")
    if not (table.device == idx.device == w.device):
        raise ValueError("table, idx and w must be on one device")
    if not (table.is_contiguous() and idx.is_contiguous()
            and w.is_contiguous()):
        raise ValueError("table, idx and w must be contiguous")
    if table.device.type == "cpu":
        return quad_gather_rows_ref(table, idx, w, nc, nf)
    if table.device.type != "cuda":
        raise NotImplementedError(f"no quad_gather_rows for {table.device}")
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
    quad_gather_rows.launches += 1
    quad_gather_rows.launches_by_kernel[kernel] += 1
    return out


quad_gather_rows.launches = 0
quad_gather_rows.launches_by_kernel = collections.Counter()

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
    aligned = all(t.data_ptr() % 16 == 0 for t in (table, w, out))
    kernel = gather_kernel(nc, nf, aligned, generic)
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
    quad_gather.launches += 1
    quad_gather.launches_by_kernel[kernel] += 1
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


def library_path():
    """Path of the compiled kernel library for the current source."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libquad_gather_{digest}.so"


def build():
    """Compile csrc/quad_gather.cu for sm_90a unless the library for this
    source exists.  Returns the library path; the compiler's output
    (ptxas register and spill report) is kept beside it as a .log."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


def load_library():
    """Build (if needed) and load the kernel library with its ctypes
    signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr = ctypes.c_void_p
        for name in ("quad_gather_f32", "quad_gather_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        for name in ("quad_gather_rows_f32", "quad_gather_rows_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
