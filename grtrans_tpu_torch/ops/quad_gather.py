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

quad_gather has three kernels: a tiled one for the renderer's two narrow
shapes, (nc, nf) = (4, 9) and (2, 6), which needs 16-byte aligned
operands; a wide-row one (a warp a query) for nf >= 32; and a generic one
(one thread per output element) for everything else.  The wrapper picks
by shape and alignment; `generic=True` forces the generic kernel so that
it can be timed against the others.

The library is compiled with nvcc on first use into
grtrans_tpu_torch/_build/, keyed by a hash of its source, and bound with
ctypes.  `quad_gather.launches` and `quad_gather_rows.launches` count
kernel launches; `quad_gather.launches_by_kernel` splits the first by
kernel.
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


def bilinear_packed(table, n2, nf, i1, i2, w1, w2):
    """Bilinear sample of a pack_corners_2d table at cells (i1, i2) with
    fractional weights (w1, w2) along the two axes, through quad_gather.
    Returns i1.shape + (nf,)."""
    w = torch.stack([(1 - w1) * (1 - w2), w1 * (1 - w2),
                     (1 - w1) * w2, w1 * w2], dim=-1).reshape(-1, 4)
    out = quad_gather(table, (i1 * n2 + i2).reshape(-1), w.contiguous(), 4,
                      nf)
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

TILED_SHAPES = ((4, 9), (2, 6))
WIDE_MIN_NF = 32
_KERNELS = ("tiled", "generic", "wide")


def quad_gather_rows_ref(table, idx, w, nc, nf):
    """Plain PyTorch version: the R gathered rows of each query, viewed
    (N, R, nc, nf), weighted and summed over rows and corners."""
    n, r = idx.shape
    rows = table[idx.long().reshape(-1)].view(n, r, nc, nf)
    return (rows * w[..., None]).sum((1, 2))


def quad_gather_rows(table, idx, w, nc, nf):
    """table (NS, nc*nf) float32/float64; idx (N, R) int32; w (N, R, nc) of
    the table's dtype; all contiguous on one device.  Returns (N, nf)."""
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
    fn = (lib.quad_gather_rows_f64 if table.dtype == torch.float64
          else lib.quad_gather_rows_f32)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                out.data_ptr(), err.data_ptr(), n, table.shape[0], r, nc, nf,
                stream)
    if rc != 0:
        raise RuntimeError(f"quad_gather_rows launch failed: CUDA error {rc}")
    quad_gather_rows.launches += 1
    return out


quad_gather_rows.launches = 0


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
    if generic:
        variant = 1
    elif (nc, nf) in TILED_SHAPES and aligned:
        variant = 0
    elif nf >= WIDE_MIN_NF and nc <= 32:
        variant = 2
    else:
        variant = 1
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
    quad_gather.launches_by_kernel[_KERNELS[variant]] += 1
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
                           ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
