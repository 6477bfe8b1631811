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

The kernel is chosen from what the call shows, its shape, dtype and
alignment, and from nothing else.  quad_gather has three kernels: a tiled
one for the narrow shapes in use, `TILED_SHAPES` (FFJET 4x9, the
POLSYNCHPL cutoff table 2x6 and its per-sample-p form 4x6, HARM 4x10,
KORAL 4x11, SPHACC 2x2, NUMDISK 4x1), which needs 16-byte aligned
operands; a wide-row one (a warp a query) for nf >= `WIDE_MIN_NF`
(PHATDISK's 2x101); and a generic one (one thread per output element)
for everything else.  `gather_kernel` picks.

quad_gather_rows has two: a tiled one (persistent blocks, the rows of a
tile copied to shared memory by Hopper bulk copies, two tiles in flight,
lanes of a warp that name one row sharing its copy) for the (R, nc) of
`ROWS_TILED_SHAPES` with rows that are whole 16-byte pieces of a 16-byte
aligned table, and the simple one (sixteen lanes a query) for anything
else, the binned populations among them.  `rows_kernel` picks.

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
design (a thread a weight, any shape or alignment), "generic" for R = 1
and "simple" for rows.  `bwd_kernel` / `rows_bwd_kernel` pick.

The library is built with nvcc on first use and loaded by ops/_build (the
set-up span "setup.kernels"; the counter "kernel_builds" counts nvcc
runs).  Each of the four wrappers is the span "gather" and counts its
queries ("gather.queries") and, in the obs counters, its kernel launches
("<wrapper>.launches"), split by kernel ("<wrapper>.launches.tiled", ...)
and by instantiation ("<wrapper>.launches.f64", "<wrapper>.launches.f32").
The plain twins count their calls ("<twin>.calls"), so that a run can show
that no path on the card reached them.
"""

import ctypes
from pathlib import Path

import numpy as np
import torch

from grtrans_tpu_torch import obs
from grtrans_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "quad_gather.cu"
NVCC_FLAGS = ()

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C interface's argument types (the _f32 and _f64 alike): table, idx,
# x, out, err, then the sizes, the kernel variant and the stream
ARGTYPES = {f"{name}_{sfx}": argtypes
            for sfx in ("f32", "f64")
            for name, argtypes in (
                ("quad_gather", [_P] * 5 + [_LL, _I, _I, _I, _I, _P]),
                ("quad_gather_rows", [_P] * 5 + [_LL, _LL, _I, _I, _I, _I,
                                                 _P]),
                ("quad_gather_bwd_w", [_P] * 5 + [_LL, _LL, _I, _I, _I, _P]),
                ("quad_gather_rows_bwd_w", [_P] * 5 + [_LL, _LL, _I, _I, _I,
                                                       _I, _P]))}

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


def quad_gather(table, idx, w, nc, nf):
    """table (NS, nc*nf) float32/float64; idx (N,) int32; w (N, nc) of the
    table's dtype; all contiguous on one device.  Returns (N, nf),
    differentiable in w."""
    _check_operands(table, idx, w, nc, nf, rows=False)
    return _call("quad_gather", quad_gather_ref, gather_kernel, table, idx,
                 w, nc, nf, backward=quad_gather_bwd_w)


def quad_gather_rows(table, idx, w, nc, nf):
    """table (NS, nc*nf) float32/float64; idx (N, R) int32; w (N, R, nc) of
    the table's dtype; all contiguous on one device.  Returns (N, nf),
    differentiable in w."""
    _check_operands(table, idx, w, nc, nf, rows=True)
    return _call("quad_gather_rows", quad_gather_rows_ref, rows_kernel,
                 table, idx, w, nc, nf, backward=quad_gather_rows_bwd_w)


def quad_gather_bwd_w(table, idx, g, nc, nf):
    """The gradient of quad_gather with respect to its weights, given the
    output's gradient g (N, nf): dw (N, nc).  The kernel `bwd_kernel`
    picks on the card, the plain version on the CPU."""
    _check_operands(table, idx, g, nc, nf, rows=False, grad=True)
    return _call("quad_gather_bwd_w", quad_gather_bwd_w_ref, bwd_kernel,
                 table, idx, g, nc, nf)


def quad_gather_rows_bwd_w(table, idx, g, nc, nf):
    """The gradient of quad_gather_rows with respect to its weights, given
    the output's gradient g (N, nf): dw (N, R, nc).  The kernel
    `rows_bwd_kernel` picks on the card, the plain version on the CPU."""
    _check_operands(table, idx, g, nc, nf, rows=True, grad=True)
    return _call("quad_gather_rows_bwd_w", quad_gather_rows_bwd_w_ref,
                 rows_bwd_kernel, table, idx, g, nc, nf)


def _call(op, twin, pick, table, idx, x, nc, nf, backward=None):
    """The checked wrapper `op` on the weights (or, for a backward wrapper,
    with no `backward` of its own, the output's gradient) x: counted and
    spanned; recorded for autograd, with `backward` the weights' gradient,
    where the weights require one.  `twin` and `pick` as _run."""
    obs.count("gather.queries", idx.shape[0])
    with obs.span("gather", op=op):
        if backward is not None and _differentiable(table, x):
            return _Gather.apply(op, twin, pick, backward, table, idx, x,
                                 nc, nf)
        return _run(op, twin, pick, backward is None, table, idx, x, nc, nf)


class _Gather(torch.autograd.Function):
    """A forward wrapper with the weights' gradient from its backward
    wrapper."""

    @staticmethod
    def forward(ctx, op, twin, pick, backward, table, idx, w, nc, nf):
        ctx.save_for_backward(table, idx)
        ctx.backward = backward
        ctx.shape = nc, nf
        return _run(op, twin, pick, False, table, idx, w, nc, nf)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        table, idx = ctx.saved_tensors
        dw = ctx.backward(table, idx, g.contiguous(), *ctx.shape)
        return None, None, None, None, None, None, dw, None, None


def _run(op, twin, pick, grad, table, idx, x, nc, nf):
    """The plain `twin` on the CPU; on the card, one launch of `op`'s
    kernel that `pick` chooses for this shape, dtype and alignment, into a
    new output (dw where `grad`: x is then the output's gradient),
    counted."""
    if table.device.type == "cpu":
        return twin(table, idx, x, nc, nf)
    n, ns = idx.shape[0], table.shape[0]
    out = torch.empty((*idx.shape, nc) if grad else (n, nf),
                      dtype=table.dtype, device=table.device)
    if idx.dim() == 2:
        r = idx.shape[1]
        # the bulk copy reads the table's rows (and, backward, g) in
        # 16-byte pieces; out is new, so always aligned
        kernel = pick(r, nc, nf, table.element_size(),
                      _aligned(table, x) if grad else _aligned(table))
        sizes = (n, ns, r, nc, nf, _ROWS_KERNELS.index(kernel))
    else:
        kernel = pick(nc, nf, _aligned(table, x, out))
        sizes = (n, ns, nc, nf, _KERNELS.index(kernel))
    lib = _build.load(SOURCE, NVCC_FLAGS, ARGTYPES)
    _build.launch(getattr(lib, f"{op}_{dtype_name(table)}"), table.device,
                  table.data_ptr(), idx.data_ptr(), x.data_ptr(),
                  out.data_ptr(), error_flag(table.device).data_ptr(),
                  *sizes)
    obs.count(f"{op}.launches")
    obs.count(f"{op}.launches.{kernel}")
    obs.count(f"{op}.launches.{dtype_name(table)}")
    return out


TILED_SHAPES = ((4, 9), (2, 6), (4, 6), (4, 10), (4, 11), (2, 2), (4, 1))
WIDE_MIN_NF = 32
_KERNELS = ("tiled", "generic", "wide")


def _aligned(*tensors):
    """Whether every tensor starts on 16 bytes (the tiled kernels move
    16-byte pieces)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def gather_kernel(nc, nf, aligned):
    """The quad_gather kernel for a (nc, nf) table: "tiled", "wide" or
    "generic".  `aligned`: table, weights and output start on 16 bytes."""
    if (nc, nf) in TILED_SHAPES and aligned:
        return "tiled"
    if nf >= WIDE_MIN_NF and nc <= 32:
        return "wide"
    return "generic"


def bwd_kernel(nc, nf, aligned):
    """The quad_gather_bwd_w kernel for a (nc, nf) table: "tiled" (the
    forward's tile pipeline) or "generic" (the first design, any shape).
    `aligned`: table, g and dw start on 16 bytes.  No gradient path
    launches the wide-row shapes, so there is no wide backward."""
    if (nc, nf) not in TILED_SHAPES or not aligned:
        return "generic"
    return "tiled"


# (R, nc): the snapshot's trilinear cell, slow light, HARMPI.  The binned
# populations (R = 8 or 4 of nc = 1) take the simple kernel: their ~1e5
# queries leave the persistent blocks too few tiles to pipeline, and the
# tiled kernel measured no faster there (PERF.md)
ROWS_TILED_SHAPES = ((4, 2), (8, 2), (1, 1))
ROWS_MAX_ROW_BYTES = 256    # two tiles of rows in shared memory
_ROWS_KERNELS = ("tiled", "simple")


def rows_kernel(r, nc, nf, itemsize, table_aligned):
    """The quad_gather_rows kernel for R rows of a (nc, nf) table of
    `itemsize`-byte elements: "tiled" where each row is a whole number of
    16-byte pieces (the bulk copy's unit) of a 16-byte aligned table,
    "simple" otherwise."""
    rowbytes = nc * nf * itemsize
    if (r, nc) not in ROWS_TILED_SHAPES or not table_aligned \
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
