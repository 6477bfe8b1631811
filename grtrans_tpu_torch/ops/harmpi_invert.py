"""HARMPI's jetcoords sample inversion as two CUDA kernels.

    x1 = x1_of_r(r, p)                    # calcrmks inverted
    x2 = x2_of_th_bl3(th, r, p)           # calcthmksbl3 inverted in x2

compute what fluid.harmpi's torch bisections (thickdisk.bisect over
calcrmks and calcthmksbl3) compute, in one launch each on the card: one
thread a sample runs the whole bisection in registers
(csrc/harmpi_invert.cu, which says what it replaces and what bounds it).
They take float64 and float32 (prec="mixed"), each in the arithmetic of
torch's kernels of that dtype.  Their plain twins are
fluid.harmpi.x1_of_r_twin and x2_of_th_bl3_twin, which fluid.harmpi takes
on the CPU; fluid.harmpi decides, this wrapper only launches: it raises on
operands the kernels do not take and has no CPU mode.

r and th are read contiguous (a strided view is copied first); the output
is a new contiguous tensor of r's shape and dtype.

The library is built with nvcc on first use and loaded by ops/_build (the
set-up span "setup.kernels", the counter "kernel_builds").  Each launch counts
"harmpi.invert.kernel.launches".
"""

import ctypes
import functools
from pathlib import Path

import torch

from grtrans_tpu_torch import obs
from grtrans_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "harmpi_invert.cu"
# no fused multiply-add: every product and sum rounds as torch's separate
# operations round them (the source says why)
NVCC_FLAGS = ("-fmad=false",)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the kernels' dtypes: (entry point suffix, ctypes scalar)
SCALARS = {torch.float64: ("f64", ctypes.c_double),
           torch.float32: ("f32", ctypes.c_float)}
# x1: r, out, n, params, lo, hi, iters, stream; x2: th, r, out, n, params,
# iters, stream; and the length of struct Params
ARGTYPES = {name.format(sfx): argtypes
            for sfx, T in SCALARS.values()
            for name, argtypes in (
                ("harmpi_x1_of_r_{}", [_P, _P, _LL, _P, T, T, _I, _P]),
                ("harmpi_x2_of_th_{}", [_P, _P, _P, _LL, _P, _I, _P]))}
ARGTYPES["harmpi_invert_num_params"] = []


@functools.cache
def _library():
    """The inversion's library (ops/_build.load), its struct Params held
    to PARAMS once."""
    lib = _build.load(SOURCE, NVCC_FLAGS, ARGTYPES)
    n = lib.harmpi_invert_num_params()
    if n != len(PARAMS):
        raise RuntimeError(f"{SOURCE.name} takes {n} parameters, the "
                           f"wrapper makes {len(PARAMS)}")
    return lib


# the order of csrc/harmpi_invert.cu's struct Params
PARAMS = ("R0", "xbr", "cpow2", "npow2", "fracdisk", "inv_band",
          "inv_r0disk", "r0disk_grid", "r0grid", "drdisk", "hdrdisk",
          "inv_hdrdisk", "e1disk", "e2disk", "inv_r0jet", "r0jet_grid",
          "drjet", "hdrjet", "inv_hdrjet", "e1jet", "e2jet")


def kernel_params(p, dtype=torch.float64):
    """The kernels' scalars from BL3Params `p` in `dtype`, each as the
    twin's torch operations of that dtype receive it: Python floats formed
    as fluid.harmpi forms them, and for each division of a tensor by a
    Python float the float's reciprocal, by which torch multiplies on the
    card; torch computes that reciprocal in float64 and casts it, as it
    casts every other scalar, to the tensor's dtype."""
    drdisk = p.rdiskend / p.r0disk
    drjet = p.rjetend / p.r0jet
    v = dict(R0=p.R0, xbr=p.xbr, cpow2=p.cpow2, npow2=p.npow2,
             fracdisk=p.fracdisk,
             inv_band=1.0 / ((1 - p.fracjet) - p.fracdisk),
             inv_r0disk=1.0 / p.r0disk, r0disk_grid=p.r0disk / p.r0grid,
             r0grid=p.r0grid, drdisk=drdisk, hdrdisk=0.5 * drdisk,
             inv_hdrdisk=1.0 / (0.5 * drdisk), e1disk=0.5 * p.disknu1,
             e2disk=0.5 * p.disknu2, inv_r0jet=1.0 / p.r0jet,
             r0jet_grid=p.r0jet / p.r0grid, drjet=drjet, hdrjet=0.5 * drjet,
             inv_hdrjet=1.0 / (0.5 * drjet), e1jet=0.5 * p.jetnu1,
             e2jet=0.5 * p.jetnu2)
    scalar = SCALARS[dtype][1]
    return (scalar * len(PARAMS))(*(float(v[k]) for k in PARAMS))


def check_operands(*ts):
    """Raise unless every tensor is float64, or every one float32, of one
    shape, on one CUDA device."""
    first = ts[0]
    for t in ts:
        if t.dtype not in SCALARS or t.dtype != first.dtype:
            raise TypeError(f"the inversion kernels take float64 or float32 "
                            f"operands of one dtype, got {t.dtype} beside "
                            f"{first.dtype}")
        if t.shape != first.shape:
            raise ValueError(f"th and r must have one shape, got "
                             f"{tuple(first.shape)} and {tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError("the inversion's operands must be on one "
                             "device")
    if first.device.type != "cuda":
        raise NotImplementedError(
            f"no inversion kernel for {first.device}: fluid.harmpi takes "
            "the torch twin there")


def _launch(name, dtype, args, out):
    _build.launch(getattr(_library(), f"{name}_{SCALARS[dtype][0]}"),
                  out.device, *args)
    obs.count("harmpi.invert.kernel.launches")
    return out


def x1_of_r(r, p, lo=-2.0, hi=12.0, iters=60):
    """x1 with calcrmks(x1, p) = r by `iters` bisections on [lo, hi], one
    launch on the current stream (no sync)."""
    check_operands(r)
    out = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    if out.numel() == 0:
        return out
    r = r.detach().contiguous()
    return _launch("harmpi_x1_of_r", r.dtype,
                   (r.data_ptr(), out.data_ptr(), out.numel(),
                    kernel_params(p, r.dtype), lo, hi, int(iters)), out)


def x2_of_th_bl3(th, r, p, iters=60):
    """x2 with calcthmksbl3(x2, r, p) = th by `iters` bisections on
    [-1, 1], one launch on the current stream (no sync)."""
    check_operands(th, r)
    out = torch.empty(th.shape, dtype=th.dtype, device=th.device)
    if out.numel() == 0:
        return out
    th = th.detach().contiguous()
    r = r.detach().contiguous()
    return _launch("harmpi_x2_of_th", th.dtype,
                   (th.data_ptr(), r.data_ptr(), out.data_ptr(),
                    out.numel(), kernel_params(p, th.dtype), int(iters)),
                   out)
