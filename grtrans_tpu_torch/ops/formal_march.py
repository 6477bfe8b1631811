"""The formal / lsoda Stokes march of observed_stokes as one CUDA kernel.

    out = formal_march(lam, j, K, cell_ok, I0, substeps, dlam64)

computes what integrate.solvers.formal_solve(..., profile=False) computes
after its prologue (passivity_clamp, _cell_tau_mask), in one launch on the
card: each pixel's cells from the far end to the observer, each cell cut
into `substeps`, each substep's matricant map applied to the running Stokes
vector (csrc/formal_march.cu, which says what it replaces and what bounds
it).  Its plain twin is the torch march, solvers._march fed by
solvers._formal_maps, which formal_solve takes on the CPU, under a recorded
gradient, for the per-sample profile and for DELO; formal_solve decides,
this wrapper only launches: it raises on operands the kernel does not take
and has no CPU mode.

The library is built with nvcc on first use and loaded by ops/_build (the
set-up span "setup.kernels", the counter "kernel_builds").  Each launch counts
"march.kernel.launches" and "march.kernel.launches.<f64|f32>".
"""

import ctypes
from pathlib import Path

import torch

from grtrans_tpu_torch import obs
from grtrans_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "formal_march.cu"
# no fused multiply-add: every product and sum rounds as torch's separate
# operations round them (the source says why)
NVCC_FLAGS = ("-fmad=false",)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# lam, j, K, ok, I0, dlam64, out, then npix, npts, substeps and the stream
ARGTYPES = {f"formal_march_{sfx}": [_P] * 7 + [_LL, _I, _I, _P]
            for sfx in ("f32", "f64")}


def check_operands(lam, j, K, cell_ok, I0, dlam64):
    """Raise unless lam (npix, npts), j (npix, npts, 4) and K (npix, npts, 7)
    share a dtype, float64, or float32 with dlam64 (npix, npts - 1) float64;
    cell_ok (npix, npts - 1) bool; I0 None or (npix, 4) of the dtype; all
    contiguous on one CUDA device."""
    if lam.dim() != 2 or lam.shape[1] < 1:
        raise ValueError(f"lam must be (npix, npts), got {tuple(lam.shape)}")
    npix, npts = lam.shape
    dtype = lam.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lam dtype {dtype} not supported")
    want = {"j": (j, (npix, npts, 4), dtype),
            "K": (K, (npix, npts, 7), dtype),
            "cell_ok": (cell_ok, (npix, npts - 1), torch.bool)}
    if I0 is not None:
        want["I0"] = (I0, (npix, 4), dtype)
    if (dtype == torch.float32) != (dlam64 is not None):
        raise TypeError("dlam64 is required with float32 coefficients and "
                        "taken with no other")
    if dlam64 is not None:
        want["dlam64"] = (dlam64, (npix, npts - 1), torch.float64)
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = [lam] + [t for t, _, _ in want.values()]
    if any(t.device != lam.device for t in tensors):
        raise ValueError("the march's operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the march's operands must be contiguous")
    if lam.device.type != "cuda":
        raise NotImplementedError(
            f"no march kernel for {lam.device}: formal_solve takes the torch "
            "march there")


def formal_march(lam, j, K, cell_ok, I0=None, substeps=1, dlam64=None):
    """The observer's Stokes vector (npix, 4) of the formal march with
    `substeps` a cell, launched on the current stream (no sync)."""
    check_operands(lam, j, K, cell_ok, I0, dlam64)
    if substeps < 1:
        raise ValueError(f"substeps must be at least 1, got {substeps}")
    npix, npts = lam.shape
    out = torch.empty((npix, 4), dtype=lam.dtype, device=lam.device)
    name = "f64" if lam.dtype == torch.float64 else "f32"
    lib = _build.load(SOURCE, NVCC_FLAGS, ARGTYPES)
    _build.launch(getattr(lib, "formal_march_" + name), lam.device,
                  lam.data_ptr(), j.data_ptr(), K.data_ptr(),
                  cell_ok.data_ptr(), None if I0 is None else I0.data_ptr(),
                  None if dlam64 is None else dlam64.data_ptr(),
                  out.data_ptr(), npix, npts, int(substeps))
    obs.count("march.kernel.launches")
    obs.count(f"march.kernel.launches.{name}")
    return out
