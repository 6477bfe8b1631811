"""The thermal-synchrotron coefficients of a ray-integrating render as one
CUDA kernel.

    j, K, ok = render_polsynchth(x, k, valid, u, b, alpha, beta, n, bfield,
                                 te, a=, mu0=, fghz=, mbh=, coefindx=,
                                 rotate=, mixed=)

computes what driver.render_rays' torch code computes for ename
"POLSYNCHTH" between the fluid and solvers.observed_stokes, for one
observed frequency, in one launch on the card: one thread a sample runs the
comoving tetrad, render_rays' mask, polsynch.polsynchth, coefindx's zeroing,
the rotation (rotate, nvals = 4) and the invariant scaling with lbh in
registers (csrc/render_polsynchth.cu, which says what it replaces and what
bounds it).  Its plain twin is that torch code, which render_rays takes on
the CPU, under a recorded gradient, for debug, the thin disk and every
other emissivity; render_rays decides, this wrapper only launches: it
raises on operands the kernel does not take and has no CPU mode.

Operands: x, k, u, b (npix, npts, 4); valid (npix, npts) bool; alpha, beta
(npix,); n, bfield, te (npix, npts) in cgs.  float64 operands make the
float64 kernel.  mixed=True makes the float32 kernel (prec="mixed"), which
takes each operand rounded to float32, as render_rays' .float() rounds it,
and leaves out the samples within HOR_F32 r+ of the horizon.  Returns j
(npix, npts, 4), K (npix, npts, 7) of the kernel's dtype and ok (npix,
npts) bool, each new and contiguous.

The library is built with nvcc on first use and loaded by ops/_build (the
set-up span "setup.kernels", the counter "kernel_builds").  Each launch
counts "render.kernel.launches" and "render.kernel.launches.<f64|f32>".
"""

import ctypes
import functools
import math
from pathlib import Path

import torch

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch import obs
from grtrans_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "render_polsynchth.cu"
# no fused multiply-add: every product and sum rounds as torch's separate
# operations round them (the source says why)
NVCC_FLAGS = ("-fmad=false",)
# prec="mixed": samples closer than this (relative) to the outer horizon
# are left out of the float32 leg (the float32 kernel and
# driver.render_rays' torch code)
HOR_F32 = 1e-4

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the kernels' dtypes: (entry point suffix, ctypes scalar)
SCALARS = {torch.float64: ("f64", ctypes.c_double),
           torch.float32: ("f32", ctypes.c_float)}
# x, k, u, b, valid, alpha, beta, n, bfield, te, j, K, ok, then npix, npts,
# params, rotate and the stream; and the length of struct Params
ARGTYPES = {f"render_polsynchth_{sfx}": [_P] * 13 + [_LL, _I, _P, _I, _P]
            for sfx, _ in SCALARS.values()}
ARGTYPES["render_polsynchth_num_params"] = []

# the order of csrc/render_polsynchth.cu's struct Params
PARAMS = ("a", "aa", "delta_p", "delta_m", "m2a", "neg_a", "kap_c",
          "ang_lo", "ang_hi", "rh", "hor", "fghz", "lbh",
          *(f"mult{c}" for c in range(7)),
          "k", "inv_mc2", "c3e", "inv_4pimc", "cpref", "cjv", "h", "inv_c2",
          "c2h", "inv_c", "c2hc", "c4pi", "e2", "inv_m", "e", "inv_mc",
          "sqrt2", "two_pi", "log120", "cj")


@functools.cache
def _library():
    """The kernel's library (ops/_build.load), its struct Params held to
    PARAMS once."""
    lib = _build.load(SOURCE, NVCC_FLAGS, ARGTYPES)
    n = lib.render_polsynchth_num_params()
    if n != len(PARAMS):
        raise RuntimeError(f"{SOURCE.name} takes {n} parameters, the "
                           f"wrapper makes {len(PARAMS)}")
    return lib


def kernel_params(a, mu0, fghz, mbh, coefindx=None, dtype=torch.float64):
    """The kernel's scalars in `dtype`, each formed as render_rays' torch
    code forms the Python float that meets a tensor (kerr.metric_cov,
    tetrad.comoving_ortho, polsynch.polsynchth and bnu, render_rays), and for
    each division of a tensor by a Python float that float's reciprocal, by
    which torch multiplies on the card; torch computes that reciprocal in
    float64 and casts it, as it casts every other scalar, to the tensor's
    dtype."""
    h = math.sqrt(max(1.0 - a * a, 0.0))
    rh = 1.0 + math.sqrt(1.0 - a * a)
    mult = (1.0,) * 7 if coefindx is None else tuple(coefindx)
    if len(mult) != 7:
        raise ValueError(f"coefindx must have 7 entries, got {len(mult)}")
    v = dict(a=a, aa=a * a, delta_p=1.0 + h, delta_m=1.0 - h, m2a=-2.0 * a,
             neg_a=-a, kap_c=a * math.sqrt(1.0 - mu0 * mu0),
             ang_lo=-1.0 + 1e-8, ang_hi=1.0 - 1e-8, rh=rh, hor=HOR_F32 * rh,
             fghz=fghz, lbh=pc.lbh(mbh),
             **{f"mult{c}": m for c, m in enumerate(mult)},
             k=pc.k, inv_mc2=1.0 / (pc.m * pc.c2), c3e=3.0 * pc.e,
             inv_4pimc=1.0 / (4.0 * math.pi * pc.m * pc.c),
             cpref=pc.e ** 2 / pc.c / math.sqrt(3.0) / 2.0,
             cjv=4.0 * pc.e ** 2 / pc.c / 3.0 / math.sqrt(3.0), h=pc.h,
             inv_c2=1.0 / pc.c2, c2h=2.0 * pc.h, inv_c=1.0 / pc.c,
             c2hc=2.0 * pc.h / pc.c, c4pi=4.0 * math.pi, e2=pc.e ** 2,
             inv_m=1.0 / pc.m, e=pc.e, inv_mc=1.0 / (pc.m * pc.c),
             sqrt2=math.sqrt(2.0), two_pi=2.0 * math.pi,
             log120=math.log(120.0),
             cj=2.0 ** (-1.0 / 3.0) / 3.0 ** (23.0 / 6.0) * math.pi * 1e4)
    scalar = SCALARS[dtype][1]
    return (scalar * len(PARAMS))(*(float(v[k]) for k in PARAMS))


def check_operands(x, k, valid, u, b, alpha, beta, n, bfield, te, mixed):
    """Raise unless the operands have render_rays' shapes on one CUDA
    device, valid bool and the rest float64 (or, mixed, float32 or
    float64)."""
    if x.dim() != 3 or x.shape[-1] != 4:
        raise ValueError(f"x must be (npix, npts, 4), got {tuple(x.shape)}")
    npix, npts, _ = x.shape
    shapes = {"k": (k, (npix, npts, 4)), "u": (u, (npix, npts, 4)),
              "b": (b, (npix, npts, 4)), "valid": (valid, (npix, npts)),
              "alpha": (alpha, (npix,)), "beta": (beta, (npix,)),
              "n": (n, (npix, npts)), "bfield": (bfield, (npix, npts)),
              "te": (te, (npix, npts))}
    floats = (torch.float32, torch.float64) if mixed else (torch.float64,)
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("the render's operands must be on one device")
    for name, t in (("x", x), *((nm, t) for nm, (t, _) in shapes.items()
                                if nm != "valid")):
        if t.dtype not in floats:
            raise TypeError(f"{name}: the {'mixed' if mixed else 'float64'} "
                            f"kernel does not take {t.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"no render kernel for {x.device}: render_rays takes the torch "
            "code there")


def render_polsynchth(x, k, valid, u, b, alpha, beta, n, bfield, te, *, a,
                      mu0, fghz, mbh, coefindx=None, rotate=True,
                      mixed=False):
    """(j, K, ok) of one frequency fghz [Hz], one launch on the current
    stream (no sync)."""
    check_operands(x, k, valid, u, b, alpha, beta, n, bfield, te, mixed)
    dtype = torch.float32 if mixed else torch.float64
    x, k, u, b, alpha, beta, n, bfield, te = (
        t.detach().to(dtype).contiguous()
        for t in (x, k, u, b, alpha, beta, n, bfield, te))
    valid = valid.contiguous()
    npix, npts, _ = x.shape
    like = dict(dtype=dtype, device=x.device)
    j = torch.empty((npix, npts, 4), **like)
    K = torch.empty((npix, npts, 7), **like)
    ok = torch.empty((npix, npts), dtype=torch.bool, device=x.device)
    if ok.numel() == 0:
        return j, K, ok
    name = SCALARS[dtype][0]
    _build.launch(getattr(_library(), f"render_polsynchth_{name}"), x.device,
                  x.data_ptr(), k.data_ptr(), u.data_ptr(), b.data_ptr(),
                  valid.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                  n.data_ptr(), bfield.data_ptr(), te.data_ptr(),
                  j.data_ptr(), K.data_ptr(), ok.data_ptr(), npix, npts,
                  kernel_params(a, mu0, fghz, mbh, coefindx, dtype),
                  int(rotate))
    obs.count("render.kernel.launches")
    obs.count(f"render.kernel.launches.{name}")
    return j, K, ok
