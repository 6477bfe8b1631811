"""Inverse rendering: fit physical parameters to a target IQUV image by
gradient descent through the whole renderer.

Port of grtrans_tpu/tools/invert.py.  The loss closes over a fixed camera
pixel grid (alpha, beta); the photon constants (l, q2) are recomputed
inside the render from the spin and mu0 (geodesics/camera.py
`constants_of_motion`), so that the gradient flows through the photon
initial conditions as well as the Kerr geometry, the fluid sample, the
tetrad, the coefficients and the Stokes march.  Reverse mode through
autograd: the two table gathers differentiate through their own backward
kernels (ops/quad_gather.py).  Parameters are fitted in transformed
coordinates (log for positive scales, atanh for the bounded spin and
cos-inclination) so that the optimizer is unconstrained; the optimizer is
torch.optim.Adam, whose update and defaults are optax.adam's.
"""

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from grtrans_tpu_torch import driver
from grtrans_tpu_torch.fluid.base import SourceParams, load_fluid_model
from grtrans_tpu_torch.geodesics import camera as cam_mod
from grtrans_tpu_torch.geodesics import geokerr


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def _cache_key(kwargs):
    """The load kwargs as a key: numbers and strings by value, anything
    unhashable (a snapshot's dict of arrays) by identity."""
    def one(v):
        if torch.is_tensor(v):
            return ("tensor", id(v))
        try:
            hash(v)
        except TypeError:
            return ("object", id(v))
        return v
    return tuple(sorted((k, one(v)) for k, v in kwargs.items()))


@dataclass
class InverseProblem:
    """A differentiable forward model.

    fname / ename / iname / freq / mbh / nn / gridvals / nvals: the render
    configuration (the pixel grid is built once from gridvals; alpha and
    beta do not depend on the spin).  A parameter is "spin", "mu0" or any
    keyword of the fluid model's loader; `fixed` holds the values of those
    not fitted.  Port additions: `source`, further SourceParams fields
    besides mbh (a snapshot's mdot, mu, gmin); `uout`, where the rays
    start (default: the camera, as grtrans_tpu); `model`, a loaded model
    that a geometry-only fit renders through (a snapshot loaded once);
    `device`, where the render runs (the card unless the caller names the
    CPU).  prec="mixed" renders as grtrans_tpu's does: the trace in
    float32 (geokerr.trace), the fluid, coefficients and march in float32
    (driver.render_rays); the gathers' weights then take their gradient
    from the float32 backward kernels.  The trace runs its inversions at
    every 4th point only from 256 points a ray, as grtrans_run does;
    grtrans_tpu's InverseProblem does so at any length, and at 64 points
    that fill moves the 16x16x64 flagship image by 1.1e-3 of its maximum
    and d/dspin by 40% (measured)."""
    fname: str = "SARIAF"
    ename: str = "POLSYNCHTH"
    iname: str = "formal"
    freq: float = 2.3e11
    mbh: float = 4e6
    nn: tuple = (8, 8, 32)
    gridvals: tuple = (-12.0, 12.0, -12.0, 12.0)
    nvals: int = 4
    prec: str = "f64"
    fixed: Dict[str, Any] = field(default_factory=dict)
    source: Dict[str, Any] = field(default_factory=dict)
    uout: Optional[float] = None
    model: Any = None
    device: Any = "cuda"

    def __post_init__(self):
        if self.prec not in ("f64", "mixed"):
            raise ValueError(f"prec={self.prec!r}: \"f64\" or \"mixed\"")
        nro, nphi, self.npts = self.nn
        a1, a2, b1, b2 = self.gridvals
        self.device = torch.device(self.device)
        # the pixel grid only: l and q2 are recomputed from (spin, mu0)
        cam = cam_mod.make_camera(0.5, 0.5, a1, a2, b1, b2, nro, nphi,
                                  device=self.device)
        self.alpha, self.beta, self.u0, self.sm = (cam.alpha, cam.beta,
                                                   cam.u0, cam.sm)
        self.npix = nro * nphi
        self._models = {}     # geometry-only fits: the model by load kwargs

    def _as_tensor(self, v):
        return torch.as_tensor(v, dtype=torch.float64, device=self.device)

    def model_for(self, kwargs):
        """The fluid model of these load kwargs, loaded once per key."""
        key = _cache_key(kwargs)
        model = self._models.get(key)
        if model is None:
            model = self._models[key] = load_fluid_model(
                self.fname, device=self.device, **kwargs)
        return model

    def render(self, params: Dict[str, Any], pix=None):
        """params -> (npix, nvals) image, differentiable in every tensor
        of params.  pix: an optional (lo, hi) pixel slice; rays are
        independent, so gradients of a sum over pixels add across slices
        (gradient accumulation over camera chunks).

        Each stage (trace, fluid sample, render_rays) runs under
        torch.utils.checkpoint, as grtrans_tpu wraps its stages in
        jax.checkpoint: the backward pass holds one stage's intermediates
        at a time and recomputes its forward, instead of every
        (npix, npts) intermediate of all stages at once."""
        p = dict(self.fixed)
        p.update(params)
        a = self._as_tensor(p.pop("spin")).clamp(-0.998, 0.998)
        mu0 = self._as_tensor(p.pop("mu0")).clamp(0.01, 0.99)
        if set(params) <= {"spin", "mu0"}:
            # geometry-only fit: the model depends on no fitted parameter
            model = self.model if self.model is not None \
                else self.model_for(p)
        else:
            model = load_fluid_model(self.fname, device=self.device, **p)
        alpha, beta, sm = self.alpha, self.beta, self.sm
        if pix is not None:
            lo, hi = pix
            alpha, beta, sm = alpha[lo:hi], beta[lo:hi], sm[lo:hi]
        l, q2 = cam_mod.constants_of_motion(a, mu0, alpha, beta)
        mixed = self.prec == "mixed"
        geo = _checkpoint(lambda aa, m0, ll, qq: geokerr.trace(
            aa, m0, alpha, beta, ll, qq, sm, self.u0, self.npts,
            uout=self.uout, prec=self.prec,
            coarse=4 if mixed and self.npts >= 256 else 1),
            a, mu0, l, q2)
        fv = _checkpoint(lambda x, k, aa: model.vals(x, k, aa), geo.x, geo.k,
                         a)
        sp = SourceParams(mbh=self.mbh, **self.source)
        ei = model.convert(fv, sp)
        iv = _checkpoint(lambda g, f, e, m0, aa: driver.render_rays(
            g, f, e, self.ename, [self.freq], m0, alpha, beta, aa, self.mbh,
            sp, iname=self.iname, nvals=self.nvals, prec=self.prec), geo, fv,
            ei, mu0, a)
        return iv[0]


# parameter transforms: the optimizer works unconstrained
_POS = ("n0", "t0", "nfac", "n0spot", "r0spot")  # positive scales -> log


def _to_opt(params, device):
    out = {}
    for k, v in params.items():
        v = torch.as_tensor(v, dtype=torch.float64, device=device)
        if k == "spin":
            out[k] = torch.arctanh(v / 0.999)
        elif k == "mu0":
            out[k] = torch.arctanh(2.0 * v - 1.0)
        elif k in _POS:
            out[k] = torch.log(v)
        else:
            out[k] = v.clone()
    return out


def _from_opt(z):
    out = {}
    for k, v in z.items():
        if k == "spin":
            out[k] = 0.999 * torch.tanh(v)
        elif k == "mu0":
            out[k] = 0.5 * (torch.tanh(v) + 1.0)
        elif k in _POS:
            out[k] = torch.exp(v)
        else:
            out[k] = v
    return out


def fit_image(problem: InverseProblem, target, init: Dict[str, float],
              steps: int = 100, lr: float = 0.1, lr_end: float = None,
              callback: Optional[Callable] = None, chunk: int = None):
    """Gradient-descent fit of `init`'s parameters to `target` (an
    (npix, nvals) IQUV image rendered by the same forward model).

    Returns (best_params, losses): best_params maps each fitted name to a
    float; losses is the loss of every step.  Loss: the mean square of
    (image - target) / max|I_target| over every channel, as grtrans_tpu's.
    Adam with optax's update and defaults; with lr_end, the rate decays
    from lr to lr_end over `steps` on a cosine (optax
    cosine_decay_schedule(lr, steps, alpha=lr_end / lr)).  Non-finite
    gradient entries are zeroed, as in grtrans_tpu; a step whose every
    gradient entry is non-finite raises FloatingPointError.  chunk: pixels
    a render (gradients accumulated over the camera's chunks), default
    the whole camera."""
    dev = problem.device
    target = torch.as_tensor(target, dtype=torch.float64, device=dev)
    iscale = target[..., 0].abs().max().clamp_min(1e-37)
    npix = problem.npix
    chunk = npix if chunk is None else int(chunk)
    z = {k: v.requires_grad_(True) for k, v in _to_opt(init, dev).items()}
    opt = torch.optim.Adam(list(z.values()), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    sched = None if lr_end is None else \
        torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps,
                                                   eta_min=lr_end)
    best = (np.inf, {k: v.detach().clone() for k, v in z.items()})
    losses = []
    for i in range(steps):
        opt.zero_grad()
        val = 0.0
        for lo in range(0, npix, chunk):
            hi = min(lo + chunk, npix)
            img = problem.render(_from_opt(z), pix=(lo, hi))
            r = (img - target[lo:hi]) / iscale
            part = (r * r).sum() / target.numel()
            part.backward()
            val += part.item()
        losses.append(val)
        if val < best[0]:
            best = (val, {k: v.detach().clone() for k, v in z.items()})
        if callback is not None:
            with torch.no_grad():
                callback(i, val, _from_opt(z))
        grads = [v.grad for v in z.values()]
        if not any(bool(torch.isfinite(g).any()) for g in grads):
            raise FloatingPointError(f"fit_image step {i}: every gradient "
                                     "entry is NaN or infinite")
        # a step that lands on a pathological render (spin at the arctanh
        # boundary) must not poison the whole fit
        for g in grads:
            g.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
        opt.step()
        if sched is not None:
            sched.step()
        # keep the atanh-transformed (bounded) parameters off the boundary
        with torch.no_grad():
            for k in ("spin", "mu0"):
                if k in z:
                    z[k].clamp_(-6.0, 6.0)
    return {k: float(v) for k, v in _from_opt(best[1]).items()}, losses
