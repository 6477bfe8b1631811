"""Fit a scan parameter (mdot, or any scalar of fargs) to a target flux.

Port of grtrans_tpu/tools/pgriter.py (the reference's pgriter.py secant
iterator): a secant iteration on log(flux) against log(parameter), one
render a step.  Flux is near a power law in the density scale, so the
secant converges in a handful of steps.  A loaded model (a GRMHD
snapshot) is handed to every render, so a fit loads it once.
"""

import dataclasses

import numpy as np

from grtrans_tpu_torch.api import Grtrans


def flux_at(cfg, param_value, freq_index=0, param="mdot", model=None, *,
            device):
    """Render cfg on `device` with the scan parameter set (param="mdot":
    mdotmin = mdotmax; else fargs[param]), through `model` when given.
    Returns (|spec[0, freq_index]|, the Grtrans run)."""
    if model is not None and param != "mdot":
        raise ValueError(f"param={param!r}: a loaded model does not read "
                         "cfg.fargs; fit mdot, or pass no model")
    cfg2 = dataclasses.replace(cfg, fargs=dict(cfg.fargs))
    if param == "mdot":
        cfg2.mdotmin = cfg2.mdotmax = float(param_value)
        cfg2.nmdot = 1
    else:
        cfg2.fargs[param] = float(param_value)
    x = Grtrans()
    x.cfg = cfg2
    x.run(device=device, model=model)
    return float(np.abs(x.spec[0, freq_index])), x


def fit_flux(cfg, target, guess, param="mdot", freq_index=0, tol=1e-3,
             maxiter=12, factor=2.0, model=None, *, device):
    """Secant iteration in log-log space until |log(flux / target)| < tol.

    The first step moves the guess by `factor` toward the target.  Returns
    (fitted parameter, its flux, history of (parameter, flux))."""
    history = []
    p0 = float(guess)
    f0, _ = flux_at(cfg, p0, freq_index, param, model, device=device)
    history.append((p0, f0))
    if f0 <= 0:
        raise ValueError("zero flux at initial guess; cannot iterate")
    p1 = p0 * (factor if f0 < target else 1.0 / factor)
    for _ in range(maxiter):
        f1, _ = flux_at(cfg, p1, freq_index, param, model, device=device)
        history.append((p1, f1))
        if abs(np.log(f1 / target)) < tol:
            return p1, f1, history
        d = np.log(f1 / f0) / np.log(p1 / p0)
        if d == 0 or not np.isfinite(d):
            d = 1.0
        p0, f0 = p1, f1
        p1 = np.exp(np.log(p1) + (np.log(target) - np.log(f1)) / d)
    return p1, f1, history
