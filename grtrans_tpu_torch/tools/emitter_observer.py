"""Emitter -> observer solver: the camera impact parameters (alpha, beta)
whose geodesic passes through a given emission point.

Port of grtrans_tpu/tools/emitter_observer.py (reference
emitter_observer.py): scipy.optimize.minimize over (alpha, beta) of the
Cartesian separation between the geodesic's point at radius 1/ustar and
the target point, used for the timing and astrometry of hotspots.  The
objective is a trace through geodesics/geokerr.py, differentiated by
autograd, so BFGS gets exact gradients (the reference is
derivative-free).
"""

import math

import numpy as np
import torch

from grtrans_tpu_torch.geodesics import geokerr


def cartesian(u, mu, phi):
    s = (1.0 - mu ** 2).clamp_min(0.0).sqrt()
    return (1.0 / u * s * torch.cos(phi), 1.0 / u * s * torch.sin(phi),
            1.0 / u * mu)


def _point_at_u(a, mu0, alpha, beta, ustar, npts=128, u0=1e-6):
    """Trace one ray and interpolate (mu, phi) at u = ustar.  alpha, beta:
    0-d float64 tensors (the ray's device); a, mu0, ustar floats.  Returns
    (mu, phi, whether the ray crosses ustar)."""
    ab = alpha.reshape(1)
    bb = beta.reshape(1)
    # constants of motion (geokerr_wrapper.f:198-201, :279-285), kept
    # differentiable in (alpha, beta)
    l = -ab * math.sqrt(max(1.0 - mu0 * mu0, 0.0))
    q2 = bb ** 2 - (a * a - ab ** 2) * mu0 * mu0
    sm = torch.where((bb >= 0.0) & bool(mu0 < 1.0), 1.0, -1.0).to(ab.dtype)
    geo = geokerr.trace(a, mu0, ab, bb, l, q2, sm, u0, npts,
                        uout=ustar * 0.5)
    r = geo.x[0, :, 1]
    u = 1.0 / r.clamp_min(1e-12)
    mu = torch.cos(geo.x[0, :, 2])
    phi = geo.x[0, :, 3]
    # first crossing of u = ustar along the trace (u grows inward)
    w = ((ustar - u[:-1]) / (u[1:] - u[:-1] + 1e-37)).clamp(0.0, 1.0)
    cross = (u[:-1] <= ustar) & (u[1:] >= ustar)
    idx = torch.argmax(cross.to(torch.int32))
    wi = w[idx]
    mu_c = mu[idx] * (1 - wi) + mu[idx + 1] * wi
    ph_c = phi[idx] * (1 - wi) + phi[idx + 1] * wi
    return mu_c, ph_c, cross.any()


def run(ustar, mustar, phistar, abguess, a=0.99,
        mu0=float(np.cos(45.0 / 180.0 * np.pi)), npts=128, *,
        device="cuda"):
    """Find (alpha, beta) hitting (1/ustar, mustar, phistar), tracing on
    `device`.  Mirrors reference emitter_observer.run (:29-37); returns a
    scipy OptimizeResult whose .x is (alpha, beta)."""
    from scipy.optimize import minimize

    def f64(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device)

    target = cartesian(f64(ustar), f64(mustar), f64(phistar))

    def sep(ab):
        mu_c, ph_c, ok = _point_at_u(a, mu0, ab[0], ab[1], ustar, npts)
        # the reference flips phi's sign (calc_orbit: -phi[0, -1])
        x, y, z = cartesian(f64(ustar), mu_c, -ph_c)
        d = ((x - target[0]) ** 2 + (y - target[1]) ** 2
             + (z - target[2]) ** 2)
        return torch.where(ok, d, 1e6 + ab[0] ** 2 + ab[1] ** 2)

    def value(ab):
        with torch.no_grad():
            return float(sep(f64(ab)))

    def grad(ab):
        ab = f64(ab).requires_grad_(True)
        (g,) = torch.autograd.grad(sep(ab), ab)
        return g.cpu().numpy()

    return minimize(value, np.asarray(abguess, float), jac=grad,
                    method="BFGS", options=dict(gtol=1e-12))
