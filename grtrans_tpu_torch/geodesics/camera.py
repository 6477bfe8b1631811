"""Camera pixel grids and photon constants of motion (reference
geokerr_wrapper.f INITIALIZE_CAMERA_GEOKERR, :138-354).  Built on the
host in float64 numpy and moved to the caller's device."""

from typing import NamedTuple

import numpy as np
import torch

from grtrans_tpu_torch import obs
from grtrans_tpu_torch.ops import scalar as sc

INPUT_LIMIT = 1e-10  # tiny-value clamp, geokerr_wrapper.f:204-211
FAC = 100.0


class Camera(NamedTuple):
    alpha: torch.Tensor   # (npix,) image-plane x
    beta: torch.Tensor    # (npix,) image-plane y
    l: torch.Tensor       # (npix,) angular momentum
    q2: torch.Tensor      # (npix,) Carter constant
    sm: torch.Tensor      # (npix,) initial polar direction sign
    su: torch.Tensor      # (npix,) initial radial direction sign (+1 = in)
    u0: float             # observer inverse radius
    mu0: float            # cos(inclination)
    a: float              # spin


def pixel_grid(a1, a2, b1, b2, nro, nphi, nrotype=2, rcut=1.0):
    """Pixel impact parameters (numpy float64) and the abmax scale.

    nrotype=2: rectangular, beta fastest (geokerr_wrapper.f:179-195);
    nrotype=1: log-spaced circular grid (geokerr_wrapper.f:138-149)."""
    if nrotype == 1:
        i = np.arange(1, nro + 1)
        ro = a1 * (rcut / a1) ** (i / nro)
        if nphi != 1:
            ph = 2.0 * np.pi * (np.arange(nphi) + 0.5) / nphi
        else:
            ph = np.array([0.0])
        alpha = (ro[:, None] * np.cos(ph)[None, :]).ravel()
        beta = (ro[:, None] * np.sin(ph)[None, :]).ravel()
        abmax = rcut ** 2
    else:
        i = np.arange(nro)
        j = np.arange(nphi)
        alpha = np.repeat(a1 + (a2 - a1) * (i + 0.5) / nro, nphi)
        beta = np.tile(b1 + (b2 - b1) * (j + 0.5) / nphi, nro)
        abmax = max(a1 * a1, a2 * a2) ** 2 + max(b1 * b1, b2 * b2) ** 2
    return alpha, beta, float(abmax)


def make_camera(a, mu0, a1, a2, b1, b2, nro, nphi, nrotype=2, rcut=1.0, *,
                device):
    """Pixels, constants of motion and initial signs on `device`
    (geokerr_wrapper.f:160-163, :198-201, :213-220, :275-285)."""
    alpha, beta, abmax = pixel_grid(a1, a2, b1, b2, nro, nphi, nrotype, rcut)
    u0 = min(1e-4, 1.0 / (FAC * abmax))
    l = -alpha * np.sqrt(max(1.0 - mu0 * mu0, 0.0))
    q2 = beta ** 2 - (a * a - alpha ** 2) * mu0 * mu0
    q2 = np.where(np.abs(q2) < INPUT_LIMIT ** 2, 0.0, q2)
    l = np.where(np.abs(l) < INPUT_LIMIT, 0.0, l)
    sm = np.where((beta >= 0.0) & (mu0 < 1.0), 1.0, -1.0)

    def dev(x):
        with obs.sync("camera.make_camera"):
            return torch.as_tensor(np.asarray(x, np.float64), device=device)

    return Camera(alpha=dev(alpha), beta=dev(beta), l=dev(l), q2=dev(q2),
                  sm=dev(sm), su=dev(np.ones_like(l)), u0=float(u0),
                  mu0=float(mu0), a=float(a))


def constants_of_motion(a, mu0, alpha, beta):
    """The photon constants (l, q2) of pixels (alpha, beta) for spin `a` and
    observer cos(inclination) `mu0`, in torch ops, so that a gradient
    flows to a tensor a or mu0 (grtrans_tpu/tools/invert.py:104-110; a
    camera made by make_camera holds them as numbers).  No tiny-value
    clamp: it would cut the gradient where it acts."""
    l = -alpha * sc.sqrt(1.0 - mu0 * mu0)
    q2 = beta ** 2 + (alpha ** 2 - a * a) * mu0 * mu0
    return l, q2
