"""Parity of the port's observer-only formal solver with grtrans_tpu's
formal_solve, both its sequential march (seq=True, profile=False) and its
associative scan (seq=False), on random passive coefficients at 256
pixels x 80 points.  Tolerance: max|d| <= 1e-12 * max|ref| per Stokes
component, except the Faraday-thick case at 1e-4: there the matricant's
lam1 = sqrt(rt - (p2 - a2)/2) cancels catastrophically (rt ~ 4e3 against
lam1^2 ~ 1e-11 in the worst cell), so both implementations carry errors
of ~1e-8 in O (1-3% of its small I<->QUV entries against scipy's expm)
that differ in their last bits; measured port vs grtrans_tpu 1.9e-5 on
V, while grtrans_tpu's own march and scan agree to 1.5e-13 because they
evaluate identical XLA arithmetic per cell."""

import numpy as np
import pytest
import torch

from grtrans_tpu.integrate import solvers as jsol
from grtrans_tpu_torch.integrate import solvers as tsol

torch.set_num_threads(1)   # the suite runs in parallel worker processes

NPIX, NPTS = 256, 80


def _coefficients(case, seed=0):
    rng = np.random.default_rng(seed)
    lam = np.cumsum(rng.uniform(0.5, 1.5, (NPIX, NPTS)), axis=-1)
    lam -= lam[:, :1]
    aI = 10.0 ** rng.uniform(-4.0, -2.0, (NPIX, NPTS))
    apol = rng.normal(size=(NPIX, NPTS, 3))
    apol *= (0.8 * aI * rng.uniform(0, 1, (NPIX, NPTS))
             / np.linalg.norm(apol, axis=-1))[..., None]
    rho = rng.normal(size=(NPIX, NPTS, 3)) * aI[..., None]
    if case == "faraday_thick":
        rho *= 1e4                       # |rho| dlam ~ 1e2 per cell
    if case == "tau_over_10":
        aI = aI * 300.0                  # total tau ~ 100: truncation
        apol *= 300.0
    jI = 10.0 ** rng.uniform(-3.0, -1.0, (NPIX, NPTS))
    jpol = rng.normal(size=(NPIX, NPTS, 3))
    jpol *= (0.7 * jI / np.linalg.norm(jpol, axis=-1))[..., None]
    j = np.concatenate([jI[..., None], jpol], -1)
    K = np.concatenate([aI[..., None], apol, rho], -1)
    mask = rng.uniform(size=(NPIX, NPTS)) > 0.05
    return lam, j, K, mask


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert (np.abs(a - b).max(0) <= rtol * np.abs(b).max(0)).all()


@pytest.mark.parametrize("case,rtol", [("generic", 1e-12),
                                       ("faraday_thick", 1e-4),
                                       ("tau_over_10", 1e-12)])
def test_observed_stokes(case, rtol):
    lam, j, K, mask = _coefficients(case)
    lam_t, j_t, K_t, mask_t = (torch.tensor(x) for x in (lam, j, K, mask))
    ours = tsol.observed_stokes(lam_t, j_t, K_t, mask=mask_t)
    seq = jsol.formal_solve(lam, j, K, mask, seq=True, profile=False)
    scan = jsol.formal_solve(lam, j, K, mask, seq=False)[:, 0, :]
    assert ours.shape == (NPIX, 4)
    assert np.isfinite(np.asarray(seq)).all()
    _close(ours, seq, rtol)
    _close(ours, scan, rtol)
    if case == "tau_over_10":
        tau, _ = jsol._cell_tau_mask(lam, K, None, jsol.MAX_TAU)
        assert (np.asarray(tau)[:, -1] > 10.0).mean() > 0.9


def test_passivity_clamp():
    _, j, K, _ = _coefficients("generic", seed=1)
    K[..., 1:4] *= 3.0                  # |a_pol| > aI on many samples
    jt, Kt = tsol.passivity_clamp(torch.tensor(j), torch.tensor(K))
    jr, Kr = jsol.passivity_clamp(j, K)
    np.testing.assert_array_equal(jt.numpy(), np.asarray(jr))
    _close(Kt.numpy().reshape(-1, 7), np.asarray(Kr).reshape(-1, 7))


def test_rejects_other_integrators():
    lam, j, K, mask = (torch.tensor(x) for x in _coefficients("generic"))
    with pytest.raises(ValueError):
        tsol.observed_stokes(lam, j, K, method="rk4")
