"""Parity of the port's integrators with grtrans_tpu/integrate/solvers.py
on seeded coefficients (256 pixels x 80 points, 5% of samples masked),
with a tau > 10 cutoff case, plus the 32-cell varying-Faraday problem that
exposed the substep composition order.

Tolerance: max|d| <= 1e-12 * max|ref| per Stokes component over the whole
profile.  grtrans_tpu composes cells with an associative scan, the port
with a far-to-near loop that records the profile, so the two agree to
roundoff only; measured 1.3e-15 (formal), 1.9e-15 / 2.8e-15 (2 / 4
substeps), 2.4e-14 (delo), 6.1e-16 (quadrature), 7.6e-15 (lsodasph)."""

import numpy as np
import pytest
import torch

from grtrans_tpu.integrate import solvers as jsol
from grtrans_tpu_torch.integrate import solvers as tsol
from test_torch_solvers import _coefficients

torch.set_num_threads(1)   # the suite runs in parallel worker processes

RTOL = 1e-12
METHODS = ("formal", "lsoda", "delo", "quadrature", "lsodasph")


def _t(*arrays):
    return [torch.tensor(np.asarray(x)) for x in arrays]


def _close(ours, ref, rtol=RTOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all()
    o, r = ours.reshape(-1, ours.shape[-1]), ref.reshape(-1, ref.shape[-1])
    scale = np.maximum(np.abs(r).max(0), 1e-300)
    assert (np.abs(o - r).max(0) <= rtol * scale).all(), \
        np.abs(o - r).max(0) / scale


@pytest.mark.parametrize("case", ["generic", "tau_over_10"])
@pytest.mark.parametrize("method", METHODS)
def test_profile_matches_jax(method, case):
    lam, j, K, mask = _coefficients(case)
    ours = tsol.integrate(*_t(lam, j, K), method, mask=_t(mask)[0])
    ref = jsol.integrate(lam, j, K, method, mask=mask)
    assert ours.shape == lam.shape + (4,)
    _close(ours, ref)
    if method == "quadrature":
        assert (ours[..., 1:] == 0).all()


@pytest.mark.parametrize("substeps", [1, 4])
def test_formal_substeps_and_incident_stokes_match_jax(substeps):
    """With a Stokes vector entering at the far end; two substeps run
    without one as 'lsoda' in test_profile_matches_jax."""
    lam, j, K, mask = _coefficients("generic", seed=5)
    I0 = np.array([2e-2, 3e-3, -1e-3, 5e-4])
    ours = tsol.formal_solve(*_t(lam, j, K, mask), I0=I0, substeps=substeps)
    ref = jsol.formal_solve(lam, j, K, mask, I0=I0, substeps=substeps,
                            seq=False)
    _close(ours, ref)
    np.testing.assert_array_equal(ours[:, -1].numpy(),
                                  np.broadcast_to(I0, (lam.shape[0], 4)))


@pytest.mark.parametrize("method", METHODS)
def test_observed_stokes_is_profile_row_zero(method):
    lam, j, K, mask = _t(*_coefficients("generic", seed=6))
    prof = tsol.integrate(lam, j, K, method, mask=mask)
    obs = tsol.observed_stokes(lam, j, K, method, mask=mask)
    assert obs.shape == (lam.shape[0], 4)
    # the formal solvers compose blocks of cells before applying them
    _close(obs, prof[:, 0], 1e-13)


def test_delo_with_incident_stokes_matches_jax():
    lam, j, K, mask = _coefficients("generic", seed=7)
    I0 = np.array([1e-2, 0.0, 2e-3, 0.0])
    _close(tsol.delo_solve(*_t(lam, j, K, mask), I0=I0),
           jsol.delo_solve(lam, j, K, mask, I0=I0))


def test_lsoda_solve_matches_jax():
    lam, j, K, mask = _coefficients("generic", seed=8)
    kw = dict(atol=1e-5, rtol=1e-3, max_substeps=4)     # converges at 4
    ours, info = tsol.lsoda_solve(*_t(lam, j, K, mask), **kw)
    ref, rinfo = jsol.lsoda_solve(lam, j, K, mask, **kw)
    _close(ours, ref)
    assert info["substeps"] == rinfo["substeps"] == 4
    assert info["converged"] and rinfo["converged"]
    np.testing.assert_allclose(info["err_scaled"], rinfo["err_scaled"],
                               rtol=1e-6)
    np.testing.assert_allclose(info["err_est"], rinfo["err_est"], rtol=1e-6)


class TestVaryingFaraday:
    """Pure Faraday rotation varying along 32 cells with varying Q
    emission (tests/test_integrate.py TestLsodaAdaptive).  In-cell
    substeps composed in the wrong order converge to the within-cell
    mirrored profile, 2.2e-3 off the truth."""

    NPTS = 33

    def _problem(self):
        s = np.linspace(0.0, 1.0, self.NPTS)
        rv = 7.0 + 5.0 * np.sin(2 * np.pi * s)
        jq = 1.0 + 0.5 * np.cos(2 * np.pi * s)
        j = np.zeros((1, self.NPTS, 4))
        j[..., 1] = jq
        K = np.zeros((1, self.NPTS, 7))
        K[..., 6] = rv
        return s, rv, jq, s[None], j, K

    @staticmethod
    def _truth(s, rv, jq):
        # (Q + iU)_obs = int jq(s) exp(i Phi(s)) ds, Phi = int_0^s rho_V,
        # on the piecewise-linear interpolants the solvers see
        sf = np.linspace(0.0, 1.0, 400001)
        rvf = np.interp(sf, s, rv)
        jqf = np.interp(sf, s, jq)
        dphi = np.concatenate(
            [[0.0], np.cumsum(0.5 * (rvf[1:] + rvf[:-1]) * np.diff(sf))])
        QU = np.trapezoid(jqf * np.exp(1j * dphi), sf)
        return QU.real, QU.imag

    LSODA = dict(atol=2e-5, rtol=3e-5, max_substeps=8)

    @pytest.fixture(scope="class")
    def jax_lsoda(self):
        """grtrans_tpu's lsoda run on the problem, shared by both tests: it
        stops at 8 substeps, so its profile is also grtrans_tpu's
        formal_solve(substeps=8), bit for bit."""
        _, _, _, lam, j, K = self._problem()
        ref, rinfo = jsol.lsoda_solve(lam, j, K, **self.LSODA)
        assert rinfo["substeps"] == 8
        return ref, rinfo

    def test_composition_order(self, jax_lsoda):
        s, rv, jq, lam, j, K = self._problem()
        Qx, Ux = self._truth(s, rv, jq)
        ours = tsol.formal_solve(*_t(lam, j, K), substeps=8)
        _close(ours, jax_lsoda[0])
        I = ours[0, 0].numpy()
        assert max(abs(I[1] - Qx), abs(I[2] - Ux)) < 1e-4

    def test_lsoda_solve_error_control(self, jax_lsoda):
        s, rv, jq, lam, j, K = self._problem()
        Qx, Ux = self._truth(s, rv, jq)
        prof, info = tsol.lsoda_solve(*_t(lam, j, K), **self.LSODA)
        ref, rinfo = jax_lsoda
        _close(prof, ref)
        assert info["converged"] and info["substeps"] == rinfo["substeps"] > 1
        I = prof[0, 0].numpy()
        true_err = max(abs(I[1] - Qx), abs(I[2] - Ux))
        assert true_err <= 5.0 * float(info["err_est"].max()) + 2e-5
        assert true_err < 1e-4
        _, capped = tsol.lsoda_solve(*_t(lam, j, K), atol=1e-16, rtol=1e-15,
                                     max_substeps=4)
        assert capped["substeps"] == 4 and not capped["converged"]


def test_inv4_closed_form_matches_linalg():
    rng = np.random.default_rng(9)
    m = rng.normal(size=(500, 4, 4)) + 3.0 * np.eye(4)
    m[:3] = 0.0                                     # singular: not `good`
    inv, good = tsol.inv4(torch.tensor(m))
    rinv, rgood = jsol.inv4(m)
    np.testing.assert_array_equal(good.numpy(), np.asarray(rgood))
    assert not good[:3].any() and good[3:].all()
    _close(inv[3:], np.asarray(rinv)[3:])
    torch.testing.assert_close(inv[3:], torch.linalg.inv(torch.tensor(m[3:])),
                               rtol=1e-9, atol=1e-11)
    im = tsol._imatrix4(torch.tensor(m).movedim((-2, -1), (0, 1)))
    np.testing.assert_array_equal(im[..., 0].numpy(), np.eye(4))


def test_unknown_method_is_an_error():
    lam, j, K, _ = _t(*_coefficients("generic"))
    with pytest.raises(ValueError, match="rk4"):
        tsol.integrate(lam, j, K, "rk4")
