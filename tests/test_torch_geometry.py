"""Parity of the port's Kerr geometry and comoving tetrad
(grtrans_tpu_torch.geometry) with grtrans_tpu on seeded random inputs.
Tolerance: max|d| <= 1e-12 * max|ref| per output component."""

import numpy as np
import pytest
import torch

from grtrans_tpu.geometry import kerr as jkerr
from grtrans_tpu.geometry import tetrad as jtetrad
from grtrans_tpu_torch.geometry import kerr as tkerr
from grtrans_tpu_torch.geometry import tetrad as ttetrad

torch.set_num_threads(1)   # the suite runs in parallel worker processes

A = 0.998
RTOL = 1e-12
N = 2000


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _close(a, b, rtol=RTOL):
    """max|a - b| <= rtol * max|b|, per component of a trailing axis."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if b.ndim == 1:
        a, b = a[:, None], b[:, None]
    err = np.abs(a - b).reshape(-1, b.shape[-1]).max(0)
    assert (err <= rtol * np.abs(b).reshape(-1, b.shape[-1]).max(0)).all()


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(0)
    r = 10.0 ** rng.uniform(np.log10(1.2), 2.0, N)
    th = rng.uniform(0.01, np.pi - 0.01, N)
    return r, th


@pytest.mark.parametrize("name", ["metric_cov", "metric_con"])
def test_metrics(pts, name):
    r, th = pts
    ours = getattr(tkerr, name)(_t(r), _t(th), A)
    _close(ours, getattr(jkerr, name)(r, th, A))


def test_lnrf_frame_inv(pts):
    r, th = pts
    rng = np.random.default_rng(1)
    v = rng.uniform(-0.3, 0.3, (3, N))
    ours = tkerr.lnrf_frame_inv(*(_t(x) for x in v), _t(r), A, _t(th))
    ref = jkerr.lnrf_frame_inv(*v, r, A, th)
    for o, j in zip(ours, ref):
        _close(o, j)


def _photons(rng, r, n):
    q2 = rng.uniform(0.0, 40.0, n)
    l = rng.uniform(-6.0, 6.0, n)
    mu = rng.uniform(-1.0, 1.0, n)
    mu[:4] = [1.0, -1.0, 1.0, -1.0]        # the pole-on floor on 1 - mu^2
    l[:4] = 0.0
    su = rng.choice([-1.0, 1.0], n)
    smu = rng.choice([-1.0, 1.0], n)
    return q2, l, r, mu, su, smu


def test_calc_nullp(pts):
    r, _ = pts
    rng = np.random.default_rng(2)
    q2, l, r, mu, su, smu = _photons(rng, r, N)
    ours = tkerr.calc_nullp(_t(q2), _t(l), A, _t(r), _t(mu), _t(su),
                            _t(smu))
    ref = np.asarray(jkerr.calc_nullp(q2, l, A, r, mu, su, smu))
    assert np.isfinite(ref[:4]).all()
    _close(ours, ref)


def test_comoving_ortho(pts):
    r, th = pts
    rng = np.random.default_rng(3)
    q2, l, _, mu, su, smu = _photons(rng, r, N)
    k = np.asarray(jkerr.calc_nullp(q2, l, A, r, np.cos(th), su, smu))
    v = rng.uniform(-0.3, 0.3, (3, N))
    vr, vt, om = (np.asarray(x) for x in jkerr.lnrf_frame_inv(*v, r, A, th))
    g = np.asarray(jkerr.metric_cov(r, th, A))
    u0 = np.asarray(jkerr.calc_u0(g, vr, vt, om))
    u = np.stack([u0, u0 * vr, u0 * vt, u0 * om], -1)
    b = rng.normal(size=(N, 4))
    alpha = rng.uniform(-20.0, 20.0, N)
    beta = rng.uniform(-20.0, 20.0, N)
    mus = 0.906
    ours = ttetrad.comoving_ortho(_t(r), _t(th), A, _t(alpha), _t(beta), mus,
                                  _t(u), _t(b), _t(k))
    ref = jtetrad.comoving_ortho(r, th, A, alpha, beta, mus, u, b, k)
    for o, j in zip(ours[:5], ref[:5]):      # s2xi, c2xi, ang, g, cosne
        _close(o, j)
    np.testing.assert_array_equal(ours[5].numpy(), np.asarray(ref[5]))
    assert np.asarray(ref[5]).mean() > 0.5


def test_krolikc(pts):
    """Outside the ISCO, where the thin disk uses it; a = 0 takes
    arccos(0) on the host."""
    r, _ = pts
    for a in (A, 0.9, 0.0, -0.5):
        rr = tkerr.calc_rms(a) + r
        _close(tkerr.krolikc(_t(rr), a), jkerr.krolikc(rr, a))


def _disk_photons(rng, r, th, n):
    """Wavevectors of photons at (r, th) outside the horizon."""
    q2, l, _, _, su, smu = _photons(rng, r, n)
    return np.asarray(jkerr.calc_nullp(q2, l, A, r, np.cos(th), su, smu))


@pytest.mark.parametrize("psi", [0.0, np.pi / 2.0, 0.7])
def test_calc_polvec(pts, psi):
    """Unit vectors, so every component is held to 1e-12 of the largest."""
    r, th = pts
    r = r + 1.0                            # outside the horizon: d > 0
    p = _disk_photons(np.random.default_rng(4), r, th, N)
    ours = tkerr.calc_polvec(_t(r), _t(np.cos(th)), _t(p), A, psi)
    ref = np.asarray(jkerr.calc_polvec(r, np.cos(th), p, A, psi))
    assert np.isfinite(ref).all()
    _close(ours, ref)


def test_calc_polvec_is_not_finite_where_the_frame_is_not(pts):
    """Inside the horizon sqrt(Delta) is NaN in both packages alike; the
    renderer masks those samples."""
    r = np.array([1.01, 1.03, 1.05, 1.02, 5.0])
    th = np.array([1.0, 2.0, 0.5, 1.2, 1.5])
    p = _disk_photons(np.random.default_rng(5), r, th, 5)
    ours = tkerr.calc_polvec(_t(r), _t(np.cos(th)), _t(p), A, 0.0).numpy()
    ref = np.asarray(jkerr.calc_polvec(r, np.cos(th), p, A, 0.0))
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(ref))
    assert not np.isfinite(ours[:4, 1:]).any() and np.isfinite(ours[4]).all()


def test_calc_kappapw_and_polar_psi(pts):
    r, th = pts
    r = r + 1.0
    rng = np.random.default_rng(6)
    p = _disk_photons(rng, r, th, N)
    f = rng.normal(size=(N, 4))
    mu = np.cos(th)
    ours = tkerr.calc_kappapw(A, _t(r), _t(mu), _t(p), _t(f))
    for o, j in zip(ours, jkerr.calc_kappapw(A, r, mu, p, f)):
        _close(o, j)
    alpha, beta = rng.uniform(-20.0, 20.0, (2, N))
    q2 = rng.uniform(-1.0, 40.0, N)        # safe_sqrt's zero branch too
    g = rng.uniform(0.2, 1.5, N)
    ours = tkerr.calc_polar_psi(_t(r), _t(mu), _t(q2), A, _t(alpha),
                                _t(beta), _t(g), 0.26, _t(p))
    ref = jkerr.calc_polar_psi(r, mu, q2, A, alpha, beta, g, 0.26, p)
    for o, j in zip(ours, ref):            # c2psi, s2psi, cosne
        _close(o, j)
    assert (np.asarray(ref[2]) == 0).any()


def test_calcg(pts):
    r, th = pts
    r = r + 1.0
    rng = np.random.default_rng(7)
    q2, l, _, _, su, sm = _photons(rng, r, N)
    tpm, tpr = rng.integers(0, 3, (2, N)).astype(np.int32)
    v = rng.uniform(-0.3, 0.3, (3, N))
    mu = np.cos(th)
    ours = tkerr.calcg(_t(1.0 / r), _t(mu), _t(q2), _t(l), A,
                       torch.from_numpy(tpm), torch.from_numpy(tpr), _t(su),
                       _t(sm), *(_t(x) for x in v))
    ref = jkerr.calcg(1.0 / r, mu, q2, l, A, tpm, tpr, su, sm, *v)
    _close(ours, ref)
