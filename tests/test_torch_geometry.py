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
