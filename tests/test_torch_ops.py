"""Parity of the port's numerics (grtrans_tpu_torch.ops) with grtrans_tpu
on the cases of tests/test_ops.py.  Tolerance: relative 1e-12 (max|d| <=
1e-12 * max|ref| per output), unless stated."""

import numpy as np
import pytest
import scipy.special as sp
import torch
import jax.numpy as jnp

from grtrans_tpu.ops import interp as jinterp
from grtrans_tpu.ops import polyroots as jroots
from grtrans_tpu.ops import quadrature as jquad
from grtrans_tpu.ops import weierstrass as jw
from grtrans_tpu_torch.ops import interp as tinterp
from grtrans_tpu_torch.ops import polyroots as troots
from grtrans_tpu_torch.ops import quadrature as tquad
from grtrans_tpu_torch.ops import weierstrass as tw

torch.set_num_threads(1)   # the suite runs in parallel worker processes

RTOL = 1e-12


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * np.abs(b).max()


def _roots(mod, cs, conv):
    zr, zi = mod.quartic_roots(*[conv(cs[..., i]) for i in range(5)])
    return np.asarray(zr) + 1j * np.asarray(zi)


def _same_roots(ours, ref):
    # nearest-match: conjugate pairs with equal real parts may sort either
    # way round
    d = np.abs(ours[..., :, None] - ref[..., None, :])
    assert (d.min(axis=-1) <= RTOL * np.maximum(np.abs(ours), 1.0)).all()
    assert (d.min(axis=-2) <= RTOL * np.maximum(np.abs(ref), 1.0)).all()


@pytest.mark.parametrize("case", ["random", "cubic", "batched"])
def test_quartic_roots(case):
    if case == "random":
        cs = np.random.default_rng(0).normal(size=(50, 5))
        cs[:, 4] = np.where(np.abs(cs[:, 4]) > 0.1, cs[:, 4], 1.0)
    elif case == "cubic":
        cs = np.array([[-6.0, 11.0, -6.0, 1.0, 0.0]])
    else:
        cs = np.array([[1.0, 0.0, -5.0, 0.0, 1.0], [2.0, 0.0, -5.0, 0.0, 1.0]])
    ours = _roots(troots, cs, _t)
    ref = _roots(jroots, cs, jnp.asarray)
    assert ours.shape == ref.shape == (cs.shape[0], 4)
    _same_roots(ours, ref)
    # the real-part order is what the turning-point landmarks rely on
    np.testing.assert_allclose(ours.real, ref.real, rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("g2,g3,zmax,n", [(4.0, 0.5, 1.8, 30),
                                           (-3.0, 11.0, 1.0, 20)])
def test_wp(g2, g3, zmax, n):
    z = np.linspace(0.05, zmax, n)
    p, dp = tw.wp(_t(z), _t(g2), _t(g3))
    pj, dpj = jw.wp(z, g2, g3)
    _close(p, pj)
    _close(dp, dpj)


def test_invert_quartic():
    A, B, C, D, E = (_t(v) for v in (-1.0, 0.1, 5.0, -0.2, 3.0))
    lam = np.linspace(0.0, 0.6, 25)
    x = tw.invert_quartic(A, B, C, D, E, _t(0.3), 1.0, _t(lam))
    _close(x, jw.invert_quartic(-1.0, 0.1, 5.0, -0.2, 3.0, 0.3, 1.0, lam))


def test_invert_through_turning_point():
    A, B, C, D, E = (_t(v) for v in (-1.0, 0.0, 0.0, 0.0, 1.0))
    lam_turn = float(sp.ellipkinc(np.pi / 2, 0.5) / np.sqrt(2.0))
    lam = lam_turn + np.linspace(-0.3, 0.3, 21)
    x = tw.invert_quartic(A, B, C, D, E, _t(0.0), 1.0, _t(lam))
    # the wp doublings amplify last-bit differences ~4x per step: jitted
    # grtrans_tpu differs from itself run eagerly by 1.14e-11 here
    _close(x, jw.invert_quartic(-1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 1.0, lam),
           rtol=3e-11)


def test_invert_quartic_with_deriv():
    A, B, C, D, E = (_t(v) for v in (-0.5, 0.0, 2.0, 0.3, 1.0))
    lam = np.linspace(0.0, 0.5, 11)
    x, dx = tw.invert_quartic_with_deriv(A, B, C, D, E, _t(0.1), 1.0,
                                         _t(lam))
    xj, dxj = jw.invert_quartic_with_deriv(-0.5, 0.0, 2.0, 0.3, 1.0, 0.1,
                                           1.0, lam)
    _close(x, xj)
    _close(dx, dxj)


@pytest.mark.parametrize("n", [8, 48])
def test_gl_nodes(n):
    for ours, ref in zip(tquad.gl_nodes(n), jquad.gl_nodes(n)):
        np.testing.assert_array_equal(ours, ref)


def test_get_weight():
    xarr = np.array([0.0, 1.0, 2.0, 4.0])
    x = np.concatenate([[0.5, 3.0, -1.0, 5.0],
                        np.random.default_rng(1).uniform(-1, 5, 40)])
    ix, w = tinterp.get_weight(_t(xarr), _t(x))
    ixj, wj = jinterp.get_weight(jnp.asarray(xarr), jnp.asarray(x))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(ixj))
    np.testing.assert_array_equal(ix.numpy()[:4], [0, 2, 0, 2])
    _close(w, wj)


def test_tsum():
    rng = np.random.default_rng(2)
    x = np.cumsum(rng.uniform(0.01, 0.1, (5, 101)), axis=-1)
    y = rng.normal(size=(5, 101))
    _close(tinterp.tsum(_t(x), _t(y)), jinterp.tsum(x, y))
