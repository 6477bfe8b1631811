"""Parity of the port's POLSYNCHPL coefficients and emissivity framework
with grtrans_tpu on seeded random inputs.  The scipy tables must be
identical; values max|d| <= 1e-12 * max|ref| per column, except the
POLSYNCHPL block at 2e-9: its cutoff factors G(xmax) - G(xmin) cancel
where both arguments are small, and on these inputs jitted grtrans_tpu
differs from itself run eagerly by up to 4.4e-10 (per-sample gmin,
column aI; the port differs from eager grtrans_tpu by up to 5.9e-10)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from grtrans_tpu.emis import framework as jfw
from grtrans_tpu.emis import polsynchpl as jpl
from grtrans_tpu_torch.emis import framework as tfw
from grtrans_tpu_torch.emis import polsynchpl as tpl

torch.set_num_threads(1)   # the suite runs in parallel worker processes

SHAPE = (40, 30)


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _close(a, b, rtol=1e-12):
    """max|a - b| <= rtol * max|b| per trailing column."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).reshape(-1, b.shape[-1]).max(0)
    assert (err <= rtol * np.abs(b).reshape(-1, b.shape[-1]).max(0)).all()


def test_tables_identical():
    ours, ref = tpl._build_tables(), jpl._build_tables()
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[2].keys() == ref[2].keys()
    for k in ref[2]:
        np.testing.assert_array_equal(ours[2][k], ref[2][k])
    for p in (2.2, 3.5, 7.9):
        np.testing.assert_array_equal(tpl._g_rows(p), jpl._g_rows(p))


@pytest.mark.parametrize("gmin", [100.0, "per-sample"])
def test_polsynchpl(gmin):
    rng = np.random.default_rng(0)
    nu = 10.0 ** rng.uniform(10.0, 12.5, SHAPE)
    n = 10.0 ** rng.uniform(0.0, 5.0, SHAPE)
    b = 10.0 ** rng.uniform(-1.0, 2.5, SHAPE)
    theta = rng.uniform(0.05, np.pi - 0.05, SHAPE)
    if gmin == "per-sample":
        gmin = rng.uniform(20.0, 400.0, SHAPE)
        gmin_t = _t(gmin)
    else:
        gmin_t = gmin
    ours = tpl.polsynchpl(_t(nu), _t(n), _t(b), _t(theta), 3.5, gmin_t, 1e5)
    ref = jpl.polsynchpl(nu, n, b, theta, 3.5, gmin, 1e5)
    assert np.isfinite(np.asarray(ref)).all()
    _close(ours, ref, rtol=2e-9)


def test_rotate_and_invariant():
    rng = np.random.default_rng(1)
    j = rng.normal(size=SHAPE + (4,))
    K = rng.normal(size=SHAPE + (7,))
    xi = rng.uniform(0.0, 2 * np.pi, SHAPE)
    g = rng.uniform(0.1, 3.0, SHAPE)
    jt, Kt = tfw.split_e(_t(np.concatenate([j, K], -1)))
    jt, Kt = tfw.rotate_emis(jt, Kt, _t(np.sin(2 * xi)), _t(np.cos(2 * xi)))
    jr, Kr = jfw.rotate_emis(jnp.asarray(j), jnp.asarray(K), np.sin(2 * xi),
                             np.cos(2 * xi))
    _close(jt, jr)
    _close(Kt, Kr)
    jt, Kt = tfw.invariant_emis(jt, Kt, _t(g))
    jr, Kr = jfw.invariant_emis(jr, Kr, g)
    _close(jt, jr)
    _close(Kt, Kr)
