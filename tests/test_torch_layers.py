"""The port's layer library, the functions no render path calls
(ops/elliptic, ops/interp, ops/quadrature, geometry/fourvector and kerr,
integrate/solvers calc_O and opacity_matrix, fluid/grmhd3d
to_lnrf_storage), against grtrans_tpu on the same seeded inputs on the
CPU.  Tolerance: 1e-12 relative (assert_allclose rtol, with an atol of
1e-12 of the array's largest value where entries cross zero), the
elliptic integrals also against scipy.special at grtrans_tpu's own bars
(tests/test_ops.py: 1e-12, Carlson R 1e-11, R_J 1e-10)."""

import math

import numpy as np
import pytest
import scipy.special as sp
import torch

import jax.numpy as jnp

from grtrans_tpu.fluid import grmhd3d as jgrmhd3d
from grtrans_tpu.geometry import fourvector as jfv
from grtrans_tpu.geometry import kerr as jkerr
from grtrans_tpu.integrate import solvers as jsol
from grtrans_tpu.ops import elliptic as jell
from grtrans_tpu.ops import interp as jint
from grtrans_tpu.ops import quadrature as jquad
from grtrans_tpu_torch.fluid import grmhd3d as tgrmhd3d
from grtrans_tpu_torch.geometry import fourvector as tfv
from grtrans_tpu_torch.geometry import kerr as tkerr
from grtrans_tpu_torch.integrate import solvers as tsol
from grtrans_tpu_torch.ops import elliptic as tell
from grtrans_tpu_torch.ops import interp as tint
from grtrans_tpu_torch.ops import quadrature as tquad

torch.set_num_threads(1)   # the suite runs in parallel worker processes

T = torch.as_tensor


def close(ours, ref, rtol=1e-12):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _positive(n, seed):
    return np.abs(np.random.default_rng(seed).normal(size=n)) + 1e-3


@pytest.mark.parametrize("name", ["rf", "rd"])
def test_carlson_three_argument(name):
    x, y, z = (_positive(64, s) for s in (0, 1, 2))
    ours = getattr(tell, name)(T(x), T(y), T(z))
    close(ours, getattr(jell, name)(x, y, z))
    close(ours, getattr(sp, "ellip" + name)(x, y, z), rtol=1e-11)


def test_carlson_rj_and_rc():
    x, y, z, p = (_positive(64, s) for s in (0, 1, 2, 3))
    ours = tell.rj(T(x), T(y), T(z), T(p))
    close(ours, jell.rj(x, y, z, p))
    close(ours, sp.elliprj(x, y, z, p), rtol=1e-10)
    for yy in (y, -y):                  # -y: the Cauchy principal value
        ours = tell.rc(T(x), T(yy))
        close(ours, jell.rc(x, yy))
        close(ours, sp.elliprc(x, yy), rtol=1e-11)


def test_legendre_forms():
    m = np.linspace(-5.0, 0.95, 40)
    close(tell.ellk(T(m)), jell.ellk(m))
    close(tell.ellk(T(m)), sp.ellipkm1(1.0 - m))
    phi = np.linspace(-1.5, 1.5, 21)
    for mm in (-2.0, 0.0, 0.3, 0.9):
        close(tell.ellf(T(phi), mm), jell.ellf(phi, mm))
        close(tell.ellf(T(phi), mm), sp.ellipkinc(phi, mm))
    phi = np.linspace(0.0, 1.5, 11)
    for mm in (0.0, 0.5, 0.99):
        close(tell.elle(T(phi), mm), jell.elle(phi, mm))
        close(tell.elle(T(phi), mm), sp.ellipeinc(phi, mm))
    with pytest.raises(TypeError, match="tensor"):
        tell.rf(1.0, 2.0, 3.0)


def _cells(rng, shape, n):
    """Cells in [0, n - 2] and fractional weights."""
    pos = rng.uniform(0.0, n - 1.0, shape)
    i = np.clip(pos.astype(np.int64), 0, n - 2)
    return i, pos - i


def test_interp_1d_and_get_weight():
    rng = np.random.default_rng(4)
    xarr = np.sort(rng.uniform(0.0, 10.0, 40))
    yarr = rng.normal(size=40)
    x = rng.uniform(-1.0, 11.0, 200)            # both ends extrapolate
    close(tint.interp_1d(T(yarr), T(xarr), T(x)),
          jint.interp_1d(jnp.asarray(yarr), jnp.asarray(xarr),
                         jnp.asarray(x)))


def test_bilinear_trilinear_quadlinear():
    rng = np.random.default_rng(5)
    f2 = rng.normal(size=(3, 7, 9))
    (ix, wx), (iy, wy) = _cells(rng, 50, 7), _cells(rng, 50, 9)
    close(tint.bilinear(T(f2), T(ix), T(iy), T(wx), T(wy)),
          jint.bilinear(jnp.asarray(f2), ix, iy, wx, wy))
    f3 = rng.normal(size=(6, 5, 8))
    cells = [_cells(rng, 50, n) for n in f3.shape]
    close(tint.trilinear(T(f3), *(T(c[0]) for c in cells),
                         *(T(c[1]) for c in cells)),
          jint.trilinear(jnp.asarray(f3), *(c[0] for c in cells),
                         *(c[1] for c in cells)))
    f4 = rng.normal(size=(2, 4, 5, 6, 3))
    cells = [_cells(rng, 50, n) for n in f4.shape[1:]]
    close(tint.quadlinear(T(f4), [T(c[0]) for c in cells],
                          [T(c[1]) for c in cells]),
          jint.quadlinear(jnp.asarray(f4), [c[0] for c in cells],
                          [c[1] for c in cells]))


def test_stacked_and_corner_packed_tables():
    rng = np.random.default_rng(6)
    fields = {k: rng.normal(size=(11, 13)) for k in ("a", "b", "c")}
    order = ("c", "a", "b")
    (i1, w1), (i2, w2) = _cells(rng, (4, 25), 11), _cells(rng, (4, 25), 13)
    G = tint.stack_grid_fields(fields, order, device="cpu")
    Gj = jint.stack_grid_fields(fields, order)
    close(G, Gj)
    close(tint.bilinear_stacked(G, 13, T(i1), T(i2), T(w1), T(w2)),
          jint.bilinear_stacked(Gj, 13, i1, i2, w1, w2))
    Q = tint.pack_corners_2d(fields, order, device="cpu")
    Qj = jint.pack_corners_2d(fields, order)
    close(Q, Qj)
    i32 = (T(i1, dtype=torch.int32), T(i2, dtype=torch.int32))
    close(tint.bilinear_packed(Q, 13, 3, *i32, T(w1), T(w2)),
          jint.bilinear_packed(Qj, 13, 3, i1, i2, w1, w2))


@pytest.mark.parametrize("nder", [0, 1, 2])
def test_polint_polyvl(nder):
    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(-2.0, 2.0, (5, 6)), axis=-1)
    y = rng.uniform(-1.0, 1.0, (5, 6))
    c = tint.polint(T(x), T(y))
    cj = jint.polint(jnp.asarray(x), jnp.asarray(y))
    close(c, cj)
    xx = rng.uniform(-2.0, 2.0, 5)
    ours = tint.polyvl(T(xx), T(x), c, nder=nder)
    ref = jint.polyvl(jnp.asarray(xx), jnp.asarray(x), cj, nder=nder)
    if nder == 0:
        close(ours, ref)
        return
    close(ours[0], ref[0])
    assert len(ours[1]) == len(ref[1]) == nder
    for d, dj in zip(ours[1], ref[1]):
        close(d, dj)


def test_quadrature():
    close(tquad.integrate(torch.sin, T(0.0), math.pi, n=32),
          jquad.integrate(jnp.sin, 0.0, np.pi, n=32))
    a = np.random.default_rng(8).uniform(0.0, 1.0, 7)
    close(tquad.integrate(torch.exp, T(a), T(2 * a + 1.0), n=12),
          jquad.integrate(jnp.exp, a, 2 * a + 1.0, n=12))
    pts = np.sort(np.random.default_rng(9).uniform(0.0, 2.0, (3, 17)), -1)
    close(tquad.cumulative_segments(torch.exp, T(pts)),
          jquad.cumulative_segments(jnp.exp, jnp.asarray(pts)))


def _metric_points(n=60, seed=10):
    rng = np.random.default_rng(seed)
    return rng.uniform(1.9, 30.0, n), rng.uniform(0.05, 3.09, n)


def test_fourvector_unpack_and_lower():
    r, th = _metric_points()
    g = np.array(jkerr.metric_cov(r, th, 0.9))
    u = np.random.default_rng(11).normal(size=(60, 4))
    close(tfv.unpack(T(g)), jfv.unpack(jnp.asarray(g)))
    close(tfv.lower(T(g), T(u)), jfv.lower(jnp.asarray(g), jnp.asarray(u)))


@pytest.mark.parametrize("a", [0.0, 0.9, -0.5])
def test_kerr_delta_and_kerr_schild_metric(a):
    r, th = _metric_points(seed=12)
    close(tkerr.delta(T(r), a), jkerr.delta(r, a))
    close(tkerr.ks_metric_cov(T(r), T(th), a), jkerr.ks_metric_cov(r, th, a))


def test_public_matricant_and_opacity_matrix():
    """Generic coefficients, |rho| ~ |a|: no Faraday-thick cell, so
    grtrans_tpu's own eigenvalues are exact here."""
    rng = np.random.default_rng(13)
    aI = 10.0 ** rng.uniform(-3.0, -1.0, (8, 30))
    apol = rng.normal(size=(8, 30, 3)) * 0.3 * aI[..., None]
    a = np.concatenate([aI[..., None], apol], -1)
    rho = rng.normal(size=(8, 30, 3)) * aI[..., None]
    dx = rng.uniform(0.5, 20.0, (8, 30))
    close(tsol.opacity_matrix(T(a), T(rho)), jsol.opacity_matrix(a, rho))
    close(tsol.calc_O(T(a), T(rho), T(dx)), jsol.calc_O(a, rho, dx))


def test_to_lnrf_storage():
    r, th = _metric_points(seed=14)
    a = 0.9375
    rng = np.random.default_rng(15)
    u = np.array(jkerr.rms_vel(a, th, np.maximum(r, 7.0)))
    b = rng.normal(size=(60, 4))
    ours = tgrmhd3d.to_lnrf_storage(T(u), T(b), T(r), T(th), a)
    ref = jgrmhd3d.to_lnrf_storage(u, b, r, th, a)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if v is None:
            assert ours[k] is None
        else:
            close(ours[k], v)
