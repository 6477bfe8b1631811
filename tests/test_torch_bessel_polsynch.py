"""Parity of the port's Bessel fits and thermal / hybrid synchrotron
coefficients with grtrans_tpu, on inputs made with numpy from a seed.

Tolerances.  Bessel functions: 1e-12 relative against grtrans_tpu (same
polynomial fits, last-bit differences of exp/log only) and the fits' own
accuracy against scipy over 1e-6..700 (measured on grtrans_tpu's
functions: I_0 4.7e-7, I_1 5.5e-7, K_0 1.5e-7, K_1 1.7e-7, K_2 1.3e-7,
K_3 1.6e-5 where the recurrence amplifies K_1's error at small x; the
bars are those, rounded up).  Coefficient blocks: max|d| <= tol * max|ref| per
coefficient column, tol 1e-12 (measured 1e-16 .. 6e-16), except the
power-law block, which carries the G(xmax) - G(xmin) cancellation of
POLSYNCHPL (2e-9 in tests/test_torch_emis.py, measured there; here
3.7e-13).

One band is left out of the rho_V comparison: 1e-2 < theta_e < 0.1.
There the fit computes gstep * G(X) / K_2(1/theta_e) with
gstep = 0.5 + 0.5 tanh((theta_e - 1) / 0.05), which is 0 or 1.1e-16
depending on the last bit of tanh(-19..-20) (torch rounds it to -1, XLA to
-1 + 1.1e-16), while K_2(1/theta_e) falls to 4.6e-45 at theta_e = 0.01:
the quotient is rounding noise times 1e28 in both packages (measured
rho_V 1.8e-13 in the port against -7.7e10 in grtrans_tpu at
theta_e = 0.01004).  The band's values are only required to be finite.
SARIAF's theta_e = 27 (r/2)^-0.84 stays above 2 inside r < 40, so no render
here reaches the band."""

import numpy as np
import pytest
import scipy.special as sp
import torch
import jax.numpy as jnp

from grtrans_tpu import driver as jdriver
from grtrans_tpu.emis import polsynch as jps
from grtrans_tpu.emis import polsynchpl as jpl
from grtrans_tpu.fluid.base import EmisInputs as JEmisInputs
from grtrans_tpu.fluid.base import SourceParams as JSourceParams
from grtrans_tpu.ops import bessel as jbes
from grtrans_tpu_torch import driver as tdriver
from grtrans_tpu_torch.emis import polsynch as tps
from grtrans_tpu_torch.emis import polsynchpl as tpl
from grtrans_tpu_torch.fluid.base import EmisInputs, SourceParams
from grtrans_tpu_torch.ops import bessel as tbes

torch.set_num_threads(1)   # the suite runs in parallel worker processes

NPIX, NPTS = 24, 40
# measured: see the module docstring and PERF.md
COEF_TOL = {"polsynchth": 1e-12, "sympolemisth": 1e-12, "synchemis": 1e-12,
            "synchemisnoabs": 1e-12, "synchpl": 2e-9, "HYBRIDTHPL": 2e-9,
            "polsynchpl_p": 2e-9}


def _bessel_x():
    """1e-6 .. 700, with both sides of the branch points 2 and 3.75."""
    edge = np.array([2.0, 3.75])
    return np.concatenate([np.logspace(-6, np.log10(700.0), 400),
                           np.nextafter(edge, 0.0), edge,
                           np.nextafter(edge, 10.0)])


SCIPY = {"besseli0": (lambda x: sp.ive(0, x), 6e-7, True),
         "besseli1": (lambda x: sp.ive(1, x), 6e-7, True),
         "besselk0": (lambda x: sp.kve(0, x), 2e-7, False),
         "besselk1": (lambda x: sp.kve(1, x), 2e-7, False),
         "besselk2": (lambda x: sp.kve(2, x), 2e-7, False)}


@pytest.mark.parametrize("name", sorted(SCIPY))
def test_bessel_matches_jax_and_scipy(name):
    x = _bessel_x()
    ours = getattr(tbes, name)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jbes, name)(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0.0)
    # exponentially scaled scipy values keep 700 inside float64
    scaled, rtol, grows = SCIPY[name]
    np.testing.assert_allclose(ours * np.exp(-x if grows else x), scaled(x),
                               rtol=rtol, atol=0.0)


def test_besselkn_recurrence():
    x = _bessel_x()
    ours = tbes.besselkn(3, torch.from_numpy(x)).numpy()
    # above 600 the recurrence's terms near 1e-308 round differently in XLA
    # (1.6e-5 apart at 700, each within the fit's error of scipy)
    np.testing.assert_allclose(ours[x < 600.0],
                               np.asarray(jbes.besselkn(3, x))[x < 600.0],
                               rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(ours * np.exp(x), sp.kve(3, x), rtol=2e-5)
    np.testing.assert_array_equal(
        tbes.besselkn(2, torch.from_numpy(x)).numpy(),
        tbes.besselk2(torch.from_numpy(x)).numpy())


def _samples(seed=0):
    """n, B, T, pitch angle and frequency over the SARIAF ranges: theta_e
    from 1e-3 (below the relativistic switch at 1e-2) to 100."""
    rng = np.random.default_rng(seed)
    shape = (NPIX, NPTS)
    n = 10.0 ** rng.uniform(2.0, 8.0, shape)
    b = 10.0 ** rng.uniform(-2.0, 3.0, shape)
    T = 5.93e9 * 10.0 ** rng.uniform(-3.0, 2.0, shape)
    theta = rng.uniform(0.02, np.pi - 0.02, shape)
    nu = 10.0 ** rng.uniform(10.5, 12.5, shape)
    nnth = 10.0 ** rng.uniform(0.0, 5.0, shape)
    return n, b, T, theta, nu, nnth


def _close(name, ours, ref, T=None):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape == (NPIX, NPTS, 11)
    assert np.isfinite(ref).all() and np.isfinite(ours).all()
    a = ours.reshape(-1, 11).copy()
    r = ref.reshape(-1, 11).copy()
    if T is not None:
        # rho_V in the gstep / K_2 noise band: see the module docstring
        thetae = (1.38e-16 * T / (9.10938188e-28 * 2.99792458e10 ** 2))
        band = ((thetae > 1e-2) & (thetae < 0.1)).reshape(-1)
        assert 0 < band.sum() < band.size // 2
        a[band, 10] = r[band, 10] = 0.0
    rel = np.abs(a - r).max(0) / np.maximum(np.abs(r).max(0), 1e-300)
    print(name, "max rel err per column", rel)
    assert (rel <= COEF_TOL[name]).all(), rel


@pytest.mark.parametrize("name", ["polsynchth", "sympolemisth"])
def test_thermal_polarized_matches_jax(name):
    n, b, T, theta, nu, _ = _samples()
    t = [torch.from_numpy(v) for v in (nu, n, b, T, theta)]
    _close(name, getattr(tps, name)(*t),
           getattr(jps, name)(nu, n, b, T, theta), T)


@pytest.mark.parametrize("name", ["synchemis", "synchemisnoabs"])
def test_thermal_unpolarized_matches_jax(name):
    n, b, T, _, nu, _ = _samples(1)
    t = [torch.from_numpy(v) for v in (nu, n, b, T)]
    ours = getattr(tps, name)(*t)
    _close(name, ours, getattr(jps, name)(nu, n, b, T))
    assert (ours[..., 1:4] == 0).all() and (ours[..., 5:] == 0).all()
    if name == "synchemisnoabs":
        assert (ours[..., 4] == 0).all()


def test_bnu_branches():
    T = torch.tensor([1e4, 1e9, 1e12, 1e12], dtype=torch.float64)
    nu = torch.tensor([1e15, 1e11, 1e11, 1e3], dtype=torch.float64)
    np.testing.assert_allclose(tps.bnu(T, nu).numpy(),
                               np.asarray(jps.bnu(T.numpy(), nu.numpy())),
                               rtol=1e-13)


def test_synchpl_matches_jax():
    _, b, _, theta, nu, nnth = _samples(2)
    args = (3.5, 100.0, 1e5)
    ours = tpl.synchpl(*(torch.from_numpy(v) for v in (nu, nnth, b, theta)),
                       *args)
    _close("synchpl", ours, jpl.synchpl(nu, nnth, b, theta, *args))
    assert (ours[..., [1, 2, 3, 5, 6, 7, 8, 9, 10]] == 0).all()


def test_polsynchpl_per_sample_p_matches_jax():
    """An index p per sample: the six cutoff integrals G(x; p) of one
    bilinear (p, log x) lookup (1e-12 relative against grtrans_tpu's _g,
    over x past both ends of the table and p past both ends and on its
    nodes) and the POLSYNCHPL coefficients that carry them, at gamma_min =
    10 (measured 6.1e-13).  At gamma_min = 100 and p near 8, G(x_max) -
    G(x_min) cancels to 1e-9 of G, which turns last-bit differences of the
    lookup into 6e-4 in both directions: the bar holds where the formula is
    conditioned."""
    rng = np.random.default_rng(4)
    shape = (NPIX, NPTS)
    p = rng.uniform(1.6, 7.9, shape)
    p.flat[:6] = [1.2, 1.5, 3.0, 3.5, 7.0, 8.5]
    x = 10.0 ** rng.uniform(-9.0, 4.0, shape)
    ours = tpl._g_all_p(torch.from_numpy(x), torch.from_numpy(p)).numpy()
    assert ours.shape == shape + (6,)
    for i, name in enumerate(tpl._G_ORDER):
        ref = np.asarray(jpl._g(name, jnp.asarray(x), jnp.asarray(p)))
        np.testing.assert_allclose(ours[..., i], ref, rtol=1e-12, atol=0.0,
                                   err_msg=name)
    _, b, _, theta, nu, nnth = _samples(5)
    t = [torch.from_numpy(v) for v in (nu, nnth, b, theta)]
    ours = tpl.polsynchpl(*t, torch.from_numpy(p), 10.0, 1e5)
    _close("polsynchpl_p", ours,
           jpl.polsynchpl(nu, nnth, b, theta, jnp.asarray(p), 10.0, 1e5))
    # a uniform p tensor agrees with the scalar path
    same = tpl.polsynchpl(*t, torch.full(shape, 3.5, dtype=torch.float64),
                          10.0, 1e5)
    _close("polsynchpl_p", same, tpl.polsynchpl(*t, 3.5, 10.0, 1e5))


@pytest.mark.parametrize("ename", ["HYBRIDTHPL", "POLSYNCHTH", "SYMPOLTH",
                                   "SYNCHTHAV", "SYNCHTHAVNOABS",
                                   "POLSYNCHPL", "SYNCHPL"])
def test_calc_emissivity_dispatch_matches_jax(ename):
    n, b, T, theta, nu, nnth = _samples(3)
    cosne = np.cos(theta)
    ref = jdriver.calc_emissivity(ename, nu, JEmisInputs(n, T, b, nnth),
                                  theta, cosne, JSourceParams())
    tt = {k: torch.from_numpy(v) for k, v in dict(
        n=n, b=b, T=T, theta=theta, nu=nu, nnth=nnth, cosne=cosne).items()}
    ours = tdriver.calc_emissivity(
        ename, tt["nu"], EmisInputs(tt["n"], tt["T"], tt["b"], tt["nnth"]),
        tt["theta"], tt["cosne"], SourceParams())
    _close("HYBRIDTHPL", ours, ref, T)


def test_calc_emissivity_names_what_is_not_ported():
    """Every emissivity of grtrans_tpu is ported (the non-synchrotron ones
    are held in tests/test_torch_emis_other.py); a name that neither
    package knows is refused by name, with grtrans_tpu's ValueError."""
    z = torch.zeros((2, 3), dtype=torch.float64)
    ei = EmisInputs(z + 1e3, z + 1e9, z + 10.0, z)
    for ename in ("BB", "BREMS", "MAXJUTT", "RHO"):
        e = tdriver.calc_emissivity(ename, z + 1e11, ei, z + 1.0, z + 0.5,
                                    SourceParams())
        assert e.shape == (2, 3, 11) and (e[..., 0] > 0).all()
    with pytest.raises(ValueError, match="KAPPA"):
        tdriver.calc_emissivity("KAPPA", z + 1e11, ei, z, z, SourceParams())
