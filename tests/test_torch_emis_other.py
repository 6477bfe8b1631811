"""Parity of the port's non-synchrotron emissivities (blackbody,
Chandrasekhar table, bremsstrahlung, Maxwellian mixtures, binned
synchrotron, tabulated F_nu) and of their dispatch by name with grtrans_tpu,
on seeded samples.

Tolerance: max|d| <= 1e-12 * max|ref| per coefficient column, and the
same elementwise wherever the reference is above 1e-250 of that column's
largest value (the samples span hundreds of decades: T from 1e3 to 1e12 K
makes (1e5 / T)**10 run from 1e20 to 1e-70 and B_nu underflow to its
floor).  The mixtures sum polsynchth over a temperature ladder; its rho_V
is rounding noise divided by K_2(1 / theta_e) for 1e-2 < theta_e < 0.1
(tests/test_torch_bessel_polsynch.py), so samples whose ladder reaches
into that band are left out of the rho_V column, and only there."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from grtrans_tpu import driver as jdriver
from grtrans_tpu.emis import bb as jbb
from grtrans_tpu.emis import binned as jbinned
from grtrans_tpu.emis import brems as jbrems
from grtrans_tpu.emis import chandra as jchandra
from grtrans_tpu.emis import framework as jframework
from grtrans_tpu.emis import mixtures as jmix
from grtrans_tpu.fluid.base import EmisInputs as JEmisInputs
from grtrans_tpu.fluid.base import SourceParams as JSourceParams
from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch import driver as tdriver
from grtrans_tpu_torch.emis import bb as tbb
from grtrans_tpu_torch.emis import binned as tbinned
from grtrans_tpu_torch.emis import brems as tbrems
from grtrans_tpu_torch.emis import chandra as tchandra
from grtrans_tpu_torch.emis import framework as tframework
from grtrans_tpu_torch.emis import mixtures as tmix
from grtrans_tpu_torch.fluid.base import EmisInputs, SourceParams

torch.set_num_threads(1)   # the suite runs in parallel worker processes

SHAPE = (24, 40)
NBIN = 12
RHO_V = 10


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in arrays]


def _close(name, ours, ref, keep=None, skip_columns=None, rtol=1e-12):
    """Per trailing column: absolute to rtol of the column's largest value
    and elementwise to rtol where the reference is not denormal-small."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    if ours.ndim == len(SHAPE):
        ours, ref = ours[..., None], ref[..., None]
    for c in range(ref.shape[-1]):
        o, f = ours[..., c], ref[..., c]
        if keep is not None and skip_columns and c in skip_columns:
            o, f = o[keep], f[keep]
        np.testing.assert_array_equal(np.isfinite(o), np.isfinite(f),
                                      err_msg=f"{name}[{c}]")
        fin = np.isfinite(f)
        if not fin.any():
            continue
        o, f = o[fin], f[fin]
        scale = np.abs(f).max()
        assert np.abs(o - f).max() <= rtol * scale, f"{name}[{c}]"
        big = np.abs(f) > 1e-250 * scale
        if big.any():
            rel = np.abs(o[big] - f[big]) / np.abs(f[big])
            assert rel.max() <= rtol * 10, f"{name}[{c}] rel {rel.max()}"


def _samples(seed):
    """n, B, T, angle, frequency, cosine, density of nonthermal electrons;
    T log-uniform over 1e3 .. 1e12 K, nu over 1e9 .. 1e19 Hz."""
    rng = np.random.default_rng(seed)
    n = 10.0 ** rng.uniform(0, 10, SHAPE)
    b = 10.0 ** rng.uniform(-3, 4, SHAPE)
    T = 10.0 ** rng.uniform(3, 12, SHAPE)
    theta = rng.uniform(0.01, np.pi - 0.01, SHAPE)
    nu = 10.0 ** rng.uniform(9, 19, SHAPE)
    cosne = rng.uniform(-0.2, 1.2, SHAPE)      # beyond the table's ends too
    nnth = 10.0 ** rng.uniform(-2, 6, SHAPE)
    return n, b, T, theta, nu, cosne, nnth


def test_interp_chandra():
    mu = np.concatenate([np.random.default_rng(0).uniform(-0.2, 1.2, 500),
                         np.asarray(tchandra.CH_MU)])
    ours = tchandra.interp_chandra(torch.from_numpy(mu))
    ref = jchandra.interp_chandra(jnp.asarray(mu))
    for o, f in zip(ours, ref):
        _close("interp_chandra", o.numpy()[None], np.asarray(f)[None])
    np.testing.assert_array_equal(np.asarray(tchandra.CH_I),
                                  np.asarray(jchandra.CH_I))
    # limb darkening and polarization at the table's ends
    I, d = tchandra.interp_chandra(torch.tensor([0.0, 1.0],
                                                dtype=torch.float64))
    assert I.tolist() == [0.41441, 1.26938] and d.tolist() == [0.11713, 0.0]


@pytest.mark.parametrize("name", ["bbemis", "fbbemis", "fbbpolemis",
                                  "rhoemis", "brememis_heroic",
                                  "brememis_gray"])
def test_blackbody_and_bremsstrahlung(name):
    n, _, T, _, nu, cosne, _ = _samples(1)
    args = {"bbemis": (nu, T), "fbbemis": (nu, T, 1.7),
            "fbbpolemis": (nu, T, 1.3, cosne), "rhoemis": (n, cosne),
            "brememis_heroic": (nu, n, T), "brememis_gray": (nu, n, T)}[name]
    jmod, tmod = (jbrems, tbrems) if name.startswith("brem") else (jbb, tbb)
    ref = np.asarray(getattr(jmod, name)(*args))
    ours = getattr(tmod, name)(
        *(torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for v in args))
    assert ours.shape == SHAPE + (11,) and ours.dtype == torch.float64
    _close(name, ours, ref)
    lit = {"fbbpolemis": [0, 1], "brememis_heroic": [0, 4],
           "brememis_gray": [0, 4]}.get(name, [0])
    for c in range(11):
        assert (ref[..., c] != 0).any() == (c in lit)
    if name == "fbbpolemis":                # its f is ignored: 1.8 inside
        again = tbb.fbbpolemis(*_t(nu, T), 2.5, *_t(cosne))
        assert torch.equal(again, ours)
    if name == "brememis_heroic":           # both cuts of h nu / k T
        arg = pc.h * nu / (pc.k * T)
        assert (arg > 100).any() and (arg < 1e-8).any()


def _band_free(T, otherargs):
    """Samples none of whose ladder temperatures has theta_e in the rho_V
    noise band."""
    w = np.asarray(otherargs[1:], float)
    w = w / w.sum()
    deltas = float(otherargs[0]) ** np.arange(len(w))
    tmin = T / (w * deltas).sum()
    thetae = pc.k * tmin[..., None] * deltas / (pc.m * pc.c2)
    return ~((thetae > 1e-2) & (thetae < 0.1)).any(-1)


@pytest.mark.parametrize("name,otherargs", [
    ("maxjutt", (3.5, 1, 1, 1, 1, 1, 1)), ("maxjutt", (2.0, 3, 1, 0.5)),
    ("maxcomp", (3.5, 2, 1, 1, 1, 1)), ("maxcomp", (3.5, 0, 1, 2)),
    ("maxcomp", (2.5, 3, 1, 2, 3))])
def test_mixtures(name, otherargs):
    n, b, T, theta, nu, _, _ = _samples(2)
    T = 10.0 ** np.random.default_rng(20).uniform(8, 12, SHAPE)
    nu = np.minimum(nu, 1e15)
    ref = getattr(jmix, name)(nu, n, b, T, theta, otherargs)
    ours = getattr(tmix, name)(*_t(nu, n, b, T, theta), otherargs)
    ladder = otherargs if name == "maxjutt" \
        else (otherargs[0],) + tuple(otherargs[2:])
    keep = _band_free(T, ladder)
    assert 0.2 < keep.mean() < 1.0
    _close(f"{name}{otherargs}", ours, ref, keep, skip_columns=(RHO_V,))


@pytest.mark.parametrize("fn", ["_fx", "_k53x"])
def test_binned_fits(fn):
    x = np.concatenate([10.0 ** np.random.default_rng(3).uniform(-9, 4, 2000),
                        [0.0, 1e-6, 1000.0, 1e-40]])
    _close(fn, getattr(tbinned, fn)(torch.from_numpy(x)).numpy()[None],
           np.asarray(getattr(jbinned, fn)(jnp.asarray(x)))[None])


def _bins(seed):
    rng = np.random.default_rng(seed)
    edges = np.logspace(0.5, 5, NBIN + 1)
    gammas = np.sqrt(edges[1:] * edges[:-1])
    dgammas = edges[1:] - edges[:-1]
    nbins = 10.0 ** rng.uniform(-8, 0, SHAPE + (NBIN,)) \
        * gammas ** -2.5
    return nbins, gammas, dgammas


def test_synchbinemis():
    _, b, _, theta, nu, _, _ = _samples(4)
    b[0, :4] = 0.0                           # the a_I guard on B = 0
    nbins, gammas, dgammas = _bins(4)
    ref = jbinned.synchbinemis(nu, nbins, b, theta, gammas, dgammas)
    ours = tbinned.synchbinemis(*_t(nu, nbins, b, theta, gammas, dgammas))
    _close("synchbinemis", ours, ref)
    assert (np.asarray(ref)[..., 0] > 0).any()


def test_invariant_intensity():
    rng = np.random.default_rng(5)
    j = rng.normal(size=SHAPE + (4,))
    g = rng.uniform(0.1, 2.0, SHAPE)
    _close("invariant_intensity",
           tframework.invariant_intensity(*_t(j, g), 3),
           jframework.invariant_intensity(j, g, 3))


NEW_NAMES = ["BB", "FBB", "BBPOL", "MAXJUTT", "MAXCOMP", "SYNCHBIN",
             "POLSYNCHBIN", "BREMS", "BREMSHEROIC", "BREMSGRAY", "RHO",
             "INTERP"]


@pytest.mark.parametrize("ename,otherargs", [(n, None) for n in NEW_NAMES] + [
    ("MAXJUTT", (2.0, 1, 2, 1)), ("MAXCOMP", (2.0, 1, 2, 1))])
def test_calc_emissivity_dispatch_matches_jax(ename, otherargs):
    n, b, T, theta, nu, cosne, nnth = _samples(6)
    if ename in ("MAXJUTT", "MAXCOMP"):
        T = 10.0 ** np.random.default_rng(60).uniform(8, 12, SHAPE)
        nu = np.minimum(nu, 1e15)
    nbins, gammas, dgammas = _bins(6)
    rng = np.random.default_rng(61)
    freq_tab = np.logspace(12, 18, 9)          # nu runs off both ends
    fnu = 10.0 ** rng.uniform(-20, 5, SHAPE + (9,))
    fnu[1, :, 3] = 0.0                         # empty table entries
    extra = dict(fnu=fnu, freq_tab=freq_tab, nbins=nbins, gammas=gammas,
                 dgammas=dgammas)
    ref = jdriver.calc_emissivity(
        ename, nu, JEmisInputs(n, T, b, nnth, **extra), theta, cosne,
        JSourceParams(otherargs=otherargs))
    ours = tdriver.calc_emissivity(
        ename, *_t(nu), EmisInputs(*_t(n, T, b, nnth), **dict(zip(
            extra, _t(*extra.values())))), *_t(theta, cosne),
        SourceParams(otherargs=otherargs))
    assert ours.shape == SHAPE + (11,)
    keep = None
    if ename in ("MAXJUTT", "MAXCOMP"):
        # the defaults: six equal components, MAXCOMP selecting the first
        ladder = otherargs or (3.5, 1, 1, 1, 1, 1, 1, 1)[:7 + (
            ename == "MAXCOMP")]
        keep = _band_free(T, ladder if ename == "MAXJUTT"
                          else (ladder[0],) + tuple(ladder[2:]))
    _close(ename, ours, ref, keep, skip_columns=(RHO_V,))
    assert (np.asarray(ref)[..., 0] != 0).any()
    if ename == "INTERP":
        j = np.asarray(ref)[..., 0]
        assert (j[(nu < 1e12) | (nu > 1e18)] == 0).all() and (j[1] == 0).any()


def test_calc_emissivity_refuses_an_unknown_name():
    z = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="NOSUCH"):
        tdriver.calc_emissivity("nosuch", z + 1e11, EmisInputs(z, z, z, z),
                                z, z, SourceParams())
    with pytest.raises(ValueError, match="NOSUCH"):
        jdriver.calc_emissivity("nosuch", 1e11, JEmisInputs(0, 0, 0, 0), 0,
                                0, JSourceParams())
