"""Parity of the port's diagnostic outputs with grtrans_tpu on the CPU:
the 19 extra channels of extra=1 and the debug=True dump of render_rays.

The extra channels are held on a SARIAF + POLSYNCHTH + formal render at
8x8 pixels x 48 points from uout = 0.0025 (where the thermal rho_V fit is
not rounding noise, see tests/test_torch_api.py).  Stokes: whole-image
relative L1 <= 1e-8 (measured 1.1e-10).  Extra channels: each channel's
relative L1 over the image <= 1e-8 (measured: worst 2.7e-10, on the
channels weighted by the growth of linear polarization a cell, which is a
difference of neighbouring Stokes samples; the exp(-tau)-weighted means
agree to 3.4e-11, the depths at the photosphere to 1.2e-10).  The
photosphere index is an argmin, which takes the first minimum on a tie in
both packages (held on rays whose |tau - 1| is the same at every sample);
no pixel of this image flips its index between the packages.

The debug dump: same keys and shapes; samples over valid points to 1e-9
of each quantity's largest value for g, densities and fields, 1e-8 for
the coefficients, 1e-7 for the pitch angle (measured 1.5e-8 rad: an
arccos of a projection that inherits the trace's k, held to 2e-7 at
p99.9 in tests/test_torch_geodesics.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from grtrans_tpu import driver as jdriver
from grtrans_tpu.api import Grtrans as JGrtrans
from grtrans_tpu.config import GrtransConfig as JGrtransConfig
from grtrans_tpu.fluid.base import EmisInputs as JEmisInputs
from grtrans_tpu.fluid.base import FluidVars as JFluidVars
from grtrans_tpu.fluid.base import load_fluid_model as jload_fluid_model
from grtrans_tpu.geodesics import camera as jcam
from grtrans_tpu.geodesics import geokerr as jgeo
from grtrans_tpu.geodesics.geokerr import GeodesicBundle as JBundle
from grtrans_tpu.orchestrator import _source_params as jsource_params
from grtrans_tpu_torch import driver as tdriver
from grtrans_tpu_torch.api import Grtrans
from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.fluid.base import (EmisInputs, FluidVars,
                                          load_fluid_model)
from grtrans_tpu_torch.geodesics import camera as tcam
from grtrans_tpu_torch.geodesics import geokerr as tgeo
from grtrans_tpu_torch.geodesics.geokerr import GeodesicBundle
from grtrans_tpu_torch.orchestrator import _source_params

torch.set_num_threads(1)   # the suite runs in parallel worker processes

RIAF = dict(fname="SARIAF", ename="POLSYNCHTH", nvals=4, spin=0.9,
            standard=1, nn=(8, 8, 48), mbh=4e6, mumin=0.5, mumax=0.5,
            nfreq=2, fmin=2.3e11, fmax=6.9e11, iname="formal", uout=0.0025,
            gridvals=(-15.0, 15.0, -15.0, 15.0),
            fargs=dict(n0=4e7, t0=1.6e11, beta=10.0))
CHANNELS = ["tau_I", "tau_Q", "tau_U", "tau_V", "rho_Q", "rho_V", "<r>",
            "<theta>", "<phi>", "<n>", "<T>", "<B>", "<beta>", "<side>",
            "lp<r>", "lp<theta>", "lp<tau_FR>", "lp<tau_FC>", "lp<side>"]


@pytest.fixture(scope="module")
def pair():
    kw = dict(RIAF, extra=1)
    return Grtrans(**kw).run(device="cpu"), JGrtrans(**kw).run()


def test_extra_render_has_19_more_columns(pair):
    ours, ref = pair
    assert ours.ivals.shape == ref.ivals.shape == (64, 4 + 19, 2)
    assert np.isfinite(ours.ivals).all()
    plain = Grtrans(**RIAF).run(device="cpu")
    # the Stokes columns are those of the plain render
    np.testing.assert_allclose(ours.ivals[:, :4], plain.ivals, rtol=0.0,
                               atol=1e-12 * np.abs(plain.ivals).max())
    stokes, jstokes = ours.ivals[:, :4], ref.ivals[:, :4]
    rel_l1 = np.abs(stokes - jstokes).sum() / np.abs(jstokes).sum()
    print(f"extra=1 Stokes rel L1 {rel_l1:.3e}")
    assert rel_l1 <= 1e-8
    # calc_spec sums every column and keeps the polarization fractions
    assert ours.spec.shape == (23, 2)
    np.testing.assert_allclose(ours.lp, plain.lp, rtol=1e-10)
    np.testing.assert_allclose(ours.lp, ref.lp, rtol=1e-6)


@pytest.mark.parametrize("channel", range(19), ids=CHANNELS)
def test_extra_channel_matches_jax(pair, channel):
    ours, ref = pair
    o, f = ours.ivals[:, 4 + channel], ref.ivals[:, 4 + channel]
    rel_l1 = np.abs(o - f).sum(0) / np.abs(f).sum(0)
    print(f"{CHANNELS[channel]}: mean |ref| {np.abs(f).mean(0)}, "
          f"rel L1 {rel_l1}")
    assert (np.abs(f).sum(0) > 0).all()
    assert (rel_l1 <= 1e-8).all()


def _thin_ray_inputs():
    """Two rays of 6 samples with no absorption at all: tau_I = 0
    everywhere, so |tau_I - 1| ties at every sample; and one ray thick
    from its second cell on."""
    npix, npts = 3, 6
    rng = np.random.default_rng(0)
    lam = np.tile(np.linspace(0.0, 5.0, npts), (npix, 1))
    x = rng.uniform(1.0, 3.0, (npix, npts, 4))
    j = rng.uniform(0.1, 1.0, (npix, npts, 4))
    K = np.zeros((npix, npts, 7))
    K[2, 1:, 0] = 2.0
    prof = rng.uniform(0.1, 1.0, (npix, npts, 4))
    scal = rng.uniform(0.5, 2.0, (6, npix, npts))
    ok = np.ones((npix, npts), bool)
    return lam, x, j, K, prof, scal, ok


def test_extra_channels_take_the_first_sample_on_a_tie():
    lam, x, j, K, prof, scal, ok = _thin_ray_inputs()
    z = np.zeros_like(lam)
    jgeo_b = JBundle(x=jnp.asarray(x), k=None, lam=jnp.asarray(lam),
                     mino=None, tpm=None, tpr=None, valid=None, status=None)
    ref = np.asarray(jdriver._extra_channels(
        jgeo_b, JFluidVars(z, scal[0], scal[1], None, None, z),
        JEmisInputs(scal[2], scal[3], scal[4], z), jnp.asarray(j),
        jnp.asarray(K), jnp.asarray(prof), jnp.asarray(ok)))
    t = torch.from_numpy
    zt = t(z)
    tgeo_b = GeodesicBundle(x=t(x), k=None, lam=t(lam), mino=None, tpm=None,
                            tpr=None, valid=None, status=None)
    ours = tdriver._extra_channels(
        tgeo_b, FluidVars(zt, t(scal[0]), t(scal[1]), None, None, zt),
        EmisInputs(t(scal[2]), t(scal[3]), t(scal[4]), zt), t(j), t(K),
        t(prof), t(ok)).numpy()
    assert ours.shape == ref.shape == (3, 19)
    np.testing.assert_allclose(ours, ref, rtol=1e-13, atol=0.0)
    # thin rays report the ray's end; the thick one its photosphere
    assert (ours[:2, 0] == 0).all() and 0.5 < ours[2, 0] < 3.0
    # a thin ray's weighted <r> is over the whole ray, not its first sample
    assert not np.isclose(ours[0, 6], x[0, 0, 1])


def _bundles():
    """One camera's geodesics, fluid and inputs in both packages."""
    cfg = GrtransConfig(**RIAF)
    jcfg = JGrtransConfig(**RIAF)
    out = []
    for cam_mod, geo_mod, load, src, c, kw, wrap in (
            (jcam, jgeo, jload_fluid_model, jsource_params, jcfg, {},
             jnp.asarray),
            (tcam, tgeo, load_fluid_model, _source_params, cfg,
             dict(device="cpu"), lambda v: v)):
        cam = cam_mod.make_camera(c.spin, c.mumin, *c.gridvals, 8, 8, **kw)
        geo = geo_mod.trace(c.spin, c.mumin, cam.alpha, cam.beta, cam.l,
                            cam.q2, cam.sm, cam.u0, 48, uout=c.uout,
                            phi0=c.phi0)
        model = load(c.fname, **kw, **c.fargs)
        fv = model.vals(geo.x, geo.k, c.spin)
        sp = src(c, float(c.mdotmin))
        out.append((geo, fv, model.convert(fv, sp), cam, sp, c))
    return out


@pytest.fixture(scope="module")
def dumps():
    (jg, jfv, jei, jc, jsp, jcfg), (tg, tfv_, tei, tc, tsp, cfg) = _bundles()
    freqs = [float(f) for f in cfg.freqs()]
    ref = jdriver.render_rays(jg, jfv, jei, "POLSYNCHTH", freqs, 0.5,
                              jc.alpha, jc.beta, 0.9, 4e6, jsp,
                              iname="formal", debug=True)
    ours = tdriver.render_rays(tg, tfv_, tei, "POLSYNCHTH", freqs, 0.5,
                               tc.alpha, tc.beta, 0.9, 4e6, tsp,
                               iname="formal", debug=True)
    plain = tdriver.render_rays(tg, tfv_, tei, "POLSYNCHTH", freqs, 0.5,
                                tc.alpha, tc.beta, 0.9, 4e6, tsp,
                                iname="formal")
    return ours, ref, plain


def test_debug_returns_the_image_and_the_dump(dumps):
    (ivals, dbg), (jivals, jdbg), plain = dumps
    assert set(dbg) == set(jdbg)
    assert {"x", "kvec", "lam", "mino", "tpm", "tpr", "valid", "u", "b",
            "rho", "p", "bmag", "ncgs", "tcgs", "bcgs", "ncgsnth", "s2xi",
            "c2xi", "ang", "g", "cosne", "ok", "nu_0", "j_0", "K_0",
            "prof_0", "nu_1", "j_1", "K_1", "prof_1"} == set(dbg)
    for key, val in dbg.items():
        assert tuple(val.shape) == tuple(jdbg[key].shape), key
    assert dbg["prof_0"].shape == (64, 48, 4) and dbg["K_1"].shape == (
        64, 48, 7)
    # the dump's profile ends in the image, which is the plain render's
    assert torch.equal(dbg["prof_1"][:, 0, :], ivals[1])
    torch.testing.assert_close(ivals, plain, rtol=0.0,
                               atol=1e-12 * plain.abs().max().item())
    rel_l1 = np.abs(ivals.numpy() - np.asarray(jivals)).sum() \
        / np.abs(np.asarray(jivals)).sum()
    assert rel_l1 <= 1e-8


@pytest.mark.parametrize("key,rtol", [("g", 1e-9), ("ang", 1e-7),
                                      ("ncgs", 1e-9), ("bcgs", 1e-9),
                                      ("j_0", 1e-8), ("K_1", 1e-8)])
def test_debug_dump_matches_jax(dumps, key, rtol):
    """Samples of the dump over valid points (bars: module docstring)."""
    (_, dbg), (_, jdbg), _ = dumps
    ok = np.asarray(jdbg["ok"])
    np.testing.assert_array_equal(dbg["ok"].numpy(), ok)
    ours, ref = dbg[key].numpy()[ok], np.asarray(jdbg[key])[ok]
    err = np.abs(ours - ref).max(0)
    assert (err <= rtol * np.abs(ref).max(0)).all(), err


def test_single_point_debug_has_no_profile():
    kw = dict(fname="THINDISK", ename="BBPOL", nvals=4, spin=0.9, standard=2,
              nn=(6, 6, 1), mbh=10.0, mumin=0.26, mumax=0.26, nfreq=1,
              fmin=1e17, fmax=1e17, gridvals=(-21.0, 21.0, -21.0, 21.0),
              extra=1, fargs=dict(mbh=10.0, mdot=0.1))
    cfg = GrtransConfig(**kw)
    cam = tcam.make_camera(0.9, 0.26, *cfg.gridvals, 6, 6, device="cpu")
    geo = tgeo.trace_polar(0.9, 0.26, cam.alpha, cam.beta, cam.l, cam.q2,
                           cam.sm, cam.u0, npts=1, phi0=cfg.phi0)
    model = load_fluid_model("THINDISK", device="cpu", **cfg.fargs)
    fv = model.vals(geo.x, geo.k, 0.9)
    sp = _source_params(cfg, 1.0)
    ivals, dbg = tdriver.render_rays(
        geo, fv, model.convert(fv, sp), "BBPOL", [1e17], 0.26, cam.alpha,
        cam.beta, 0.9, 10.0, sp, standard=2, extra=1, debug=True)
    # one point a ray: no extra channels and no profile
    assert ivals.shape == (1, 36, 4)
    assert "prof_0" not in dbg and dbg["j_0"].shape == (36, 1, 4)
    # through the API the same config, and the debug flag changes nothing
    ours = Grtrans(**kw, debug=1).run(device="cpu")
    ref = JGrtrans(**kw, debug=1).run()
    assert ours.ivals.shape == ref.ivals.shape == (36, 4, 1)
    np.testing.assert_allclose(ours.ivals[:, :, 0], ivals[0].numpy(),
                               rtol=1e-13)
    np.testing.assert_allclose(ours.ivals, ref.ivals, rtol=1e-8,
                               atol=1e-9 * np.abs(ref.ivals).max())
