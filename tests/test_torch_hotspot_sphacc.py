"""Parity of the port's orbiting hotspots (HOTSPOT with its four field
options, SCHNITTMAN) and of spherical accretion (SPHACC) with grtrans_tpu,
on the CPU.

Tolerances.  `vals` and `convert` on a seeded bundle of points around the
spot's orbit, at two frame times: max|d| <= 1e-12 * max|ref| per field.
SPHACC's flow is solved by the same scipy calls in both packages, so the
tables are held to be equal bit for bit.  Whole images through both
`grtrans_run`s (HOTSPOT 3 frames and SCHNITTMAN 2 frames, the problems of
tests/test_e2e.py:128-152) and through both `Grtrans` classes (SPHACC +
SYNCHTHAV on the radial strip of tests/test_golden.py:69-73 at 64 pixels x
100 points x 5 frequencies, which takes calc_spec's ny == 1 branch):
relative L1 over all Stokes components and cameras <= 1e-8 (measured:
HOTSPOT 7.6e-10, SCHNITTMAN 1.1e-9, SPHACC 3.9e-11 at its worst
frequency)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from grtrans_tpu.api import Grtrans as JGrtrans
from grtrans_tpu.config import GrtransConfig as JGrtransConfig
from grtrans_tpu.fluid import hotspot as jhot
from grtrans_tpu.fluid import sphacc as jsph
from grtrans_tpu.fluid.base import SourceParams as JSourceParams
from grtrans_tpu.geometry import kerr as jkerr
from grtrans_tpu.orchestrator import grtrans_run as jgrtrans_run
from grtrans_tpu_torch import convert
from grtrans_tpu_torch.api import Grtrans
from grtrans_tpu_torch.fluid import sphacc as tsph
from grtrans_tpu_torch.fluid.base import SourceParams, load_fluid_model
from grtrans_tpu_torch.geometry import fourvector as tfv
from grtrans_tpu_torch.geometry import kerr as tkerr
from grtrans_tpu_torch.orchestrator import grtrans_run

torch.set_num_threads(1)   # the suite runs in parallel worker processes

A = 0.9
NPIX, NPTS = 24, 40
SPOT = dict(rspot=1.5, r0spot=6.0, n0spot=4e7)

SPOTS = {
    "HOTSPOT_toroidal": jhot.HotSpot(**SPOT),
    "HOTSPOT_poloidal": jhot.HotSpot(bl06=0, **SPOT),
    "HOTSPOT_vertical": jhot.HotSpot(bl06=-2, tspot=5.0, **SPOT),
    "HOTSPOT_polvec": jhot.HotSpot(bl06=3, **SPOT),
    "SCHNITTMAN": jhot.SchnittmanHotspot(tspot=-3.0, **SPOT),
}


def _points(seed=0):
    """(npix, npts, 4) points from inside the ISCO to r = 30, most of them
    within 3 M of the orbit's plane so that the spot is sampled, with
    photon wavevectors; the last points of each ray lie far away."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.6, 12.0, (NPIX, NPTS))
    r[:, -3:] = 10.0 ** rng.uniform(3, 6, (NPIX, 3))
    th = np.pi / 2 + rng.uniform(-0.5, 0.5, (NPIX, NPTS))
    x = np.stack([rng.uniform(-60, 0, r.shape), r, th,
                  rng.uniform(-3, 3, r.shape)], axis=-1)
    k = np.array(jkerr.calc_nullp(
        rng.uniform(0, 40, r.shape), rng.uniform(-5, 5, r.shape), A, r,
        np.cos(th), rng.choice([-1.0, 1.0], r.shape),
        rng.choice([-1.0, 1.0], r.shape)))
    return x, k


def _close(name, ours, ref, rtol=1e-12):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(ours), fin, err_msg=name)
    scale = np.abs(ref[fin]).max()
    assert np.abs(ours[fin] - ref[fin]).max() <= rtol * scale, name


@pytest.mark.parametrize("time", [0.0, 37.5])
@pytest.mark.parametrize("name", sorted(SPOTS))
def test_spot_vals_and_convert_match_jax(name, time):
    jmodel = SPOTS[name]
    tmodel = convert.analytic_from_fields(
        name.split("_")[0], dataclasses.asdict(jmodel), "cpu")
    assert tmodel.timedep
    x, k = _points()
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    ref = jmodel.vals(jnp.asarray(x), jnp.asarray(k), A, time=time)
    ours = tmodel.vals(xt, kt, A, time=time)
    for field in ("rho", "p", "bmag", "u", "b", "rho2"):
        _close(f"{name}.{field}", getattr(ours, field), getattr(ref, field))
    n = ours.rho.numpy()
    assert (n > 0).any() and (n == 0).any()      # inside and past the cut
    if name.startswith("HOTSPOT"):
        # unit field where the spot is cut, also on the far points
        assert (ours.bmag.numpy()[:, -3:] > 0).all()
    eref = jmodel.convert(ref, JSourceParams())
    eours = tmodel.convert(ours, SourceParams())
    for field in ("ncgs", "tcgs", "bcgs", "ncgsnth"):
        _close(f"{name}.{field}", getattr(eours, field),
               getattr(eref, field))
    # the frame's time moves the spot
    other = tmodel.vals(xt, kt, A, time=time + 16.0)
    assert not torch.equal(other.rho, ours.rho)
    # a four-velocity, and for the toroidal field b.u = 0
    g = tkerr.metric_cov(xt[..., 1], xt[..., 2], A)
    near = xt[..., 1] < 100.0
    assert (tfv.dot(g, ours.u, ours.u)[near] + 1.0).abs().max() <= 1e-10
    if name in ("HOTSPOT_toroidal", "SCHNITTMAN"):
        bu = tfv.dot(g, ours.b, ours.u)[near]
        assert (bu.abs() <= 1e-10 * (1.0 + ours.bmag[near])).all()


@pytest.mark.parametrize("name", ["HOTSPOT", "SCHNITTMAN"])
def test_spot_advances_like_jax(name):
    """advance(dt) shifts tspot with the model's own sign, and equals a
    later frame time."""
    jmodel = dataclasses.replace(SPOTS["HOTSPOT_toroidal" if name == "HOTSPOT"
                                       else name])
    tmodel = load_fluid_model(name, device="cpu",
                              **dataclasses.asdict(jmodel))
    x, k = _points(1)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    later = tmodel.vals(xt, kt, A, time=16.0)
    assert tmodel.advance(16.0) is tmodel
    assert tmodel.tspot == jmodel.advance(16.0).tspot
    moved = tmodel.vals(xt, kt, A)
    assert torch.equal(moved.rho, later.rho)


@pytest.fixture(scope="module")
def bondi():
    jm = jsph.SphAcc(nr=120)
    return jm, load_fluid_model("SPHACC", device="cpu", nr=120)


def test_sphacc_solves_the_same_flow_as_jax(bondi):
    jm, tm = bondi
    np.testing.assert_array_equal(tm.r_tab.numpy(), np.asarray(jm.r_tab))
    np.testing.assert_array_equal(tm.packed[:, 0].numpy(),
                                  np.asarray(jm.v_tab))
    np.testing.assert_array_equal(tm.packed[:, 1].numpy(),
                                  np.asarray(jm.T_tab))
    # row ix of the packed table: (u^r, T) at radii ix and ix + 1
    np.testing.assert_array_equal(tm.packed[:-1, 2:].numpy(),
                                  tm.packed[1:, :2].numpy())
    assert (tsph.GAMMA, tsph.TINF, tsph.NINF, tsph.ALPHA, tsph.US) == (
        jsph.GAMMA, jsph.TINF, jsph.NINF, jsph.ALPHA, jsph.US)
    # an accretion flow: infall speeds up and the gas heats up inward
    assert (np.diff(tm.packed[:, 0].numpy()) < 0).all()
    assert (np.diff(tm.packed[:, 1].numpy()) < 0).all()
    assert tm.packed[0, 1] > 1e11 > tm.packed[-1, 1]   # anchored at r = 2


def test_sphacc_vals_and_convert_match_jax(bondi):
    jm, _ = bondi
    tm = convert.table_model_from_arrays(
        "SPHACC", "cpu", r_tab=np.asarray(jm.r_tab),
        v_tab=np.asarray(jm.v_tab), T_tab=np.asarray(jm.T_tab))
    rng = np.random.default_rng(2)
    x = np.zeros((NPIX, NPTS, 4))
    x[..., 1] = 10.0 ** rng.uniform(np.log10(2.05), 4.5, (NPIX, NPTS))
    x[..., 2] = rng.uniform(0.1, 3.0, (NPIX, NPTS))
    k = rng.normal(size=x.shape)
    ref = jm.vals(jnp.asarray(x), jnp.asarray(k), 0.0)
    ours = tm.vals(torch.from_numpy(x), torch.from_numpy(k), 0.0)
    for field in ("rho", "p", "bmag", "u", "b", "rho2"):
        _close(f"SPHACC.{field}", getattr(ours, field), getattr(ref, field))
    eref = jm.convert(ref, JSourceParams())
    eours = tm.convert(ours, SourceParams())
    for field in ("ncgs", "tcgs", "bcgs", "ncgsnth"):
        _close(f"SPHACC.{field}", getattr(eours, field),
               getattr(eref, field))
    # Schwarzschild: u.u = -1, b.u = 0, b.b = B^2
    g = tkerr.metric_cov(torch.from_numpy(x[..., 1]),
                         torch.from_numpy(x[..., 2]), 0.0)
    assert (tfv.dot(g, ours.u, ours.u) + 1.0).abs().max() <= 1e-10
    assert (tfv.dot(g, ours.b, ours.u).abs() <= 1e-10 * ours.bmag).all()
    torch.testing.assert_close(tfv.dot(g, ours.b, ours.b).sqrt(), ours.bmag,
                               rtol=1e-10, atol=0.0)


SPOT_CAMERA = dict(ename="POLSYNCHPL", nvals=4, standard=1, mbh=4e6,
                   mumin=0.5, mumax=0.5, nfreq=1, fmin=2.3e11, fmax=2.3e11,
                   iname="formal", gridvals=(-12.0, 12.0, -12.0, 12.0),
                   fargs=SPOT)
PROBLEMS = {
    # tests/test_e2e.py:132-137 at 3 frames, on SCHNITTMAN's 16x16x48
    # camera (the bar does not depend on the camera's size)
    "hotspot": dict(SPOT_CAMERA, fname="HOTSPOT", spin=0.9, nn=(16, 16, 48),
                    nt=3, dt=16.0),
    # tests/test_e2e.py:146-151 at 2 frames
    "schnittman": dict(SPOT_CAMERA, fname="SCHNITTMAN", spin=0.5,
                       nn=(16, 16, 48), nt=2, dt=30.0),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_light_curve_matches_jax(name):
    kw = PROBLEMS[name]
    ref, ab, _ = jgrtrans_run(JGrtransConfig(**kw))
    cfg = convert.config_from_jax(JGrtransConfig(**kw))
    ours, tab, _ = grtrans_run(cfg, device="cpu")
    ours, ref = ours.numpy(), np.asarray(ref)
    npix = kw["nn"][0] * kw["nn"][1]
    assert ours.shape == ref.shape == (kw["nt"], npix, 4)
    np.testing.assert_array_equal(tab.numpy(), ab)
    assert np.isfinite(ours).all() and ours[..., 0].max() > 0
    rel_l1 = np.abs(ours - ref).sum() / np.abs(ref).sum()
    lc = ours[..., 0].sum(1)
    print(f"{name}: light curve {lc}, rel L1 {rel_l1:.3e}")
    assert rel_l1 <= 1e-8
    # the frames differ: the spot has moved
    assert np.abs(np.diff(lc)).min() > 1e-3 * lc.mean()
    # pixel blocks sample the same frames
    blocks, _, _ = grtrans_run(cfg, device="cpu", chunk=100)
    np.testing.assert_allclose(blocks.numpy(), ours, rtol=0.0,
                               atol=1e-12 * np.abs(ours).max())


def test_sphacc_strip_and_spectrum_match_jax():
    kw = dict(fname="SPHACC", ename="SYNCHTHAV", nvals=1, spin=0.0,
              standard=1, nn=(64, 1, 100), uout=0.0025, mbh=1.0, nfreq=5,
              fmin=1e8, fmax=1e15, mumin=0.1, mumax=0.1, nmu=1,
              gridvals=(0.0, 400.0, 0.0, 0.0), fargs=dict(nr=120))
    ours = Grtrans(**kw).run(device="cpu")
    ref = JGrtrans(**kw).run()
    assert ours.ivals.shape == ref.ivals.shape == (64, 1, 5)
    assert np.isfinite(ours.ivals).all() and (ours.ivals.max(0) > 0).all()
    rel_l1 = np.abs(ours.ivals - ref.ivals).sum(0) / np.abs(ref.ivals).sum(0)
    print(f"sphacc: spectrum {ours.spec[:, 0]}, rel L1 per camera {rel_l1}")
    assert (rel_l1 <= 1e-8).all()
    # the annulus-weighted spectrum of a radial strip
    assert ours.spec.shape == ref.spec.shape == (5, 1)
    np.testing.assert_allclose(ours.spec, ref.spec, rtol=1e-9)
    assert (ours.da, ours.db) == (ref.da, ref.db) and ours.db == 0.0
