"""Parity of the port's analytic fluids (POWERLAW, SARIAF with both bl06
branches, TOY; THINDISK is in tests/test_torch_disks.py) and their Kerr
helpers with grtrans_tpu, on a seeded bundle of points that crosses the
ISCO and the models' window edges.

Tolerance: max|d| <= 1e-12 * max|ref| per field (measured <= 6.3e-16).  SARIAF
switches the four-velocity at r < r_ms, so samples within 1e-9 of the ISCO
are left out of the comparison (one ulp of r would flip them); none of the
seeded radii falls there, which the test asserts.  u.u = -1 and b.u = 0 are
held to 1e-10."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from grtrans_tpu.fluid import analytic as jan
from grtrans_tpu.fluid.base import SourceParams as JSourceParams
from grtrans_tpu.fluid.base import monika_e as jmonika
from grtrans_tpu.fluid.base import sigma_cut as jsigma_cut
from grtrans_tpu.geometry import kerr as jkerr
from grtrans_tpu_torch import convert
from grtrans_tpu_torch.fluid import base as tbase
from grtrans_tpu_torch.fluid.base import SourceParams
from grtrans_tpu_torch.geometry import fourvector as tfv
from grtrans_tpu_torch.geometry import kerr as tkerr

torch.set_num_threads(1)   # the suite runs in parallel worker processes

A = 0.9
NPIX, NPTS = 16, 48

MODELS = {
    "POWERLAW": jan.PowerLaw(pn=1.1, pt=0.84, pnth=2.9, rin=3.0, rout=30.0,
                             thin=-0.7, thout=0.8, phiin=0.3),
    "SARIAF": jan.Sariaf(),
    "SARIAF_bl06": jan.Sariaf(bl06=1, n0=2e7, pnth=2.5),
    "TOY": jan.Toy(n0=2.0, h=0.5, l0=1.5),
}


def _bundle(seed=0):
    """(npix, npts, 4) points from just outside the horizon to r = 40,
    dense around the ISCO, at all polar angles."""
    rng = np.random.default_rng(seed)
    rms = float(jkerr.calc_rms(A))
    r = np.concatenate([
        rng.uniform(1.0 + np.sqrt(1 - A * A) + 0.05, 40.0,
                    (NPIX, NPTS - 8)),
        rms + rng.uniform(-0.2, 0.2, (NPIX, 8))], axis=1)
    th = rng.uniform(0.05, np.pi - 0.05, (NPIX, NPTS))
    x = np.stack([rng.uniform(-50, 0, r.shape), r, th,
                  rng.uniform(-3, 3, r.shape)], axis=-1)
    k = rng.normal(size=x.shape)
    return x, k, rms


def _close(name, ours, ref, keep=None, rtol=1e-12):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    if keep is not None:
        ours, ref = ours[keep], ref[keep]
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(ours), fin, err_msg=name)
    scale = np.abs(ref[fin]).max() if fin.any() else 0.0
    assert np.abs(ours[fin] - ref[fin]).max() <= rtol * scale, name


@pytest.mark.parametrize("name", sorted(MODELS))
def test_vals_and_convert_match_jax(name):
    jmodel = MODELS[name]
    fname = name.split("_")[0]
    tmodel = convert.analytic_from_fields(
        fname, dataclasses.asdict(jmodel), "cpu")
    x, k, rms = _bundle()
    keep = np.abs(x[..., 1] - rms) > 1e-9
    assert keep.all()                      # none within an ulp of the ISCO
    assert (x[..., 1] < rms).any() and (x[..., 1] > rms).any()
    ref = jmodel.vals(jnp.asarray(x), jnp.asarray(k), A)
    ours = tmodel.vals(torch.from_numpy(x), torch.from_numpy(k), A)
    for field in ("rho", "p", "bmag", "u", "b", "rho2"):
        _close(f"{name}.{field}", getattr(ours, field), getattr(ref, field),
               keep)
    if fname == "POWERLAW":                # both sides of the windows
        assert (ours.rho == 0).any() and (ours.rho > 0).any()

    sp_kw = dict(mu=0.25, gmin=50.0)
    eref = jmodel.convert(ref, JSourceParams(**sp_kw))
    eours = tmodel.convert(ours, SourceParams(**sp_kw))
    for field in ("ncgs", "tcgs", "bcgs", "ncgsnth"):
        _close(f"{name}.{field}", getattr(eours, field),
               getattr(eref, field), keep)

    # a four-velocity and a field orthogonal to it
    g = tkerr.metric_cov(torch.from_numpy(x[..., 1]),
                         torch.from_numpy(x[..., 2]), A)
    # calc_u0 answers 1 where the prescribed 3-velocity is spacelike
    # (POWERLAW's Omega = phiin / r near the horizon); callers mask those
    ok = torch.isfinite(ours.u).all(-1) & (ours.u[..., 0] != 1.0)
    assert ok.float().mean() > 0.9
    uu = tfv.dot(g, ours.u, ours.u)[ok]
    bu = tfv.dot(g, ours.b, ours.u)[ok]
    bb = tfv.dot(g, ours.b, ours.b)[ok]
    assert (uu + 1.0).abs().max() <= 1e-10
    assert (bu.abs() <= 1e-10 * (1.0 + ours.bmag[ok])).all()
    lit = ours.bmag[ok] > 0
    torch.testing.assert_close(bb[lit].sqrt(), ours.bmag[ok][lit],
                               rtol=1e-10, atol=0.0)


def test_models_load_by_name_on_a_device_and_refuse_another():
    model = tbase.load_fluid_model("sariaf", device="cpu", n0=1e7)
    assert model.n0 == 1e7 and model.bl06 == 0
    x, k, _ = _bundle(1)
    with pytest.raises(ValueError, match="meta"):
        model.vals(torch.from_numpy(x).to("meta"),
                   torch.from_numpy(k).to("meta"), A)
    disk = tbase.load_fluid_model("THINDISK", device="cpu")
    assert (disk.a, disk.mbh, disk.mdot) == (0.998, 10.0, 0.1)
    assert convert.analytic_from_fields("thindisk", dict(mdot=0.3),
                                        "cpu").mdot == 0.3
    with pytest.raises(ValueError, match="unknown fluid model 'HARM2D'"):
        tbase.load_fluid_model("HARM2D", device="cpu")
    with pytest.raises(NotImplementedError, match="FFJET"):
        convert.analytic_from_fields("FFJET", {}, "cpu")


@pytest.mark.parametrize("a", [0.0, 0.5, 0.9, 0.998, -0.7])
def test_isco_constants_match_jax(a):
    np.testing.assert_allclose(tkerr.calc_rms(a), float(jkerr.calc_rms(a)),
                               rtol=1e-14)
    np.testing.assert_allclose(
        tkerr.calc_rms_constants(a),
        [float(v) for v in jkerr.calc_rms_constants(a)], rtol=1e-13)


def test_plunging_velocity_matches_jax():
    x, _, rms = _bundle(2)
    r, th = x[..., 1], x[..., 2]
    inside = r < rms
    rt, tht = torch.from_numpy(r), torch.from_numpy(th)
    _close("calc_plunging_vel", tkerr.calc_plunging_vel(A, rt),
           jkerr.calc_plunging_vel(A, jnp.asarray(r)), inside)
    _close("rms_vel", tkerr.rms_vel(A, tht, rt),
           jkerr.rms_vel(A, jnp.asarray(th), jnp.asarray(r)), inside)
    vr, vt, om = (np.random.default_rng(3).uniform(-0.1, 0.1, r.shape)
                  for _ in range(3))
    ours = tkerr.lnrf_frame(*(torch.from_numpy(v) for v in (vr, vt, om)),
                            rt, A, tht)
    ref = jkerr.lnrf_frame(vr, vt, om, jnp.asarray(r), A, jnp.asarray(th))
    for o, f in zip(ours, ref):
        _close("lnrf_frame", o, f)
    g = jkerr.metric_cov(jnp.asarray(r), jnp.asarray(th), A)
    _close("calc_u0", tkerr.calc_u0(torch.tensor(np.asarray(g)),
                                    *(torch.from_numpy(v)
                                      for v in (vr, vt, om))),
           jkerr.calc_u0(g, vr, vt, om))


def test_shared_converters_match_jax():
    rng = np.random.default_rng(4)
    rho, p, b = (10.0 ** rng.uniform(-3, 3, (NPIX, NPTS)) for _ in range(3))
    b[0, :5] = 0.0
    t = [torch.from_numpy(v) for v in (rho, p, b)]
    _close("monika_e", tbase.monika_e(*t, 3.0, 150.0),
           jmonika(rho, p, b, 3.0, 150.0))
    bcgs, rhocgs, tcgs, ncgs = (10.0 ** rng.uniform(-2, 4, (NPIX, NPTS))
                                for _ in range(4))
    rhocgs *= 1e-22
    ours = tbase.sigma_cut(*(torch.from_numpy(v)
                             for v in (bcgs, rhocgs, tcgs, ncgs)), 1.0)
    ref = jsigma_cut(bcgs, rhocgs, tcgs, ncgs, 1.0)
    for o, f in zip(ours, ref):
        _close("sigma_cut", o, f)
    assert (ours[0] == 0).any() and (ours[0] > 0).any()
