"""The synthetic FFJET dump and the port's FFJET sampler against
grtrans_tpu.

The dump is float32 on disk, like the published file: the float64 fields
it is written from hold u.u = -1 and b.u = 0 to 1e-10, and the fields
read back hold them to float32 rounding (measured max |u.u + 1| 1.2e-7,
|b.u| / |b| 6e-8; bar 5e-7).  vals/convert are compared on grtrans_tpu's
own trace: max|d| <= 1e-12 * max|ref| per field.
"""

import jax
import numpy as np
import pytest
import torch

from grtrans_tpu.fluid import base as jbase
from grtrans_tpu.fluid.base import SourceParams
from grtrans_tpu.fluid.ffjet import FFJet as JFFJet
from grtrans_tpu.fluid.ffjet import load_ffjet_file as jload
from grtrans_tpu.geodesics import camera as jcam
from grtrans_tpu.geodesics import geokerr as jgeo
from grtrans_tpu.geometry import fourvector as jfv
from grtrans_tpu.geometry import kerr as jkerr
from grtrans_tpu_torch import convert
from grtrans_tpu_torch.fluid import base as tbase
from grtrans_tpu_torch.fluid.ffjet import load_ffjet_file as tload
from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump

torch.set_num_threads(1)   # the suite runs in parallel worker processes

A, MU0 = 0.998, 0.906


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("ffjet") / "ffjet.bin"
    g64, f64 = write_ffjet_dump(path)
    return path, g64, f64


def _norms(grids, fields):
    """u.u and b.u / |b| at the grid nodes, with grtrans_tpu's metric and
    the inverse LNRF map FFJet applies to the velocities."""
    nx = grids["nx"]
    r = np.broadcast_to(grids["uniqr"][None, :], (nx, nx))
    th = np.broadcast_to(grids["uniqth"][:, None], (nx, nx))
    a = grids["a"]
    vr, vt, om = jkerr.lnrf_frame_inv(fields["vr"], fields["vth"],
                                      fields["vph"], r, a, th)
    u0 = fields["u0"]
    u = np.stack([u0, u0 * vr, u0 * vt, u0 * om], -1)
    b = np.stack([fields[k] for k in ("b0", "br", "bth", "bph")], -1)
    g = jkerr.metric_cov(r, th, a)
    uu, bu, bb = (np.asarray(jfv.dot(g, x, y))[1:]   # theta=0 row: 0/0
                  for x, y in ((u, u), (b, u), (b, b)))
    return np.abs(uu + 1.0).max(), (np.abs(bu) / np.sqrt(bb)).max()


def test_dump_round_trip(dump):
    path, g64, f64 = dump
    grids, fields = jload(path)
    assert grids["nx"] == 128 and grids["a"] == g64["a"]
    np.testing.assert_array_equal(grids["uniqr"], g64["uniqr"])
    np.testing.assert_array_equal(grids["uniqth"], g64["uniqth"])
    for k, v in f64.items():
        np.testing.assert_array_equal(
            fields[k], v.astype(np.float32).astype(np.float64))
    uu, bu = _norms(g64, f64)
    assert uu <= 1e-10 and bu <= 1e-10
    uu, bu = _norms(grids, fields)
    assert uu <= 5e-7 and bu <= 5e-7
    # the port reads the file identically
    tg, tf = tload(path)
    assert tg.keys() == grids.keys() and tf.keys() == fields.keys()
    for k in grids:
        np.testing.assert_array_equal(tg[k], grids[k])
    for k in fields:
        np.testing.assert_array_equal(tf[k], fields[k])
    assert fields["rho"].min() > 0
    v2 = fields["vr"] ** 2 + fields["vth"] ** 2 + fields["vph"] ** 2
    assert v2.max() <= 0.25


@pytest.fixture(scope="module")
def sampled(dump):
    path, _, _ = dump
    cj = jcam.make_camera(A, MU0, -40.0, 20.0, -20.0, 40.0, 16, 16)
    geo = jax.tree_util.tree_map(np.asarray, jgeo.trace(
        A, MU0, cj.alpha, cj.beta, cj.l, cj.q2, cj.sm, cj.u0, 64, uout=0.01,
        phi0=-0.5))
    jm = JFFJet(dfile=str(path))
    tm = convert.ffjet_from_arrays(*jload(path), device="cpu")
    sp = SourceParams()
    fj = jm.vals(geo.x, geo.k, A)
    ej = jm.convert(fj, sp)
    ft = tm.vals(torch.tensor(geo.x), torch.tensor(geo.k), A)
    et = tm.convert(ft, sp)
    return fj, ej, ft, et


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(b)
    assert np.abs(a[fin] - b[fin]).max() <= rtol * np.abs(b[fin]).max()


@pytest.mark.parametrize("field", ["rho", "p", "bmag", "u", "b", "rho2"])
def test_vals(sampled, field):
    fj, _, ft, _ = sampled
    _close(getattr(ft, field), getattr(fj, field))


@pytest.mark.parametrize("field", ["ncgs", "tcgs", "bcgs", "ncgsnth"])
def test_convert(sampled, field):
    _, ej, _, et = sampled
    _close(getattr(et, field), getattr(ej, field))
    if field == "ncgsnth":
        assert np.asarray(ej.ncgsnth).max() > 0


@pytest.mark.parametrize("p2", [3.5, 3.0])
def test_apply_source_params_tail(p2):
    """The stype='tail' gamma_min model on a thermal population."""
    rng = np.random.default_rng(5)
    tcgs = 10.0 ** rng.uniform(9.0, 12.0, (64, 8))
    ncgs = 10.0 ** rng.uniform(2.0, 6.0, (64, 8))
    z = np.zeros_like(tcgs)
    kw = dict(stype=jbase.TAIL, p2=p2, gmax=50.0, jetalpha=0.02, mu=0.25)
    ej, gj = jbase.apply_source_params(
        jbase.EmisInputs(ncgs=ncgs, tcgs=tcgs, bcgs=z, ncgsnth=z),
        jbase.SourceParams(**kw))
    et, gt = tbase.apply_source_params(
        tbase.EmisInputs(*(torch.tensor(x) for x in (ncgs, tcgs, z, z))),
        tbase.SourceParams(**kw))
    assert (np.asarray(gj) == 25.0).any() and (np.asarray(gj) < 25.0).any()
    _close(gt, gj)
    _close(et.ncgsnth, ej.ncgsnth)
