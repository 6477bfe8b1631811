"""Parity of the port's GRMHD snapshot machinery with grtrans_tpu on the
CPU: the multi-row gather, the shared unit and electron models, the
coordinate maps, and the HARM / HARM3D / IHARM models (packed tables,
`vals`, `convert`, images, file readers).  tests/test_torch_zoo.py holds
the McKinney, KORAL and HARMPI models with the helpers defined here.

Both packages load the same numpy dump dict, made from a seed by
grtrans_tpu_torch.testing.grmhd_dump in float64 (a dump read from a float32
file is widened by both readers before any algebra, so no float32
arithmetic takes part anywhere).

Tolerances, all as max|d| <= tol * max|ref| per array:
  * quad_gather_rows_ref against Grmhd3D._gather_cols and against R calls
    of quad_gather_ref: 1e-14 (the weights multiply in another order);
  * packed tables 1e-15, except where the table holds the result of a
    numerical derivative (THICKDISK and HARMPI BL = 3: differences of
    nearly equal theta values divided by 1e-6 amplify the last-bit
    differences of XLA's and libm's sin / atan to 1e-9; stated there);
  * coordinate maps and inverses 1e-12;
  * `vals` and `convert` 1e-12 (same exception);
  * images at 8x8 pixels x 32 points through each package's un-jitted
    driver.render_rays on the port's geodesics: relative L1 <= 1e-8 on
    Stokes I; the whole IQUV image is held too except on the cold rays the
    thermal rho_V fault of grtrans_tpu touches (theta_e < 0.1), where only
    I is.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from grtrans_tpu import driver as jdriver
from grtrans_tpu.fluid import base as jbase
from grtrans_tpu.fluid import harm as jharm
from grtrans_tpu.fluid import iharm as jiharm
from grtrans_tpu.fluid.base import SourceParams as JSourceParams
from grtrans_tpu.fluid.base import load_fluid_model as jload
from grtrans_tpu.geodesics.geokerr import GeodesicBundle as JBundle
from grtrans_tpu.ops import interp as jinterp
from grtrans_tpu_torch import convert
from grtrans_tpu_torch import driver as tdriver
from grtrans_tpu_torch.fluid import base as tbase
from grtrans_tpu_torch.fluid import harm as tharm
from grtrans_tpu_torch.fluid import harm3d as tharm3d
from grtrans_tpu_torch.fluid import iharm as tiharm
from grtrans_tpu_torch.fluid.base import SourceParams
from grtrans_tpu_torch.geodesics import camera as tcam
from grtrans_tpu_torch.geodesics import geokerr as tgeo
from grtrans_tpu_torch.ops import quad_gather as qg
from grtrans_tpu_torch.testing import grmhd_dump as gd

torch.set_num_threads(1)   # the suite runs in parallel worker processes

A = gd.A
MU0 = 0.5
SP = dict(mbh=4.3e6, mdot=3e15, mu=0.25, gmin=10.0)
FLUID_FIELDS = ("rho", "p", "bmag", "u", "b", "rho2", "kela", "be", "nbins")
EMIS_FIELDS = ("ncgs", "tcgs", "bcgs", "ncgsnth", "nbins", "gammas",
               "dgammas")


def close(name, ours, ref, tol=1e-12):
    """max|ours - ref| <= tol * max|ref| over the finite entries, which
    must be the same entries."""
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(ours), fin, err_msg=name)
    scale = np.abs(ref[fin]).max()
    err = np.abs(ours[fin] - ref[fin]).max()
    assert err <= tol * scale, (name, err, scale)


_GEO = {}


def rays(nn=(8, 8, 32)):
    """The port's geodesics of the tests' camera (mu0 0.5, 24 M wide, from
    r = 25), cached: (camera, bundle)."""
    if nn not in _GEO:
        cam = tcam.make_camera(A, MU0, -12.0, 12.0, -12.0, 12.0, nn[0],
                               nn[1], device="cpu")
        geo = tgeo.trace(A, MU0, cam.alpha, cam.beta, cam.l, cam.q2, cam.sm,
                         cam.u0, nn[2], uout=0.04)
        _GEO[nn] = cam, geo
    return _GEO[nn]


def jax_bundle(geo):
    return JBundle(**{k: (None if v is None else jnp.asarray(v.numpy()))
                      for k, v in geo._asdict().items()})


def both(name, dump, **fargs):
    """(grtrans_tpu model, port model on the CPU) from one dump dict."""
    jmodel = jload(name, dump=dump, **fargs)
    tmodel = convert.grmhd_model_from_arrays(name, "cpu", dump=dump, **fargs)
    return jmodel, tmodel


def check_vals_and_convert(name, jmodel, tmodel, sps, tol=1e-12):
    """`vals` on the camera's rays, then `convert` of both packages on the
    port's sample (so that each bar is on one function's own rounding) for
    each SourceParams keyword dict in sps; returns the port's FluidVars."""
    _, geo = rays()
    ref = jmodel.vals(jnp.asarray(geo.x.numpy()), jnp.asarray(geo.k.numpy()),
                      A)
    ours = tmodel.vals(geo.x, geo.k, A)
    for f in FLUID_FIELDS:
        r = getattr(ref, f)
        assert (r is None) == (getattr(ours, f) is None), (name, f)
        if r is not None:
            close(f"{name}.{f}", getattr(ours, f), r, tol)
    assert (ours.rho.numpy() > 0).any()
    same = ref._replace(**{f: jnp.asarray(getattr(ours, f).numpy())
                           for f in FLUID_FIELDS
                           if getattr(ours, f) is not None})
    if hasattr(jmodel, "_kel"):
        jmodel._kel = {k: jnp.asarray(v.numpy())
                       for k, v in (ours.extra or {}).items()}
    for kw in sps:
        eref = jmodel.convert(same, JSourceParams(**kw))
        eours = tmodel.convert(ours, SourceParams(**kw))
        for f in EMIS_FIELDS:
            r = getattr(eref, f)
            assert (r is None) == (getattr(eours, f) is None), (name, f)
            if r is not None:
                close(f"{name}.convert({kw['gmin']}).{f}", getattr(eours, f),
                      r, tol)
    return ours


def check_image(name, jmodel, tmodel, sp_kw, ename="POLSYNCHTH", tol=1e-8):
    """8x8 x 32 image through both un-jitted render_rays."""
    cam, geo = rays()
    jg = jax_bundle(geo)
    jfv = jmodel.vals(jg.x, jg.k, A)
    jsp = JSourceParams(**sp_kw)
    ref = np.asarray(jdriver.render_rays(
        jg, jfv, jmodel.convert(jfv, jsp), ename, [2.3e11], MU0,
        jnp.asarray(cam.alpha.numpy()), jnp.asarray(cam.beta.numpy()), A,
        sp_kw["mbh"], jsp, iname="formal", nvals=4))
    tfv = tmodel.vals(geo.x, geo.k, A)
    tsp = SourceParams(**sp_kw)
    tei = tmodel.convert(tfv, tsp)
    ours = tdriver.render_rays(geo, tfv, tei, ename, [2.3e11], MU0,
                               cam.alpha, cam.beta, A, sp_kw["mbh"], tsp,
                               iname="formal", nvals=4).numpy()
    assert ours.shape == ref.shape == (1, 64, 4)
    assert np.isfinite(ours).all() and ours[0, :, 0].max() > 0
    rel_i = np.abs(ours[..., 0] - ref[..., 0]).sum() / np.abs(ref[..., 0]).sum()
    assert rel_i <= tol, (name, rel_i)
    # rays that never cross gas with 1e-2 < theta_e < 0.1 are free of
    # grtrans_tpu's rho_V noise: hold all of IQUV there
    thetae = (tei.tcgs * 1.38e-16 / (9.10938188e-28 * 2.99792458e10 ** 2))
    cold = ((thetae > 1e-2) & (thetae < 0.1) & (tei.ncgs > 0)).any(-1).numpy()
    if (~cold).any() and np.abs(ref[0, ~cold]).sum() > 0:
        rel = np.abs(ours[0, ~cold] - ref[0, ~cold]).sum() \
            / np.abs(ref[0, ~cold]).sum()
        assert rel <= tol, (name, rel, int(cold.sum()))
    return rel_i


# ---------------------------------------------------------------------------
# the multi-row gather
# ---------------------------------------------------------------------------

def _rows_inputs(n, r, nc, nf, ns, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((ns, nc * nf))),
            torch.from_numpy(rng.integers(0, ns, (n, r)).astype(np.int32)),
            torch.from_numpy(rng.uniform(0.0, 1.0, (n, r, nc))))


@pytest.mark.parametrize("r,nc,nf", [(4, 2, 10), (8, 2, 11), (8, 1, 6),
                                     (1, 1, 14), (3, 2, 5)])
def test_quad_gather_rows_is_r_quad_gathers(r, nc, nf):
    table, idx, w = _rows_inputs(513, r, nc, nf, 300)
    out = qg.quad_gather_rows(table, idx, w, nc, nf)
    ref = sum(qg.quad_gather_ref(table, idx[:, i].contiguous(),
                                 w[:, i].contiguous(), nc, nf)
              for i in range(r))
    close("rows", out, ref.numpy(), 1e-14)
    assert torch.equal(out, qg.quad_gather_rows_ref(table, idx, w, nc, nf))


@pytest.mark.parametrize("slices", [1, 3], ids=["fast", "slowlight"])
def test_quad_gather_rows_matches_jax_gather_cols(slices):
    """The port's one launch (time blend folded into the weights) against
    Grmhd3D._gather_cols on the same packed table and query geometry."""
    dump = gd.harm3d_dump(12, 10, 8)
    jmodel, tmodel = both("HARM3D", dump)
    base_j = {k: jmodel.f[k][0] for k in jmodel.f}
    base_t = {k: tmodel.f[k][0] for k in tmodel.f}
    for s in range(1, slices):
        jmodel.append_slice({k: v * (1.0 + 0.5 * s) for k, v in base_j.items()})
        tmodel.append_slice({k: v * (1.0 + 0.5 * s) for k, v in base_t.items()})
    jmodel.tstep = tmodel.tstep = 20.0
    jmodel.toffset = tmodel.toffset = -40.0
    _, geo = rays()
    jq = jmodel._query(jnp.asarray(geo.x.numpy()), A, time=0.0)
    tq = tmodel._query(geo.x, A, time=0.0)
    for k in ("lx1", "lx2", "lx3"):
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
    jG, names = jmodel._stacked_fields(jnp.float64)
    tG, tnames = tmodel._stacked_fields()
    assert names == tnames
    close("table", tG, np.asarray(jG).reshape(-1, jG.shape[-1]), 1e-15)
    NS = jG.shape[1]
    ref = jmodel._gather_cols(jG.reshape(-1, jG.shape[-1]), NS, 10, 8, jq, 10)
    ours = tmodel._gather_cols(tG, NS, 10, 8, tq, 10)
    close("gather_cols", ours, ref, 1e-14)
    if slices > 1:
        assert (tq["ttd"].numpy() > 0).any() and tq["tind"].max() >= 1


def test_quad_gather_rows_rejects_bad_arguments():
    table, idx, w = _rows_inputs(8, 4, 2, 10, 30)
    with pytest.raises(TypeError):
        qg.quad_gather_rows(table, idx.long(), w, 2, 10)
    with pytest.raises(TypeError):
        qg.quad_gather_rows(table, idx[:, 0].contiguous(), w, 2, 10)
    with pytest.raises(ValueError):
        qg.quad_gather_rows(table, idx, w[:, :3].contiguous(), 2, 10)
    with pytest.raises(ValueError):
        qg.quad_gather_rows(table, idx, w.float(), 2, 10)
    with pytest.raises(ValueError):
        qg.quad_gather_rows(table, idx, w, 4, 10)
    with pytest.raises(NotImplementedError):
        qg.quad_gather_rows(table.to("meta"), idx.to("meta"), w.to("meta"),
                            2, 10)


def test_pack_corners_2d_and_bilinear_match_jax():
    rng = np.random.default_rng(1)
    grid = rng.standard_normal((9, 7, 3))
    order = ("a", "b", "c")
    ref = jinterp.pack_corners_2d({k: grid[..., i]
                                   for i, k in enumerate(order)}, order)
    table = qg.pack_corners_2d(grid)
    np.testing.assert_array_equal(table, np.asarray(ref))
    i1 = rng.integers(0, 8, (5, 6)).astype(np.int32)
    i2 = rng.integers(0, 6, (5, 6)).astype(np.int32)
    w1, w2 = rng.uniform(0, 1, (2, 5, 6))
    out = qg.bilinear_packed(torch.from_numpy(table), 7, 3,
                             torch.from_numpy(i1), torch.from_numpy(i2),
                             torch.from_numpy(w1), torch.from_numpy(w2))
    close("bilinear", out, jinterp.bilinear_packed(
        ref, 7, 3, jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(w1),
        jnp.asarray(w2)), 1e-14)


# ---------------------------------------------------------------------------
# units, electron models, coordinate maps
# ---------------------------------------------------------------------------

def _plasma(seed=2, n=400):
    rng = np.random.default_rng(seed)
    rho = 10.0 ** rng.uniform(-6, 1, n)
    rho[:5] = 0.0
    return rho, rho * 10.0 ** rng.uniform(-3, 0, n), \
        10.0 ** rng.uniform(-4, 0, n) * (rng.uniform(0, 1, n) > 0.05)


@pytest.mark.parametrize("fn", ["scale_sim_units", "charles_e", "ressler_e",
                                "werner_e", "nonthermale_b2"])
def test_units_and_electron_models_match_jax(fn):
    rho, p, b = _plasma()
    args = {"scale_sim_units": (4.3e6, 3e15, 0.003, rho, p, b),
            "charles_e": (rho, p * 1e11, p * 2e11, b, 1.0, 20.0),
            "ressler_e": (rho, p), "werner_e": (rho, b),
            "nonthermale_b2": (0.02, 10.0, 3.5, b * b / np.maximum(rho, 1e-37),
                               b * 50.0)}[fn]
    ref = getattr(jbase, fn)(*(jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v for v in args))
    ours = getattr(tbase, fn)(*(torch.from_numpy(v)
                                if isinstance(v, np.ndarray) else v
                                for v in args))
    if fn == "scale_sim_units":
        for name, o, r in zip(("ncgs", "bcgs", "tempcgs", "rhocgs"), ours,
                              ref):
            close(name, o, r)
    else:
        close(fn, ours, ref)


@pytest.mark.parametrize("h", [0.3, 1.0])
def test_mksh_theta_map_and_inverse_match_jax(h):
    th = np.linspace(1e-3, np.pi - 1e-3, 301)
    x2 = tharm.x2_of_theta(torch.from_numpy(th), h)
    close("x2_of_theta", x2, jharm.x2_of_theta(jnp.asarray(th), h))
    close("roundtrip", tharm.theta_of_x2(x2.numpy(), h), th)
    np.testing.assert_array_equal(tharm.theta_of_x2(x2.numpy(), h),
                                  jharm.theta_of_x2(x2.numpy(), h))
    rng = np.random.default_rng(3)
    um, r = rng.standard_normal((301, 4)), rng.uniform(1.5, 40, 301)
    close("umks2uks_bl", tharm.umks2uks_bl(
        torch.from_numpy(um), torch.from_numpy(r), x2, h, A),
        jharm.umks2uks_bl(jnp.asarray(um), jnp.asarray(r),
                          jnp.asarray(x2.numpy()), h, A))


def test_mmks_theta_map_derivatives_and_inverse_match_jax():
    mm = (0.3, 0.5, 0.82, 14.0, 0.2)
    rng = np.random.default_rng(4)
    x2 = rng.uniform(0.01, 0.99, 300)
    x1 = rng.uniform(0.2, 4.0, 300)
    np.testing.assert_array_equal(tiharm.calcth_mmks(x2, x1, *mm),
                                  jiharm.calcth_mmks(x2, x1, *mm))
    th = tiharm.calcth_mmks(torch.from_numpy(x2), torch.from_numpy(x1), *mm)
    close("calcth_mmks", th, jiharm.calcth_mmks(jnp.asarray(x2),
                                                jnp.asarray(x1), *mm))
    for o, r in zip(tiharm._mmks_derivs(torch.from_numpy(x2),
                                        torch.from_numpy(x1), *mm),
                    jiharm._mmks_derivs(x2, x1, *mm)):
        close("mmks_derivs", o, r)
    jmodel, tmodel = both("IHARM", gd.iharm_dump(12, 10, 8, metric=1))
    r = torch.from_numpy(np.exp(x1))
    ours = tmodel.x123_of_blks(r, th, th)[1]
    ref = jmodel.x123_of_blks(jnp.asarray(r.numpy()), jnp.asarray(th.numpy()),
                              jnp.asarray(th.numpy()))[1]
    close("x2 of theta (mmks)", ours, ref)


# ---------------------------------------------------------------------------
# HARM, HARM3D, IHARM
# ---------------------------------------------------------------------------

FAMILY = {
    "HARM": lambda: ("HARM", gd.harm_dump(32, 24, seed=1)),
    "HARM3D": lambda: ("HARM3D", gd.harm3d_dump(32, 24, 16, seed=2)),
    "IHARM_mks": lambda: ("IHARM", gd.iharm_dump(32, 24, 16, 0, seed=3)),
    "IHARM_mmks": lambda: ("IHARM", gd.iharm_dump(32, 24, 16, 1, seed=4)),
}
# every electron model a convert has
GMINS = {"HARM": (10.0,), "HARM3D": (10.0,), "IHARM": (10.0, -1.0, 0.5)}


@pytest.mark.parametrize("case", sorted(FAMILY))
def test_harm_family_tables_match_jax(case):
    name, dump = FAMILY[case]()
    jmodel, tmodel = both(name, dump)
    for k in ("uniqx1", "uniqx2", "uniqr", "uniqth"):
        close(f"{case}.{k}", getattr(tmodel, k), getattr(jmodel, k), 1e-15)
    if name == "HARM":
        close(f"{case}.fquad", tmodel.fquad, jmodel.fquad, 1e-15)
        return
    jG, names = jmodel._stacked_fields(jnp.float64)
    tG, tnames = tmodel._stacked_fields()
    assert names == tnames and len(names) == (11 if name == "IHARM" else 10)
    assert tG.dtype == torch.float64 and tG.shape == (32 * 24 * 16,
                                                      2 * len(names))
    close(f"{case}.table", tG, np.asarray(jG)[0], 1e-15)


@pytest.mark.parametrize("case", sorted(FAMILY))
def test_harm_family_vals_and_convert_match_jax(case):
    name, dump = FAMILY[case]()
    jmodel, tmodel = both(name, dump)
    ours = check_vals_and_convert(
        case, jmodel, tmodel, [dict(SP, gmin=g) for g in GMINS[name]])
    if name == "IHARM":
        assert ours.kela is not None and ours.extra is None


@pytest.mark.parametrize("case", sorted(FAMILY))
def test_harm_family_image_matches_jax(case):
    name, dump = FAMILY[case]()
    jmodel, tmodel = both(name, dump)
    sp = dict(SP, mdot=3e15 if name != "IHARM" else 1e19)
    check_image(case, jmodel, tmodel, sp)


def test_grmhd3d_extra_fields_travel_with_the_sample():
    """A snapshot's extra columns come back in FluidVars.extra, so two
    cameras sampled in turn cannot read each other's."""
    _, tmodel = both("IHARM", gd.iharm_dump(12, 10, 8))
    tmodel.extra3["heat"] = 2.0 * tmodel.extra3["kela"]
    tmodel._fstack_key = None
    _, geo = rays()
    one = tmodel.vals(geo.x[:8], geo.k[:8], A)
    two = tmodel.vals(geo.x[8:16], geo.k[8:16], A)
    assert set(one.extra) == {"heat"}
    assert torch.equal(one.extra["heat"], 2.0 * one.kela)
    assert torch.equal(two.extra["heat"], 2.0 * two.kela)
    assert not hasattr(tmodel, "_last_extra")


@pytest.mark.parametrize("name", ["HARM", "HARM3D", "IHARM"])
def test_harm_family_readers_match_jax(name, tmp_path):
    """A file in the code's native layout, read by both packages: equal
    arrays, and a model loaded by name from the file samples as the JAX
    model loaded from it."""
    dfile = str(tmp_path / "dump")
    if name == "HARM":
        gd.write_harm(gd.harm_dump(12, 10), dfile)
        ours, ref = tharm.read_harm_dump(dfile), jharm.read_harm_dump(dfile)
    elif name == "HARM3D":
        from grtrans_tpu.fluid import harm3d as jharm3d
        gd.write_harm3d(gd.harm3d_dump(12, 10, 8), dfile)
        ours = tharm3d.read_harm3d(dfile)
        hd = jharm3d.read_harm3d_header(dfile + ".head")
        assert hd == tharm3d.read_harm3d_header(dfile + ".head")
        ref = jharm3d.read_harm3d_dump(dfile, 12, 10, 8)
    else:
        gd.write_iharm(gd.iharm_dump(12, 10, 8, metric=1), dfile)
        ours = tiharm.read_iharm(dfile)
        ref = jiharm.Iharm(dfile=dfile)._read()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k
    jmodel = jload(name, dfile=dfile)
    tmodel = tbase.load_fluid_model(name, device="cpu", dfile=dfile)
    check_vals_and_convert(name, jmodel, tmodel, [SP])
