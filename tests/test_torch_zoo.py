"""Parity of the port's McKinney (THICKDISK, MB09), KORAL (2-D, 3-D and
the DISK / TOPJET / BOTJET regions, with and without nonthermal bins) and
HARMPI (BL = 1, BL = 3, cylindrified) snapshot models with grtrans_tpu on
the CPU.  Helpers and the general bars are in tests/test_torch_grmhd.py.

Loosened bars, and why.  THICKDISK and HARMPI BL = 3 carry their
four-vectors to BL with central-difference theta derivatives (steps of
1e-6 in x2, 1e-4 in x1 or r): the difference of two nearly equal theta
values, each off by an ulp between XLA's and libm's sin / atan / pow,
divided by the step, is a relative 1e-10 .. 1e-9 in the derivative and so
in u^theta, b^theta.  Their tables, `vals` and images are held to 1e-8,
1e-8 and 1e-7 (measured worst 2e-10, 2e-10 and 1e-9); every other model
keeps 1e-15 / 1e-12 / 1e-8.  The root finders (60 bisections) are held to
1e-12 like the closed-form maps.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from grtrans_tpu.fluid import harmpi as jharmpi
from grtrans_tpu.fluid import koral as jkoral
from grtrans_tpu.fluid import mb09 as jmb09
from grtrans_tpu.fluid import thickdisk as jthick
from grtrans_tpu.fluid.base import load_fluid_model as jload
from grtrans_tpu_torch.fluid import harmpi as tharmpi
from grtrans_tpu_torch.fluid import koral as tkoral
from grtrans_tpu_torch.fluid import mb09 as tmb09
from grtrans_tpu_torch.fluid import thickdisk as tthick
from grtrans_tpu_torch.fluid.base import load_fluid_model as tload
from grtrans_tpu_torch.testing import grmhd_dump as gd

from test_torch_grmhd import (A, SP, both, check_image,
                              check_vals_and_convert, close, rays)

torch.set_num_threads(1)   # the suite runs in parallel worker processes

BINS = dict(nrelbin=3, relgammamin=10.0, relgammamax=1e4)
KSP = dict(mbh=4.3e6, nfac=1e8, mu=0.25, gmin=10.0)

# name -> (model name, dump, fargs, SourceParams base, gmins, table bar,
#          vals bar, image bar)
ZOO = {
    "THICKDISK": lambda: ("THICKDISK", gd.thickdisk_dump(32, 24, 16, seed=5),
                          {}, SP, (10.0,), 1e-8, 1e-8, 1e-7),
    "THICKDISK_nojonfix": lambda: (
        "THICKDISK", gd.thickdisk_dump(32, 24, 16, seed=5), dict(jonfix=0),
        SP, (10.0,), 1e-8, 1e-8, 1e-7),
    "MB09": lambda: ("MB09", gd.mb09_dump(32, 24, 16, seed=6), {}, SP,
                     (10.0,), 1e-15, 1e-12, 1e-8),
    "KORAL": lambda: ("KORAL", gd.koral_dump(48, 24, seed=7), {}, KSP,
                      (10.0, 0.5), 1e-15, 1e-12, 1e-8),
    "KORALNTH": lambda: ("KORALNTH", gd.koral_dump(48, 24, nrelbin=3, seed=7),
                         BINS, KSP, (10.0, 0.5), 1e-15, 1e-12, 1e-8),
    "KORAL3D": lambda: ("KORAL3D", gd.koral_dump(48, 24, 12, seed=8), {}, KSP,
                        (10.0, 0.5), 1e-15, 1e-12, 1e-8),
    "KORAL3D_bins": lambda: ("KORAL3D",
                             gd.koral_dump(48, 24, 12, nrelbin=3, seed=8),
                             BINS, KSP, (10.0,), 1e-15, 1e-12, 1e-8),
    "KORAL3D_DISK": lambda: ("KORAL3D_DISK", gd.koral_dump(48, 24, 12, seed=8),
                             {}, KSP, (10.0,), 1e-15, 1e-12, 1e-8),
    "KORAL3D_TOPJET": lambda: ("KORAL3D_TOPJET",
                               gd.koral_dump(48, 24, 12, seed=8), {}, KSP,
                               (10.0,), 1e-15, 1e-12, 1e-8),
    "KORAL3D_BOTJET": lambda: ("KORAL3D_BOTJET",
                               gd.koral_dump(48, 24, 12, seed=8), {}, KSP,
                               (10.0,), 1e-15, 1e-12, 1e-8),
    "HARMPI_bl1": lambda: ("HARMPI", gd.harmpi_dump(32, 24, 12, bl=1, seed=9),
                           {}, SP, (10.0, 0.5, -1.0, -2.0, -3.0, -4.0),
                           1e-15, 1e-12, 1e-8),
    "HARMPI_bl3": lambda: ("HARMPI", gd.harmpi_dump(32, 24, 12, bl=3, seed=9),
                           {}, SP, (10.0, -2.0), 1e-8, 1e-8, 1e-7),
}
TABLES = {"THICKDISK": "fpair", "MB09": "fpair", "KORAL": "fquad",
          "KORALNTH": "fquad", "KORAL3D": "fpair", "HARMPI": "fstack"}


def _models(case):
    name, dump, fargs, sp, gmins, *bars = ZOO[case]()
    return (name, *both(name, dump, **fargs), sp, gmins, *bars)


@pytest.mark.parametrize("case", sorted(ZOO))
def test_zoo_tables_match_jax(case):
    name, jmodel, tmodel, _, _, bar, _, _ = _models(case)
    for k in ("uniqx1", "uniqx2", "uniqr"):
        close(f"{case}.{k}", getattr(tmodel, k), getattr(jmodel, k), 1e-15)
    attr = TABLES[name.split("_")[0]]
    table = getattr(tmodel, attr)
    assert table.dtype == torch.float64 and table.is_contiguous()
    close(f"{case}.{attr}", table, getattr(jmodel, attr), bar)
    if jmodel.__dict__.get("fn") is not None:
        close(f"{case}.fn", tmodel.fn,
              np.asarray(jmodel.fn).reshape(-1, jmodel.nrelbin), 1e-15)
        close("gammas", tmodel.gammas, jmodel.gammas, 1e-15)
        close("dgammas", tmodel.dgammas, jmodel.dgammas, 1e-15)


@pytest.mark.parametrize("case", sorted(ZOO))
def test_zoo_vals_and_convert_match_jax(case):
    name, jmodel, tmodel, sp, gmins, _, bar, _ = _models(case)
    ours = check_vals_and_convert(case, jmodel, tmodel,
                                  [dict(sp, gmin=g) for g in gmins], bar)
    if case.startswith("HARMPI"):
        # the entropies convert reads travel with the sample
        assert set(ours.extra) == set(tharmpi.KEL)
        assert not hasattr(tmodel, "_kel")
    if case.endswith("JET"):
        full = tload("KORAL3D", device="cpu", dump=ZOO[case]()[1])
        _, geo = rays()
        assert not torch.equal(full.vals(geo.x, geo.k, A).rho, ours.rho)


@pytest.mark.parametrize("case", sorted(ZOO))
def test_zoo_image_matches_jax(case):
    name, jmodel, tmodel, sp, _, _, _, bar = _models(case)
    if case.startswith("HARMPI"):
        sp = dict(sp, mdot=1e19)
    ename = "SYNCHBIN" if jmodel.__dict__.get("fn") is not None \
        else "POLSYNCHTH"
    check_image(case, jmodel, tmodel, sp, ename, bar)


def test_harmpi_without_entropies_refuses_gmin_below_zero():
    dump = gd.harmpi_dump(12, 10, 8, bl=1)
    for k in tharmpi.KEL:
        del dump[k]
    tmodel = tload("HARMPI", device="cpu", dump=dump)
    _, geo = rays()
    fv = tmodel.vals(geo.x, geo.k, A)
    assert fv.extra is None and fv.kela is None
    from grtrans_tpu_torch.fluid.base import SourceParams
    with pytest.raises(ValueError, match="entropy"):
        tmodel.convert(fv, SourceParams(**dict(SP, gmin=-1.0)))
    assert torch.isfinite(tmodel.convert(fv, SourceParams(**SP)).tcgs).all()


# ---------------------------------------------------------------------------
# coordinate maps
# ---------------------------------------------------------------------------

def _rth(n=257, seed=10):
    rng = np.random.default_rng(seed)
    return (np.exp(rng.uniform(np.log(1.3), np.log(300.0), n)),
            rng.uniform(0.02, np.pi - 0.02, n))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("thname,jfn,tfn", [
    ("calcthmks6", jthick.calcthmks6, tthick.calcthmks6),
    ("calcthmks9", jmb09.calcthmks9, tmb09.calcthmks9)])
def test_mckinney_maps_and_inverses_match_jax(thname, jfn, tfn):
    r, th = _rth()
    x2 = np.random.default_rng(11).uniform(0.0, 1.0, r.shape)
    close(thname, tfn(_t(x2), _t(r)), jfn(jnp.asarray(x2), jnp.asarray(r)))
    close("x2_of_th", tthick.x2_of_th(_t(th), _t(r), tfn),
          jthick.x2_of_th(jnp.asarray(th), jnp.asarray(r), jfn))
    for xbr in (np.log(500.0), 25.0):
        x1 = np.linspace(0.1, 7.0, 97)
        close("calcrmks", tthick.calcrmks(_t(x1), xbr),
              jthick.calcrmks(jnp.asarray(x1), xbr))
        close("x1_of_r", tthick.x1_of_r(_t(r), xbr),
              jthick.x1_of_r(jnp.asarray(r), xbr))
    back = tfn(tthick.x2_of_th(_t(th), _t(r), tfn), _t(r))
    close("roundtrip", back, th)
    um = np.random.default_rng(12).standard_normal(r.shape + (4,))
    x1 = np.log(r)
    close("umks2ubl", tthick.umks2ubl(_t(um), _t(x1), _t(x2), 25.0, A, tfn),
          jthick.umks2ubl(jnp.asarray(um), jnp.asarray(x1), jnp.asarray(x2),
                          25.0, A, jfn), 1e-8)


def test_koral_mks3_maps_and_bins_match_jax():
    r, th = _rth()
    m = (0.6, 0.005, 0.01, 1.5)
    x2 = tkoral.x2_mks3(_t(th), _t(r), *m)
    close("x2_mks3", x2, jkoral.x2_mks3(jnp.asarray(th), jnp.asarray(r), *m))
    close("theta_mks3", tkoral.theta_mks3(x2, _t(r), *m),
          jkoral.theta_mks3(jnp.asarray(x2.numpy()), jnp.asarray(r), *m))
    close("roundtrip", tkoral.theta_mks3(x2, _t(r), *m), th, 1e-10)
    for o, ref in zip(tkoral.relel_bins(10.0, 1e4, 7),
                      jkoral.relel_bins(10.0, 1e4, 7)):
        np.testing.assert_array_equal(o, np.asarray(ref))


def _p3(cls):
    rin = 0.87 * (1 + np.sqrt(1 - A * A))
    return cls(R0=0.0, rbr=100.0, npow2=4.0, cpow2=1.0, startx1=np.log(rin),
               r0grid=rin, r0jet=2 * rin, r0disk=2 * rin, rdiskend=5 * rin,
               rjetend=1e3)


@pytest.mark.parametrize("fn", ["calcrmks", "drdx1_mks", "x1_of_r",
                                "calcthmksbl3", "x2_of_th_bl3",
                                "calcth_cylindrified", "theta_mksh",
                                "x2_of_th_mksh", "ftr", "fangle"])
def test_harmpi_maps_and_inverses_match_jax(fn):
    jp, tp = _p3(jharmpi.BL3Params), _p3(tharmpi.BL3Params)
    r, th = _rth()
    x1 = np.linspace(np.log(1.4), 5.2, r.shape[0])     # spans rbr = 100
    x2 = np.random.default_rng(13).uniform(-0.99, 0.99, r.shape)
    args = {"calcrmks": (x1,), "drdx1_mks": (x1,), "x1_of_r": (r,),
            "calcthmksbl3": (x2, r), "x2_of_th_bl3": (th, r),
            "calcth_cylindrified": (x2, r), "theta_mksh": (x2,),
            "x2_of_th_mksh": (th,), "ftr": (x2 * 1.3,),
            "fangle": (x2 * 1.3,)}[fn]
    tail = {"theta_mksh": (0.3,), "x2_of_th_mksh": (0.3,), "ftr": (),
            "fangle": ()}
    ref = getattr(jharmpi, fn)(*map(jnp.asarray, args), *tail.get(fn, (jp,)))
    ours = getattr(tharmpi, fn)(*map(_t, args), *tail.get(fn, (tp,)))
    close(fn, ours, ref)


@pytest.mark.parametrize("kind", ["public", "private"])
def test_harmpi_header_parses_as_jax(kind):
    line = gd.harmpi_header(32, 24, 12, 3)
    if kind == "public":
        line = " ".join(line.split()[:37]
                        + ["8", "0", "1.0", "1.0", "100.0", "4.0", "1.0",
                           "3.0", "0.0"])
    ref, ours = (m.parse_harmpi_header(line) for m in (jharmpi, tharmpi))
    assert ours == ref
    assert vars(tharmpi.bl3_params_from_header(dict(ours))) == \
        vars(jharmpi.bl3_params_from_header(dict(ref)))


# ---------------------------------------------------------------------------
# file readers
# ---------------------------------------------------------------------------

def _same(ours, ref):
    for k, v in ref.items():
        if isinstance(v, dict):
            _same(ours[k], v)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


@pytest.mark.parametrize("name", ["THICKDISK", "MB09", "KORAL", "KORAL3D",
                                  "HARMPI"])
def test_zoo_readers_match_jax(name, tmp_path):
    """A file in the code's native layout, read by both packages, and a
    model loaded by name from it."""
    dfile, fargs = str(tmp_path / "dump"), {}
    sp, bar = SP, 1e-12
    if name == "THICKDISK":
        gd.write_thickdisk(gd.thickdisk_dump(12, 10, 8), dfile)
        _same(tthick.read_thickdisk_fieldline(dfile),
              jthick.read_thickdisk_fieldline(dfile))
        bar = 1e-8
    elif name == "MB09":
        gfile = str(tmp_path / "grid")
        gd.write_mb09(gd.mb09_dump(12, 10, 8), gfile, dfile)
        _same(tmb09.read_mb09_grid(gfile), jmb09.read_mb09_grid(gfile))
        _same(tmb09.read_mb09_data(dfile, 960),
              jmb09.read_mb09_data(dfile, 960))
        fargs = dict(gfile=gfile, asim_in=A)
    elif name.startswith("KORAL"):
        nx3 = 8 if name == "KORAL3D" else 1
        gd.write_koral(gd.koral_dump(24, 12, nx3, nrelbin=3), dfile, 3)
        kw = dict(ndim=3 if nx3 > 1 else 2, nrelbin=3)
        _same(tkoral.read_koral_dump(dfile, **kw),
              jkoral.read_koral_dump(dfile, **kw))
        fargs, sp = BINS, KSP
    else:
        gd.write_harmpi(gd.harmpi_dump(12, 10, 8, bl=1), dfile)
        _same(tharmpi.read_harmpi_dump(dfile),
              jharmpi.read_harmpi_dump(dfile))
    jmodel = jload(name, dfile=dfile, **fargs)
    tmodel = tload(name, device="cpu", dfile=dfile, **fargs)
    check_vals_and_convert(name, jmodel, tmodel, [sp], bar)
