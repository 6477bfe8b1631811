"""Parity of the port's thin-disk models (THINDISK, PHATDISK, NUMDISK) and
of thin-disk imaging (standard=2: one point a ray, at the equatorial
crossing) with grtrans_tpu, on the CPU.

Tolerances.  `vals` and `convert` on a seeded bundle of disk-plane points:
max|d| <= 1e-12 * max|ref| per field.  PHATDISK's table is built on the
host by each package from its own thin disk: 1e-12 of each table's largest
entry.  Whole images through both `grtrans_run`s, the problems of
tests/test_e2e.py: relative L1 over all Stokes components and cameras
<= 1e-8 (measured: THINDISK + BBPOL 3.7e-11, THINDISK + BB 8.4e-13,
PHATDISK + INTERP 1.6e-12, NUMDISK + BB 3.0e-11; the equatorial crossing
is one Weierstrass inversion a ray, so nothing accumulates)."""

import dataclasses
import struct

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from grtrans_tpu.api import Grtrans as JGrtrans
from grtrans_tpu.config import GrtransConfig as JGrtransConfig
from grtrans_tpu.fluid import analytic as jan
from grtrans_tpu.fluid import disks as jdisks
from grtrans_tpu.fluid.base import SourceParams as JSourceParams
from grtrans_tpu.geometry import kerr as jkerr
from grtrans_tpu.orchestrator import grtrans_run as jgrtrans_run
from grtrans_tpu_torch import convert
from grtrans_tpu_torch.api import Grtrans
from grtrans_tpu_torch.fluid import disks as tdisks
from grtrans_tpu_torch.fluid.base import SourceParams, load_fluid_model
from grtrans_tpu_torch.orchestrator import grtrans_run

torch.set_num_threads(1)   # the suite runs in parallel worker processes

A = 0.9
NPIX, NPTS = 32, 6
PHAT = dict(a=A, mbh=10.0, mdot=0.1, nw=80, nr=150, nfreq_tab=30, fmin=3e16,
            fmax=3e18)


def _disk_points(seed=0):
    """(npix, npts, 4) points near the equatorial plane from inside the
    ISCO to r = 60, with photon wavevectors."""
    rng = np.random.default_rng(seed)
    r = 10.0 ** rng.uniform(np.log10(1.6), np.log10(60.0), (NPIX, NPTS))
    th = np.pi / 2 + rng.uniform(-0.2, 0.2, (NPIX, NPTS))
    th[:, 0] = np.pi / 2
    x = np.stack([rng.uniform(-50, 0, r.shape), r, th,
                  rng.uniform(-9, 9, r.shape)], axis=-1)
    k = np.array(jkerr.calc_nullp(
        rng.uniform(0, 40, r.shape), rng.uniform(-5, 5, r.shape), A, r,
        np.cos(th), rng.choice([-1.0, 1.0], r.shape),
        rng.choice([-1.0, 1.0], r.shape)))
    return x, k


def _numdisk_table(seed=1, nr=24, nphi=16):
    """A seeded T_eff(r, phi) image on a log-r x phi grid, r fastest."""
    rng = np.random.default_rng(seed)
    r = np.logspace(np.log10(2.0), np.log10(40.0), nr)
    phi = np.linspace(0.0, 2 * np.pi, nphi)
    T = 1e7 * (r[None, :] / 6.0) ** -0.75 \
        * (1.0 + 0.3 * rng.uniform(-1, 1, (nphi, nr)))
    return dict(nr=nr, nphi=nphi, r=np.tile(r, nphi),
                phi=np.repeat(phi, nr), T=T.reshape(-1))


def _close(name, ours, ref, rtol=1e-12):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(ours), fin, err_msg=name)
    assert fin.mean() > 0.5, name
    scale = np.abs(ref[fin]).max()
    assert np.abs(ours[fin] - ref[fin]).max() <= rtol * scale, name


def _models(name):
    if name == "THINDISK":
        jm = jan.ThinDisk(a=A, mbh=10.0, mdot=0.1, rout=50.0)
        return jm, convert.analytic_from_fields(
            name, dataclasses.asdict(jm), "cpu")
    if name == "PHATDISK":
        jm = jdisks.PhatDisk(**PHAT)
        return jm, convert.table_model_from_arrays(
            name, "cpu", **{k: np.asarray(getattr(jm, k)) for k in (
                "freq_tab", "r_tab", "om_tab", "fnu_tab")})
    table = _numdisk_table()
    return (jdisks.NumDisk(table=dict(table)),
            convert.table_model_from_arrays(name, "cpu", table=table))


@pytest.mark.parametrize("name", ["THINDISK", "PHATDISK", "NUMDISK"])
def test_vals_and_convert_match_jax(name):
    jmodel, tmodel = _models(name)
    x, k = _disk_points()
    ref = jmodel.vals(jnp.asarray(x), jnp.asarray(k), A)
    ours = tmodel.vals(torch.from_numpy(x), torch.from_numpy(k), A)
    fields = ["rho", "p", "bmag", "u", "b", "rho2"] \
        + ["fnu"] * (name == "PHATDISK")
    for field in fields:
        _close(f"{name}.{field}", getattr(ours, field), getattr(ref, field))
    assert ours.nbins is None and (ours.fnu is None) == (name != "PHATDISK")
    eref = jmodel.convert(ref, JSourceParams())
    eours = tmodel.convert(ours, SourceParams())
    for field in ("ncgs", "tcgs", "bcgs", "ncgsnth"):
        _close(f"{name}.{field}", getattr(eours, field),
               getattr(eref, field))
    if name == "PHATDISK":
        assert eours.fnu.shape == (NPIX, NPTS, PHAT["nfreq_tab"])
        _close("freq_tab", eours.freq_tab, eref.freq_tab)
    if name == "THINDISK":                   # both sides of rin and rout
        T = ours.rho.numpy()
        cold = T == T.min()
        assert cold.any() and not cold.all()
        assert (cold == ((x[..., 1] <= float(jkerr.calc_rms(A)))
                         | (x[..., 1] >= 50.0))).all()


def test_phatdisk_builds_the_same_table_as_jax():
    jm = jdisks.PhatDisk(**PHAT)
    tables = tdisks.phatdisk_tables(**PHAT)
    for key, arr in tables.items():
        assert arr.dtype == np.float64
        _close(key, arr, getattr(jm, key))
    tm = load_fluid_model("PHATDISK", device="cpu", **PHAT)
    # row ix of the packed table: [Omega, F_nu] at radii ix and ix + 1
    nf = 1 + PHAT["nfreq_tab"]
    assert tm.packed.shape == (PHAT["nr"], 2 * nf) and tm.nf == nf
    np.testing.assert_array_equal(tm.packed[:-1, nf].numpy(),
                                  tables["om_tab"][1:])
    np.testing.assert_array_equal(tm.packed[:, 1:nf].numpy(),
                                  tables["fnu_tab"])


def test_numdisk_reads_its_file(tmp_path):
    """The reference's layout: records nr, nphi, then r, phi, T as float32
    (fluid_model_numdisk.f90:190-212), with the tscl and rscl scalings."""
    table = _numdisk_table()
    path = tmp_path / "numdisk.bin"
    with open(path, "wb") as f:
        for payload in (
                struct.pack("<i", table["nr"]), struct.pack("<i", table["nphi"]),
                np.concatenate([table["r"], table["phi"], table["T"] / 1e7]
                               ).astype(np.float32).tobytes()):
            f.write(struct.pack("<i", len(payload)) + payload
                    + struct.pack("<i", len(payload)))
    got = tdisks.read_numdisk_file(path, tscl=1e7, rscl=2.0)
    assert (got["nr"], got["nphi"]) == (table["nr"], table["nphi"])
    np.testing.assert_allclose(got["r"], 2.0 * table["r"], rtol=1e-7)
    np.testing.assert_allclose(got["T"], table["T"], rtol=1e-7)
    jm = jdisks.NumDisk(dfile=str(path), tscl=1e7, rscl=2.0)
    tm = load_fluid_model("NUMDISK", device="cpu", dfile=str(path), tscl=1e7,
                          rscl=2.0)
    x, k = _disk_points(2)
    _close("T", tm.vals(torch.from_numpy(x), torch.from_numpy(k), A).rho,
           jm.vals(jnp.asarray(x), jnp.asarray(k), A).rho)
    assert (tm.vals(torch.from_numpy(x), torch.from_numpy(k), A).rho
            == 0).any()                      # outside the table's radii


DISK = dict(spin=A, standard=2, mbh=10.0)
PROBLEMS = {
    # tests/test_e2e.py:17-22
    "thindisk_bbpol": dict(DISK, fname="THINDISK", ename="BBPOL", nvals=4,
                           nn=(32, 32, 1), uout=0.01, mumin=0.26, mumax=0.26,
                           nfreq=4, fmin=2.41e16, fmax=6.31e18,
                           gridvals=(-21.0, 21.0, -21.0, 21.0),
                           fargs=dict(mbh=10.0, mdot=0.1)),
    # tests/test_e2e.py:43-48
    "thindisk_bb": dict(DISK, fname="THINDISK", ename="BB", nvals=1,
                        spin=0.0, nn=(40, 40, 1), mumin=0.999, mumax=0.999,
                        nfreq=1, fmin=1e17, fmax=1e17,
                        gridvals=(-25.0, 25.0, -25.0, 25.0),
                        fargs=dict(mbh=10.0, mdot=0.1)),
    # tests/test_e2e.py:160-166
    "phatdisk_interp": dict(DISK, fname="PHATDISK", ename="INTERP", nvals=1,
                            nn=(16, 16, 1), mumin=0.5, mumax=0.5, nfreq=3,
                            fmin=1e17, fmax=1e18,
                            gridvals=(-20.0, 20.0, -20.0, 20.0), fargs=PHAT),
    # tests/test_e2e.py:176-181 on a seeded table
    "numdisk_bb": dict(DISK, fname="NUMDISK", ename="BB", nvals=1,
                       nn=(12, 12, 1), mumin=0.5, mumax=0.5, nfreq=2,
                       fmin=1e17, fmax=1e18,
                       gridvals=(-20.0, 20.0, -20.0, 20.0),
                       fargs=dict(table=_numdisk_table())),
}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def pair(request):
    kw = PROBLEMS[request.param]
    # each package's model keeps its own copy of the table dict
    jkw = dict(kw, fargs={k: dict(v) if isinstance(v, dict) else v
                          for k, v in kw["fargs"].items()})
    ref, ab, _ = jgrtrans_run(JGrtransConfig(**jkw))
    ours, tab, _ = grtrans_run(convert.config_from_jax(JGrtransConfig(**kw)),
                               device="cpu")
    return request.param, ours.numpy(), np.asarray(ref), tab.numpy(), ab


def test_image_matches_jax(pair):
    name, ours, ref, tab, ab = pair
    kw = PROBLEMS[name]
    npix = kw["nn"][0] * kw["nn"][1]
    assert ours.shape == ref.shape == (kw["nfreq"], npix, kw["nvals"])
    np.testing.assert_array_equal(tab, ab)
    assert np.isfinite(ours).all() and (ours[..., 0] >= 0).all()
    assert ours[..., 0].max() > 0
    np.testing.assert_array_equal(ours[..., 0] > 0, ref[..., 0] > 0)
    rel_l1 = np.abs(ours - ref).sum() / np.abs(ref).sum()
    print(f"{name}: I max {ours[..., 0].max(1)}, rel L1 {rel_l1:.3e}")
    assert rel_l1 <= 1e-8


def test_image_is_the_physical_one(pair):
    """The checks of tests/test_e2e.py on the port's image."""
    name, ours, _, tab, _ = pair
    I = ours[..., 0]
    if name == "thindisk_bbpol":
        # bounded by the Chandrasekhar maximum of 11.7% at the limb
        lp = np.sqrt(ours[..., 1] ** 2 + ours[..., 2] ** 2)
        nz = I > I.max() * 1e-6
        assert (lp[nz] <= 0.1180 * I[nz] * 1.001).all() and lp.max() > 0
        assert (ours[..., 3] == 0).all()
    if name == "thindisk_bb":
        # face on: a ring outside the shadow, peaked near twice the ISCO
        rho = np.sqrt(tab[0] ** 2 + tab[1] ** 2)
        assert 6.0 < rho[np.argmax(I[0])] < 16.0
        assert I[0][rho < 4].max() < 1e-6 * I.max()
        assert I[0][rho > 24].max() < 0.6 * I.max()


def test_default_config_renders_through_the_api():
    """GrtransConfig's default model is THINDISK; standard=2 output goes
    through calc_spec and the polarization fractions."""
    kw = dict(PROBLEMS["thindisk_bbpol"], nn=(12, 12, 1))
    ours = Grtrans(**kw).run(device="cpu")
    ref = JGrtrans(**kw).run()
    assert ours.cfg.fname == Grtrans(standard=2).cfg.fname == "THINDISK"
    assert ours.ivals.shape == ref.ivals.shape == (144, 4, 4)
    np.testing.assert_allclose(ours.spec, ref.spec, rtol=1e-9,
                               atol=1e-9 * np.abs(ref.spec[0]).max())
    np.testing.assert_allclose(ours.lp, ref.lp, rtol=1e-7)
    assert ((ours.lp > 0) & (ours.lp < 0.118)).all()
    # blocks of 50 pixels: 50 + 50 + 44
    blocks = Grtrans(**kw).run(device="cpu", chunk=50)
    np.testing.assert_allclose(blocks.ivals, ours.ivals, rtol=0.0,
                               atol=1e-12 * np.abs(ours.ivals).max())
