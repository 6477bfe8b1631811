"""The port's run-from-a-file path against grtrans_tpu's, on the CPU:
the namelists (io/namelist), the run-parameter header keys, FITS output
(io/fitsio), the command line (`python -m grtrans_tpu_torch`), geodesic
bundles (`grtrans_run(gdfile=)`, geodesics/cache) and grtrans_run's
verbose and device_output.

Bars: namelists, header keys, FITS bytes and bundle keys exactly equal;
the CLI's file equal to the float32 of the port's render, and against
grtrans_tpu's file at float32 rounding: Stokes I within 2^-23 of itself
a pixel (the f64 images' I agree to ~1e-10), the whole image to rel L1
1e-7 (float32 rounding 6e-8 plus the render tests' 1e-8: V of a pixel
differs by up to 6e-7 of itself at 2.3e11 Hz); a bundle that
grtrans_tpu wrote rendered by the port to rel L1 1e-8 (the bar of
tests/test_torch_render.py); a bundle hit against a fresh trace in the
port 1e-12 relative (measured: bitwise equal)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from grtrans_tpu.__main__ import main as jmain
from grtrans_tpu.config import GrtransConfig as JConfig
from grtrans_tpu.fluid.base import _REGISTRY as JREGISTRY
from grtrans_tpu.fluid.base import _import_all_models
from grtrans_tpu.geodesics import cache as jcache
from grtrans_tpu.io import fitsio as jfits
from grtrans_tpu.io import namelist as jnml
from grtrans_tpu.io.binio import read_camera_bin as jread_bin
from grtrans_tpu.orchestrator import grtrans_run as jrun
from grtrans_tpu_torch import convert
from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.geodesics import cache as tcache
from grtrans_tpu_torch.geodesics import geokerr as tgeo
from grtrans_tpu_torch.io import fitsio as tfits
from grtrans_tpu_torch.io import namelist as tnml
from grtrans_tpu_torch.io.binio import read_camera_bin
from grtrans_tpu_torch.orchestrator import grtrans_run
from grtrans_tpu_torch.parallel import sharding

torch.set_num_threads(1)   # the suite runs in parallel worker processes

REPO = Path(__file__).resolve().parents[1]

# the SARIAF configuration of tests/test_tools.py::test_cli_end_to_end,
# its rays started at r = 400 (uout = 0.0025): from the default uout they
# start in grtrans_tpu's rho_V noise band, where Q and U differ by 3e-5
# (tests/test_torch_api.py)
CLI_KW = dict(fname="SARIAF", ename="POLSYNCHTH", nvals=4, spin=0.9,
              standard=1, nn=(6, 6, 24), mumin=0.5, mumax=0.5, nmu=1,
              nfreq=1, fmin=2.3e11, fmax=2.3e11, iname="formal", mbh=4e6,
              gridvals=(-12.0, 12.0, -12.0, 12.0), uout=0.0025,
              fargs=dict(n0=4e7, t0=1.6e11, beta=10.0))
# the configuration of tests/test_geocache.py
GEO_KW = dict(fname="SARIAF", ename="POLSYNCHTH", nvals=4, spin=0.9,
              standard=1, nn=(8, 8, 48), mbh=4e6, mumin=0.5, mumax=0.5,
              nmu=1, nfreq=1, fmin=2.3e11, fmax=2.3e11, iname="formal",
              gridvals=(-12.0, 12.0, -12.0, 12.0),
              fargs=dict(n0=4e7, t0=1.6e11, beta=10.0))


def _cfgs(**kw):
    return JConfig(**kw), GrtransConfig(**kw)


def test_namelist_roundtrip_and_cross_parse(tmp_path):
    kw = dict(fname="POWERLAW", ename="POLSYNCHTH", nvals=4, spin=0.71,
              nn=(6, 5, 16), nfreq=2, fmin=1e11, fmax=2e11, iname="delo",
              stype="const", epcoefindx=(1, 1, 1, 1, 0, 0, 1), i1=3, i2=9,
              gridvals=(-7.5, 7.0, -6.0, 6.5),
              fargs=dict(n0=3e7, t0=6e10, beta=10.0))
    jcfg, tcfg = _cfgs(**kw)
    tnml.write_inputs(tcfg, tmp_path / "port.in")
    jnml.write_inputs(jcfg, tmp_path / "jax.in")
    assert (tmp_path / "port.in").read_bytes() == \
        (tmp_path / "jax.in").read_bytes()
    back = tnml.read_inputs(tmp_path / "port.in")
    assert back == tcfg
    # each package's file parses to the same config in the other
    assert tnml.read_inputs(tmp_path / "jax.in") == back
    assert convert.config_from_jax(jnml.read_inputs(tmp_path / "port.in")) \
        == back
    tnml.write_files_in("a.in", "b.fits", tmp_path / "files.in")
    assert tnml.read_files_in(tmp_path / "files.in") == ("a.in", "b.fits")
    groups = "&harm\n fdfile='dump', fhfile='dump040', fnt=1, fsim='x',\n/\n"
    assert tnml.parse_namelists(groups) == jnml.parse_namelists(groups)


def test_fargs_filter_matches_jax_for_every_model():
    """The reference's flat fluid_args bag, filtered per model: the port
    names each model's keywords by inspect.signature of its factory."""
    import inspect
    _import_all_models()
    bag = {f.name: 1.0 for cls in JREGISTRY.values()
           for f in dataclasses.fields(cls)}
    bag.update(sim="x", indf=2, offset=0.0, magcrit=1, device="cpu")
    assert len(JREGISTRY) == 22
    for name in JREGISTRY:
        assert tnml._filter_fargs(name, bag) == \
            jnml._filter_fargs(name, bag), name
    assert tnml._filter_fargs("NOTAMODEL", bag) == bag
    from grtrans_tpu_torch.fluid import base
    assert "region" in inspect.signature(
        base._REGISTRY["KORAL3D_DISK"]).parameters


@pytest.mark.parametrize("name,key,value", [
    ("HARM3D", "h", 0.5), ("MB09", "hfile", "dump.head"),
    ("MB09", "jonfix", 0), ("MB09", "mdot_code", 0.003)])
def test_keywords_a_model_never_reads_are_refused(name, key, value):
    """grtrans_tpu's HARM3D and MB09 take these keywords and never read
    them; the port takes them too, so that a namelist's fargs filter
    alike, and refuses every value but the default."""
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    with pytest.raises(ValueError, match=f"{name} does not read {key}"):
        load_fluid_model(name, device="cpu", **{key: value})


def test_header_keys_and_fits_bytes_match_jax(tmp_path):
    kw = dict(CLI_KW, nfreq=2, fmax=3e11, nmdot=2, mdotmax=3e15, nt=2,
              epcoefindx=(1, 1, 1, 1, 1, 1, 0))
    jcfg, tcfg = _cfgs(**kw)
    dicts = tcfg.camera_key_dicts()
    assert dicts == jcfg.camera_key_dicts() and len(dicts) == 8
    assert tcfg.header_keys() == jcfg.header_keys()
    rng = np.random.default_rng(0)
    ab = rng.normal(size=(36, 2))
    cams = [rng.normal(size=(36, 4)) for _ in dicts]
    tfits.write_fits(tmp_path / "port.fits", ab, cams, dicts)
    jfits.write_fits(tmp_path / "jax.fits", ab, cams, dicts)
    assert (tmp_path / "port.fits").read_bytes() == \
        (tmp_path / "jax.fits").read_bytes()
    for reader in (tfits.read_fits, jfits.read_fits):
        ab2, cams2, keys, heads = reader(tmp_path / "port.fits",
                                         with_headers=True)
        np.testing.assert_array_equal(ab2, ab.astype(np.float32))
        for c, c2 in zip(cams, cams2):
            np.testing.assert_array_equal(c2, c.T.ravel().astype(np.float32))
        # KEY1 is the camera's frequency, as the header card prints it
        assert [k[0] for k in keys] == [float(f"{d['freq']:.13E}")
                                        for d in dicts]
        assert float(heads[0]["SPIN"]) == 0.9 and len(heads[0]) > 40


def test_cli_matches_jax_and_needs_a_device_it_has(tmp_path):
    """One subprocess of the port on the CPU; grtrans_tpu's main in this
    process."""
    jcfg, tcfg = _cfgs(**CLI_KW)
    tnml.write_inputs(tcfg, tmp_path / "inputs.in")
    tnml.write_files_in(str(tmp_path / "inputs.in"), str(tmp_path / "t.bin"),
                        tmp_path / "files.in")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "grtrans_tpu_torch",
                        str(tmp_path / "files.in"), "--device", "cpu"],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "grtrans_run:" in r.stdout and "wrote 1 camera(s)" in r.stdout
    assert jmain([str(tmp_path / "files.in"), "--output",
                  str(tmp_path / "j.bin")]) == 0
    ab, cams, keys = read_camera_bin(tmp_path / "t.bin")
    jab, jcams, jkeys = jread_bin(tmp_path / "j.bin")
    assert (tmp_path / "t.bin").stat().st_size == \
        (tmp_path / "j.bin").stat().st_size
    np.testing.assert_array_equal(ab, jab)
    assert keys == jkeys
    assert cams[0].shape == (36, 4) and cams[0][:, 0].max() > 0
    # the file holds the float32 of the render
    mine, _, _ = grtrans_run(tcfg, device="cpu")
    np.testing.assert_array_equal(cams[0], mine[0].numpy().astype(np.float32))
    I, jI = cams[0][:, 0], jcams[0][:, 0]
    assert (np.abs(I - jI) <= 2.0 ** -23 * np.abs(jI)).all()
    assert np.abs(cams[0] - jcams[0]).sum() / np.abs(jcams[0]).sum() <= 1e-7
    if not torch.cuda.is_available():
        from grtrans_tpu_torch.__main__ import main
        with pytest.raises(RuntimeError, match="CUDA"):
            main([str(tmp_path / "files.in")])


@pytest.fixture(scope="module")
def plain_geo():
    cfg = GrtransConfig(**GEO_KW)
    return cfg, grtrans_run(cfg, device="cpu")[0]


@pytest.mark.parametrize("chunk", [None, 24])
def test_gdfile_roundtrip_and_stale_bundles(plain_geo, tmp_path, chunk,
                                            monkeypatch):
    cfg, plain = plain_geo
    path = tmp_path / "geo.npz"
    first, _, _ = grtrans_run(cfg, device="cpu", gdfile=str(path),
                              chunk=chunk)
    assert path.exists()
    # a hit does not trace
    def no_trace(*args, **kw):
        raise AssertionError("traced on a bundle hit")
    monkeypatch.setattr(tgeo, "trace", no_trace)
    second, _, _ = grtrans_run(cfg, device="cpu", gdfile=str(path),
                               chunk=chunk)
    assert torch.equal(first, second)
    torch.testing.assert_close(second, plain, rtol=1e-12, atol=0.0)
    monkeypatch.undo()
    # another camera misses and re-traces; so does a truncated file
    other = dataclasses.replace(cfg, gridvals=(-10.0, 10.0, -10.0, 10.0))
    third, _, _ = grtrans_run(other, device="cpu", gdfile=str(path))
    assert not torch.allclose(third, first)
    path.write_bytes(path.read_bytes()[:100])
    assert tcache.load_bundle(path, device="cpu") is None
    again, _, _ = grtrans_run(cfg, device="cpu", gdfile=str(path))
    assert torch.equal(again, first)


def test_gdfile_one_bundle_per_mu_camera(tmp_path):
    cfg = GrtransConfig(**dict(GEO_KW, nn=(4, 4, 24), nmu=2, mumin=0.4,
                               mumax=0.6))
    ivals, _, _ = grtrans_run(cfg, device="cpu", gdfile=str(tmp_path / "g"))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["g.mu0.400000", "g.mu0.600000"]
    again, _, _ = grtrans_run(cfg, device="cpu", gdfile=str(tmp_path / "g"))
    assert torch.equal(again, ivals)


def test_bundle_key_matches_jax_and_discriminates():
    base = (0.9, 0.5, 48, 0.01, -0.5, 1, (-12.0, 12.0, -12.0, 12.0), 8, 8)
    assert tcache.bundle_key(*base) == jcache.bundle_key(*base)
    assert tcache.bundle_key(*base, i1=3, i2=5) == \
        jcache.bundle_key(*base, i1=3, i2=5)
    keys = {tcache.bundle_key(*base),
            tcache.bundle_key(*base[:-1], 9),
            tcache.bundle_key(*base[:3], None, *base[4:]),
            tcache.bundle_key(*base, i1=3, i2=5),
            tcache.bundle_key(*base, i1=4, i2=6)}
    assert len(keys) == 5


def test_bundles_cross_between_packages(tmp_path, monkeypatch):
    """A bundle grtrans_tpu wrote renders in the port without a trace, to
    the render tests' bar against grtrans_tpu's image; a bundle the port
    wrote loads in grtrans_tpu field by field."""
    jcfg, tcfg = _cfgs(**dict(GEO_KW, uout=0.01))
    jpath = str(tmp_path / "jax.npz")
    ref, _, _ = jrun(jcfg, gdfile=jpath)
    monkeypatch.setattr(tgeo, "trace", None)        # a hit cannot trace
    ours, _, _ = grtrans_run(tcfg, device="cpu", gdfile=jpath)
    monkeypatch.undo()
    ours = ours.numpy()
    assert np.abs(ours - ref).sum() / np.abs(ref).sum() <= 1e-8
    tpath = str(tmp_path / "port.npz")
    grtrans_run(tcfg, device="cpu", gdfile=tpath)
    key = jcache.bundle_key(0.9, 0.5, 48, 0.01, -0.5, 1,
                            (-12.0, 12.0, -12.0, 12.0), 8, 8, 2, 1.0, -1, -1)
    jgeo = jcache.load_bundle(tpath, key=key)
    tgeo_ = tcache.load_bundle(tpath, key, device="cpu")
    assert jgeo is not None and tgeo_ is not None
    for f in tgeo_._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jgeo, f)),
                                      getattr(tgeo_, f).numpy())


def test_verbose_and_device_output(plain_geo, capsys, tmp_path):
    cfg = dataclasses.replace(plain_geo[0], nmdot=2, mdotmin=1e14,
                              mdotmax=1e16, nfreq=2, fmax=4e11)
    whole, _, _ = grtrans_run(cfg, device="cpu", verbose=True)
    assert capsys.readouterr().out.startswith("grtrans_run: ")
    parts, ab, freqs = grtrans_run(cfg, device="cpu", device_output=True)
    assert isinstance(parts, list) and len(parts) == 2
    assert all(p.shape == (2, 64, 4) for p in parts)
    assert torch.equal(torch.cat(parts), whole)
    # a mesh of one process gives the same list; what is not a mesh is
    # refused
    assert not dist.is_initialized()
    try:
        meshed, _, _ = grtrans_run(cfg, device="cpu", device_output=True,
                                   mesh=sharding.pixel_mesh(device_type="cpu"))
    finally:
        dist.destroy_process_group()
    assert len(meshed) == 2
    assert all(torch.equal(m, p) for m, p in zip(meshed, parts))
    with pytest.raises(TypeError, match="DeviceMesh"):
        grtrans_run(cfg, device="cpu", mesh=object())
    # the command line renders prec="mixed" (--prec; the namelists do not
    # carry it) at 4x4x32: the file holds the float32 of grtrans_run's
    # float64 image, finite, within 2e-3 of max|I| of the float64 render
    # (tests/test_precision.py's bar; measured 1.7e-4)
    small = GrtransConfig(**dict(CLI_KW, nn=(4, 4, 32)))
    tnml.write_inputs(small, tmp_path / "inputs.in")
    tnml.write_files_in(str(tmp_path / "inputs.in"),
                        str(tmp_path / "mixed.bin"), tmp_path / "files.in")
    from grtrans_tpu_torch.__main__ import main
    assert main([str(tmp_path / "files.in"), "--device", "cpu",
                 "--prec", "mixed"]) == 0
    _, cams, _ = read_camera_bin(tmp_path / "mixed.bin")
    mixed, _, _ = grtrans_run(dataclasses.replace(small, prec="mixed"),
                              device="cpu")
    f64, _, _ = grtrans_run(small, device="cpu")
    assert mixed.dtype == torch.float64 and torch.isfinite(mixed).all()
    np.testing.assert_array_equal(cams[0],
                                  mixed[0].numpy().astype(np.float32))
    assert (mixed - f64).abs().max() <= 2e-3 * f64[..., 0].abs().max()
