"""The port's tools against grtrans_tpu's, on the CPU: the single-ray
debug dump (tools/geodebug) and the secant flux fit (tools/pgriter).

Bars.  geodebug: the two packages' dumps of one pixel carry the same keys
and shapes; the geodesic arrays agree as in tests/test_torch_geodesics.py
(1e-10 of each array's largest value, t measured 2.8e-12; the wavevector
1e-7 of each entry, measured 7.3e-8 next to a turning point, and the
tetrad angles it enters 1e-7 of their largest value, as in
tests/test_torch_extra_debug.py), the fluid and coefficient arrays to
1e-9 of their largest value, the Stokes
profiles and the pixel to 1e-8 of theirs.  At 4.6e11 Hz the ray crosses
Faraday-thick cells, where grtrans_tpu's matricant eigenvalue cancels
(tests/test_torch_solvers.py): its V is 6.7e-9 of I off the integration
with every O from the extended-precision expm, the port's 6e-17.  So a
dump re-integrated in the package that wrote it gives its pixel to 1e-12,
in the other to 1e-8 of the pixel's I, and the port's dumped pixel equals
the pixel of its full-camera render to 1e-10.  pgriter: the port's
secant history equals grtrans_tpu's to 1e-8 relative, and a fit through
a loaded model loads no model."""

import numpy as np
import pytest
import torch

from grtrans_tpu.config import GrtransConfig as JConfig
from grtrans_tpu.tools import geodebug as jdebug
from grtrans_tpu.tools import pgriter as jpgriter
from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.fluid import base as tbase
from grtrans_tpu_torch.orchestrator import grtrans_run
from grtrans_tpu_torch.testing import grmhd_dump
from grtrans_tpu_torch.tools import geodebug as tdebug
from grtrans_tpu_torch.tools import pgriter as tpgriter

torch.set_num_threads(1)   # the suite runs in parallel worker processes

# tests/test_tools.py::test_geodebug_dump_and_reintegrate's configuration,
# its rays started at r = 400 (uout = 0.0025), clear of grtrans_tpu's
# rho_V noise band (tests/test_torch_api.py)
DEBUG_KW = dict(fname="SARIAF", ename="POLSYNCHTH", nvals=4, spin=0.9,
                standard=1, nn=(6, 6, 32), mumin=0.5, mumax=0.5, nmu=1,
                nfreq=2, fmin=2.3e11, fmax=4.6e11, iname="formal", mbh=4e6,
                gridvals=(-12.0, 12.0, -12.0, 12.0), debug=1, uout=0.0025,
                fargs=dict(n0=4e7, t0=1.6e11, beta=10.0))
GEOMETRY = ("x", "lam", "u", "alpha", "beta")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("geodebug")
    ours = tdebug.dump_ray(GrtransConfig(**DEBUG_KW), 15, tmp / "port.npz",
                           device="cpu")
    ref = jdebug.dump_ray(JConfig(**DEBUG_KW), 15, tmp / "jax.npz")
    return tmp, ours, ref


def test_geodebug_dumps_match_key_by_key(dumps):
    tmp, ours, ref = dumps
    assert set(ours) == set(ref)
    for key in ("j_0", "K_0", "prof_0", "j_1", "K_1", "prof_1", "ivals"):
        assert key in ours, key
    assert ours["x"].shape == (1, 32, 4)
    for key, r in ref.items():
        o = ours[key]
        assert o.shape == r.shape, key
        if r.dtype.kind in "biuU":
            np.testing.assert_array_equal(o, r, err_msg=key)
        elif key == "kvec":
            np.testing.assert_allclose(o, r, rtol=1e-7, err_msg=key)
        else:
            rtol = 1e-10 if key in GEOMETRY else 1e-9
            if key in ("s2xi", "c2xi", "ang"):
                rtol = 1e-7
            if key == "ivals" or key.startswith("prof_"):
                rtol = 1e-8
            np.testing.assert_allclose(o, r, rtol=0.0,
                                       atol=rtol * np.abs(r).max(),
                                       err_msg=key)
    assert set(np.load(tmp / "port.npz").files) == set(ours)


def test_geodebug_dumps_reintegrate_in_either_package(dumps):
    tmp, ours, ref = dumps
    for path, dump, own in ((tmp / "port.npz", ours, 0),
                            (tmp / "jax.npz", ref, 1)):
        for f in range(2):
            pixel = dump["ivals"][f, 0]
            again = (tdebug.reintegrate(tdebug.load(path), f, device="cpu"),
                     jdebug.reintegrate(jdebug.load(path), f))
            np.testing.assert_allclose(again[own][0], pixel, rtol=1e-12,
                                       atol=1e-12 * np.abs(pixel).max())
            np.testing.assert_allclose(again[1 - own][0], pixel, rtol=0.0,
                                       atol=1e-8 * np.abs(pixel).max())
    cfg = GrtransConfig(**dict(DEBUG_KW, debug=0))
    full, _, _ = grtrans_run(cfg, device="cpu")
    np.testing.assert_allclose(ours["ivals"][:, 0], full[:, 14].numpy(),
                               rtol=1e-10)


# tests/test_tools.py::test_pgriter_secant's configuration
FIT_KW = dict(fname="POWERLAW", ename="POLSYNCHTH", nvals=1, spin=0.9,
              standard=1, nn=(8, 8, 24), mumin=0.5, mumax=0.5, nmu=1,
              nfreq=1, fmin=2.3e11, fmax=2.3e11, iname="formal", mbh=4e6,
              gridvals=(-12.0, 12.0, -12.0, 12.0),
              fargs=dict(n0=3e7, t0=6e10, beta=10.0))


def test_pgriter_recovers_a_density():
    """A fit of the fargs density n0, every step loading the model."""
    cfg = GrtransConfig(**FIT_KW)
    target, x = tpgriter.flux_at(cfg, 9e6, param="n0", device="cpu")
    assert x.cfg.fargs["n0"] == 9e6 and cfg.fargs["n0"] == 3e7
    fitted, flux, hist = tpgriter.fit_flux(cfg, target, guess=5e7,
                                           param="n0", device="cpu")
    assert abs(np.log(flux / target)) < 1e-3
    assert abs(np.log(fitted / 9e6)) < 0.2 and len(hist) <= 8


def test_pgriter_through_a_loaded_model_loads_it_once(monkeypatch):
    """An mdot fit on a HARM3D snapshot: the model is loaded by the caller
    and handed to every step; grtrans_tpu reloads it at every step, and
    the histories agree."""
    kw = dict(FIT_KW, fname="HARM3D", nvals=4, spin=grmhd_dump.A,
              uout=0.04, gmin=10.0, nn=(6, 6, 24),
              fargs=dict(dump=grmhd_dump.harm3d_dump(16, 12, 8)))
    tcfg = GrtransConfig(**kw)
    model = tbase.load_fluid_model("HARM3D", device="cpu", **tcfg.fargs)
    target, _ = tpgriter.flux_at(tcfg, 6e15, model=model, device="cpu")
    loads = []
    real = tbase._REGISTRY["HARM3D"]
    monkeypatch.setitem(tbase._REGISTRY, "HARM3D",
                        lambda **kw: loads.append(1) or real(**kw))
    fitted, flux, hist = tpgriter.fit_flux(tcfg, target, 4e15, model=model,
                                           device="cpu")
    assert not loads and len(hist) >= 3
    assert abs(np.log(flux / target)) < 1e-3
    ref = jpgriter.fit_flux(JConfig(**kw), target, 4e15)
    np.testing.assert_allclose(np.array(hist), np.array(ref[2]), rtol=1e-8)
    with pytest.raises(ValueError, match="fargs"):
        tpgriter.flux_at(tcfg, 1.0, param="n0", model=model, device="cpu")
