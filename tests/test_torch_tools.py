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
a loaded model loads no model.

emitter_observer: the port's BFGS, its gradient from autograd through the
trace, recovers the impact parameters of tests/test_tools.py's emission
point to 0.05, as grtrans_tpu's does, and lands within 1e-6 of grtrans_tpu's
res.x.  fit_image: three Adam steps on a 4x4 x 16 SARIAF problem give
grtrans_tpu's parameters and losses to 1e-8 (measured 3e-11).  The fit
integrates with the unpolarized quadrature: the reverse pass of
grtrans_tpu's polarized march takes over a minute to compile on this
sandbox's CPU, and tests/test_torch_gradients.py holds that march's
gradient."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrans_tpu.config import GrtransConfig as JConfig
from grtrans_tpu.tools import geodebug as jdebug
from grtrans_tpu.tools import emitter_observer as jeo
from grtrans_tpu.tools import invert as jinvert
from grtrans_tpu.tools import pgriter as jpgriter
from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.fluid import base as tbase
from grtrans_tpu_torch.orchestrator import grtrans_run
from grtrans_tpu_torch.testing import grmhd_dump
from grtrans_tpu_torch.tools import geodebug as tdebug
from grtrans_tpu_torch.tools import emitter_observer as teo
from grtrans_tpu_torch.tools import invert as tinvert
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


def test_emitter_observer_recovers_the_point_as_jax_does():
    """tests/test_tools.py::test_emitter_observer in the port: the point
    on the ray of (4.1, 2.3) at r = 8 (grtrans_tpu's, which the port's
    _point_at_u reproduces to 1e-10), searched from (4.5, 1.9)."""
    a, mu0, ustar = 0.9, float(np.cos(np.deg2rad(45.0))), 1.0 / 8.0
    ab_true = (4.1, 2.3)
    mu_c, ph_c, ok = jeo._point_at_u(a, mu0, jnp.asarray(ab_true[0]),
                                     jnp.asarray(ab_true[1]), ustar)
    tmu, tph, tok = teo._point_at_u(
        a, mu0, *(torch.tensor(v, dtype=torch.float64) for v in ab_true),
        ustar)
    assert bool(ok) and bool(tok)
    np.testing.assert_allclose([tmu.item(), tph.item()],
                               [float(mu_c), float(ph_c)], rtol=1e-10)
    guess = (ab_true[0] + 0.4, ab_true[1] - 0.4)
    res = teo.run(ustar, float(mu_c), float(-ph_c), guess, a=a, mu0=mu0,
                  device="cpu")
    assert res.fun < 1e-6
    np.testing.assert_allclose(res.x, ab_true, atol=0.05)
    ref = jeo.run(ustar, float(mu_c), float(-ph_c), guess, a=a, mu0=mu0)
    np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=1e-6)


INV_KW = dict(fname="SARIAF", ename="POLSYNCHTH", iname="quadrature",
              freq=2.3e11, mbh=4e6, nn=(4, 4, 16),
              gridvals=(-12.0, 12.0, -12.0, 12.0),
              fixed=dict(mu0=0.5, t0=1.6e11, beta=10.0))


def _target():
    with torch.no_grad():
        problem = tinvert.InverseProblem(**INV_KW, device="cpu")
        return problem.render(dict(spin=0.9, n0=4e7)).numpy()


def test_fit_image_matches_jax():
    """Three Adam steps fitting (spin, n0) from (0.8, 3e7): the atanh and
    log transforms, the loss, optax's Adam and the best-step bookkeeping,
    against grtrans_tpu's fit_image on the same target."""
    target = _target()
    init = dict(spin=0.8, n0=3e7)
    ours, losses = tinvert.fit_image(
        tinvert.InverseProblem(**INV_KW, device="cpu"), target, init,
        steps=3, lr=0.05)
    ref, ref_losses = jinvert.fit_image(jinvert.InverseProblem(**INV_KW),
                                        jnp.asarray(target), init, steps=3,
                                        lr=0.05)
    assert set(ours) == set(ref)
    for k in ours:
        assert ours[k] == pytest.approx(ref[k], rel=1e-8), k
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-8)
    # pixel chunks accumulate the same gradient, to the rounding of a
    # batch of another length (PyTorch's CPU exp and log round the last
    # elements of a vector differently; measured 8.7e-11 on the losses)
    chunked, chunk_losses = tinvert.fit_image(
        tinvert.InverseProblem(**INV_KW, device="cpu"), target, init,
        steps=3, lr=0.05, chunk=6)
    for k in ours:
        assert chunked[k] == pytest.approx(ours[k], rel=1e-9), k
    np.testing.assert_allclose(chunk_losses, losses, rtol=1e-9)


def test_fit_image_cosine_schedule_is_optax_s():
    """lr_end: CosineAnnealingLR(T_max=steps, eta_min=lr_end) gives the
    rates of optax.cosine_decay_schedule(lr, steps, alpha=lr_end / lr)."""
    import optax
    lr, lr_end, steps = 0.1, 0.01, 7
    opt = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=lr)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps,
                                                       eta_min=lr_end)
    rates = []
    for _ in range(steps):
        rates.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    ref = optax.cosine_decay_schedule(lr, steps, alpha=lr_end / lr)
    np.testing.assert_allclose(rates, [float(ref(i)) for i in range(steps)],
                               rtol=1e-12)


def test_fit_image_refuses_an_all_nan_gradient(monkeypatch):
    """Partial NaNs are zeroed (as in grtrans_tpu); a step whose every
    gradient entry is NaN raises instead of stepping on zeros."""
    problem = tinvert.InverseProblem(**INV_KW, device="cpu")
    target = np.ones((16, 4))
    nan = float("nan")
    monkeypatch.setattr(problem, "render", lambda p, pix=None: torch.ones(
        16, 4, dtype=torch.float64) * p["n0"] * torch.where(
            p["spin"] > 0, p["spin"] * nan, p["spin"]))
    with pytest.raises(FloatingPointError, match="every gradient"):
        tinvert.fit_image(problem, target, dict(spin=0.8, n0=3e7), steps=2)
    # a finite render whose spin gradient is NaN (0 * NaN through where)
    monkeypatch.setattr(problem, "render", lambda p, pix=None: torch.ones(
        16, 4, dtype=torch.float64) * (p["n0"] / 3e7) + torch.where(
            p["spin"] > 1.0, p["spin"] * nan, 0.0))
    fitted, losses = tinvert.fit_image(problem, target,
                                       dict(spin=0.8, n0=2e7), steps=2)
    assert fitted["spin"] == pytest.approx(0.8, rel=1e-12)
    assert losses[1] < losses[0] and np.isfinite(losses).all()


def test_geometry_only_fit_caches_the_model_by_its_load_kwargs(monkeypatch):
    """A (spin, mu0) fit loads its model once for a set of load kwargs and
    again for another; a fit of a model parameter loads every render."""
    loads = []
    real = tbase._REGISTRY["SARIAF"]
    monkeypatch.setitem(tbase._REGISTRY, "SARIAF",
                        lambda **kw: loads.append(kw["n0"]) or real(**kw))
    problem = tinvert.InverseProblem(**dict(INV_KW, fixed=dict(n0=4e7)),
                                     device="cpu")
    with torch.no_grad():
        for spin in (0.5, 0.6):
            problem.render(dict(spin=spin, mu0=0.5))
        problem.fixed = dict(n0=5e7)
        problem.render(dict(spin=0.5, mu0=0.5))
        problem.render(dict(spin=0.5, mu0=0.5, n0=6e7))
    assert loads == [4e7, 5e7, 6e7]
