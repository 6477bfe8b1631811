"""Slow light (nload > 1 on a time series) in the port against
grtrans_tpu.orchestrator.grtrans_run, on the CPU.

A seeded synthetic HARM3D snapshot and scaled copies of it as later
slices, rendered at 8x8 pixels x 32 points (the configuration of
tests/test_slowlight.py at a smaller camera).  Bars: the two-slice
slow-light image against grtrans_tpu's jitted run, relative L1 over IQUV
<= 1e-8; a render in pixel blocks (`chunk=`) against the unchunked one
1e-12 of the image's maximum, which holds only because the camera delay's
minimum is taken over the whole camera before the block loop.
"""

import numpy as np
import pytest
import torch
from scipy import integrate

import jax.numpy as jnp

from grtrans_tpu.config import GrtransConfig as JConfig
from grtrans_tpu.geodesics import geokerr as jgeo
from grtrans_tpu.orchestrator import grtrans_run as jrun
from grtrans_tpu_torch import convert
from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.fluid.grmhd3d import FIELDS
from grtrans_tpu_torch.geodesics import camera as tcam
from grtrans_tpu_torch.geodesics import geokerr as tgeo
from grtrans_tpu_torch.orchestrator import grtrans_run
from grtrans_tpu_torch.testing import grmhd_dump as gd

from test_torch_grmhd import A, both

torch.set_num_threads(1)   # the suite runs in parallel worker processes

NN = (8, 8, 32)


def _kw(nload, **change):
    kw = dict(fname="HARM3D", ename="POLSYNCHTH", nvals=4, spin=A, standard=1,
              nn=NN, uout=0.04, mbh=4.3e6, mumin=0.5, mumax=0.5, nmu=1,
              nfreq=1, fmin=2.3e11, fmax=2.3e11, iname="formal",
              mdotmin=3e15, mdotmax=3e15, nmdot=1,
              gridvals=(-12.0, 12.0, -12.0, 12.0), gmin=10.0, muval=0.25,
              nload=nload)
    kw.update(change)
    return kw


def _scaled(base, fac):
    """The snapshot with rho, p scaled by fac and B by sqrt(fac): T_e, beta
    and the temperature ratio stay, n and B grow, so the image brightens
    with fac."""
    arrs = {k: v * fac if k in ("rho", "p") else v for k, v in base.items()}
    for k in ("b0", "br", "bth", "bph"):
        arrs[k] = base[k] * np.sqrt(fac)
    return arrs


def _series(model, facs, tstep, toffset=0.0):
    base = {k: model.f[k][0] for k in FIELDS}
    for fac in facs:
        model.append_slice(_scaled(base, fac))
    model.tstep, model.toffset = tstep, toffset
    return model


def _port(dump, facs=(), **series):
    model = convert.grmhd_model_from_arrays("HARM3D", "cpu", dump=dump)
    return _series(model, facs, **series) if facs else model


@pytest.fixture(scope="module")
def dump():
    return gd.harm3d_dump(32, 24, 16, seed=11)


def test_slow_light_matches_jax_on_a_two_slice_series(dump):
    jmodel, tmodel = both("HARM3D", dump)
    for m in (jmodel, tmodel):
        _series(m, [1.5], tstep=40.0, toffset=-40.0)
    assert jmodel.nt_slices == tmodel.nt_slices == 2
    ref, ab_ref, _ = jrun(JConfig(**_kw(2)), model=jmodel)
    ours, ab, _ = grtrans_run(GrtransConfig(**_kw(2)), tmodel, device="cpu")
    np.testing.assert_array_equal(ab.numpy(), ab_ref)
    assert ours.shape == ref.shape == (1, 64, 4)
    rel = np.abs(ours.numpy() - ref).sum() / np.abs(ref).sum()
    assert rel <= 1e-8, rel
    # and it is slow light: neither slice alone gives this image
    fast, _, _ = grtrans_run(GrtransConfig(**_kw(1)), _port(dump),
                             device="cpu")
    assert (ours - fast).abs().sum() > 1e-3 * fast.abs().sum()


def test_identical_slices_match_fast_light(dump):
    fast, _, _ = grtrans_run(GrtransConfig(**_kw(1)), _port(dump),
                             device="cpu")
    slow, _, _ = grtrans_run(GrtransConfig(**_kw(3)),
                             _port(dump, [1.0, 1.0], tstep=50.0),
                             device="cpu")
    torch.testing.assert_close(slow, fast, rtol=1e-10,
                               atol=1e-12 * fast.abs().max().item())


def test_slow_light_lags_a_growing_source(dump):
    """Slices at t = -200, -100, 0 M that brighten: at the epoch of the
    newest, slow light sees the past along each ray, so its flux lies
    between the fast-light fluxes of the oldest and the newest slice."""
    slow, _, _ = grtrans_run(
        GrtransConfig(**_kw(3, nt=1, dt=0.0)),
        _port(dump, [1.5, 2.0], tstep=100.0, toffset=-200.0), device="cpu")
    old = _port(dump)
    f_old = grtrans_run(GrtransConfig(**_kw(1)), old, device="cpu")[0]
    new = _port(dump)
    new._store(_scaled({k: new.f[k][0] for k in FIELDS}, 2.0))
    f_new = grtrans_run(GrtransConfig(**_kw(1)), new, device="cpu")[0]
    F = [v[0, :, 0].sum().item() for v in (f_old, slow, f_new)]
    assert torch.isfinite(slow).all()
    assert F[0] < F[1] < F[2], F
    assert (F[2] - F[1]) / F[2] > 1e-4


@pytest.mark.parametrize("chunk", [1, 24, 64])
def test_slow_light_in_pixel_blocks_matches_unchunked(dump, chunk):
    model = _port(dump, [1.5, 2.0], tstep=30.0, toffset=-60.0)
    cfg = GrtransConfig(**_kw(3, nt=2, dt=15.0))
    whole, _, _ = grtrans_run(cfg, model, device="cpu")
    blocks, _, _ = grtrans_run(cfg, model, device="cpu", chunk=chunk)
    assert whole.shape == blocks.shape == (2, 64, 4)
    assert not torch.equal(whole[0], whole[1])       # the epoch moves
    torch.testing.assert_close(blocks, whole, rtol=0.0,
                               atol=1e-12 * whole.abs().max().item())


def test_nload_on_one_slice_or_without_uout_is_fast_light(dump):
    one = _port(dump)
    fast, _, _ = grtrans_run(GrtransConfig(**_kw(1)), one, device="cpu")
    also, _, _ = grtrans_run(GrtransConfig(**_kw(3)), one, device="cpu")
    assert torch.equal(fast, also)


def test_camera_delay_grows_with_impact_parameter():
    cam = tcam.make_camera(A, 0.5, -12.0, 12.0, 0.0, 0.0, 16, 1, device="cpu")
    d = tgeo.camera_delay(A, 0.5, cam.alpha, cam.beta, cam.l, cam.q2, cam.sm,
                          cam.u0, 0.04).numpy()
    assert np.isfinite(d).all() and (d > 0).all()
    order = np.argsort(np.abs(cam.alpha.numpy()))
    rel = d - d.min()
    assert rel[order][-1] > rel[order][0] and rel[order][-1] > 1.0


def _delay_reference(a, mu0, l, q2, sm, u0, uout):
    """Coordinate time from u0 to uout along each ray, independent of the
    port's quadrature: the radial part as scipy quad_vec of
    dt/du = R_t(u) / sqrt(U(u)) in ln u (its 1 / u^2 part integrated
    exactly), the polar part a(l - a(1 - mu^2)) integrated over the Mino
    time lam(uout) = int du / sqrt(U) along mu'' = M'(mu) / 2 (scipy
    DOP853).  Needs U > 0 on [u0, uout]: every ray turns beyond uout."""
    def U(u):
        return (1.0 + (a * a - l * l - q2) * u ** 2
                + 2.0 * ((a - l) ** 2 + q2) * u ** 3 - a * a * q2 * u ** 4)

    assert (U(np.linspace(u0, uout, 1001)[:, None]) > 0.0).all()

    def dt_radial(s):
        u = np.exp(s)
        r = 1.0 / u
        rt = ((r * r + a * a) * (r * r + a * a - a * l)
              / (r * r - 2.0 * r + a * a))
        return (rt / np.sqrt(U(u)) - r * r) * u

    s0, s1 = np.log(u0), np.log(uout)
    rad = integrate.quad_vec(dt_radial, s0, s1, epsabs=1e-7, epsrel=1e-13,
                             norm="max")[0] + 1.0 / u0 - 1.0 / uout
    lam_s = integrate.quad_vec(lambda s: np.exp(s) / np.sqrt(U(np.exp(s))),
                               s0, s1, epsabs=1e-15, epsrel=1e-13,
                               norm="max")[0]
    n = len(l)

    def rhs(tau, y):                    # Mino time lam = tau * lam_s
        mu, dmu = y[:n], y[n:2 * n]
        return np.tile(lam_s, 3) * np.concatenate([
            dmu, (a * a - l * l - q2) * mu - 2.0 * a * a * mu ** 3,
            a * (l - a * (1.0 - mu * mu))])

    m0 = q2 + (a * a - l * l - q2) * mu0 ** 2 - a * a * mu0 ** 4
    y0 = np.concatenate([np.full(n, mu0), sm * np.sqrt(np.maximum(m0, 0.0)),
                         np.zeros(n)])
    sol = integrate.solve_ivp(rhs, (0.0, 1.0), y0, method="DOP853",
                              rtol=1e-13, atol=1e-14)
    return rad + sol.y[2 * n:, -1]


def test_camera_delay_matches_an_independent_integral():
    """Every ray of a 30 M camera with uout = 0.04, the corner rays among
    them: those turn within 1.4 uout of the trace's start (impact
    parameter above 19 M), where grtrans_tpu's delay is short by the
    camera's distance.  Bar: 1e-8 relative (the ln r rule's 8 nodes over
    the ray reach 7.2e-9 at b = 20 M; 5e-9 already on the rays that the
    26 M camera shares with grtrans_tpu)."""
    cam = tcam.make_camera(A, 0.5, -15.0, 15.0, -15.0, 15.0, 24, 24,
                           device="cpu")
    ours = tgeo.camera_delay(A, 0.5, cam.alpha, cam.beta, cam.l, cam.q2,
                             cam.sm, cam.u0, 0.04).numpy()
    ref = _delay_reference(A, 0.5, cam.l.numpy(), cam.q2.numpy(),
                           cam.sm.numpy(), cam.u0, 0.04)
    np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=0.0)
    b = np.hypot(cam.alpha.numpy(), cam.beta.numpy())
    assert (b > 19.0).sum() == 12               # the rays that were short
    assert ours.max() - ours.min() < 1e3


@pytest.mark.parametrize("half", [6.0, 13.0])
def test_camera_delay_matches_jax_up_to_26m(half):
    cam = tcam.make_camera(A, 0.5, -half, half, -half, half, 24, 24,
                           device="cpu")
    ours = tgeo.camera_delay(A, 0.5, cam.alpha, cam.beta, cam.l, cam.q2,
                             cam.sm, cam.u0, 0.04).numpy()
    ref = np.asarray(jgeo.camera_delay(
        A, 0.5, *(jnp.asarray(v.numpy()) for v in (cam.alpha, cam.beta, cam.l,
                                                   cam.q2, cam.sm)),
        cam.u0, 0.04))
    np.testing.assert_allclose(ours, ref, rtol=1e-12)
