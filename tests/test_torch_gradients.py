"""Gradients through the port's render, against grtrans_tpu's jax.grad (f64)
and against central differences, on the CPU: the three cases of
tests/test_gradients.py, the march's recompute, and the table samplers'
gradients through the gather Functions.  The Functions themselves
(gradcheck, a table that requires a gradient) and every place where the
spin or the inclination used to pass through Python's math as a float are
in tests/test_torch_autograd.py: this file keeps fewer tests than
tests/test_sharding.py, so that pytest-xdist's load-file scheduling, which
hands out the files with the most tests first, runs it after that long
file and not before it.

The cameras are tests/test_gradients.py's: SARIAF + POLSYNCHTH, 6x6 pixels
x 48 points from the camera's u0, spin 0.9, mu0 0.5.  Those rays cross
Faraday-thick cells, where grtrans_tpu's matricant loses its small
eigenvalue (ROADMAP Queue 3; tests/test_torch_solvers.py) and the port's
does not.  The gradient of a different forward is a different number: the
port's d(flux)/d(n0) is 3e-3, its d(flux)/d(spin) 2%, off grtrans_tpu's as
it is (measured), while each is within 1e-6 of central differences of
its own forward.  So the JAX references are grtrans_tpu's jax.grad with
its _calc_O replaced by the port's matricant written in jnp
(_jax_port_O): every other stage -- trace, fluid, tetrad, coefficients,
march -- is grtrans_tpu's own.  Against it the port's gradients agree to
5e-11 (measured); the bar is 1e-8.  Central differences hold the
matricant's gradient itself: bars of tests/test_gradients.py (1e-2 on the
totals; >= 90% of pixels within 5e-2 per pixel, where near-shadow pixels
cross branches).

The JAX references run eagerly in one module fixture (jit would compile
the reverse pass of the whole render, ~90 s a function on this sandbox's
CPU); eagerly the three take ~100 s on a cold JAX cache, most of it
compiling each operation the first time it runs.
"""

import math

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

from grtrans_tpu import driver as jdriver
from grtrans_tpu.fluid import analytic  # noqa: F401  (registers SARIAF)
from grtrans_tpu.fluid.base import SourceParams as JSP
from grtrans_tpu.fluid.base import load_fluid_model as jload
from grtrans_tpu.geodesics import camera as jcam
from grtrans_tpu.geodesics import geokerr as jgeo
from grtrans_tpu.integrate import solvers as jsol
from grtrans_tpu_torch import driver, obs
from grtrans_tpu_torch.fluid.base import SourceParams, load_fluid_model
from grtrans_tpu_torch.geodesics import camera, geokerr
from grtrans_tpu_torch.integrate import solvers
from grtrans_tpu_torch.ops import quad_gather as qg
from grtrans_tpu_torch.testing import grmhd_dump
from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump
from grtrans_tpu_torch.tools.invert import InverseProblem

torch.set_num_threads(1)   # the suite runs in parallel worker processes

A, MU0, NPTS, MBH = 0.9, 0.5, 48, 4e6
N0, T0 = 4e7, 1.6e11
JAX_RTOL = 1e-8        # the port against jax.grad (measured <= 5e-11)
FD_RTOL = 1e-2         # tests/test_gradients.py's bar on the totals
CPU = torch.device("cpu")


def f64(x):
    return torch.tensor(x, dtype=torch.float64)


# ---------------------------------------------------------------------------
# the port's matricant in jnp (grtrans_tpu_torch/integrate/solvers.py
# _lam12 / _calc_O): the small eigenvalue from lam1 lam2 = |a.rho| and the
# sinh term from expm1

def _jlam12(aq, au, av, rq, ru, rv, eps):
    a2 = aq ** 2 + au ** 2 + av ** 2
    p2 = rq ** 2 + ru ** 2 + rv ** 2
    ap = aq * rq + au * ru + av * rv
    scale = eps ** 1.5 * (a2 + p2) + jsol._TINY
    h = (a2 - p2) / 2.0
    rt = jnp.sqrt(h ** 2 + ap ** 2 + scale * scale)
    big = rt + jnp.abs(h)
    big_sq = big + scale
    small_sq = (ap ** 2 + scale * scale) / jnp.maximum(big, jsol._TINY)
    lam1 = jnp.sqrt(jnp.where(h >= 0.0, big_sq, small_sq))
    lam2 = jnp.sqrt(jnp.where(h >= 0.0, small_sq, big_sq))
    return a2, p2, ap, lam1, lam2


def _jax_port_O(a, rho, dx, dx64=None, with_bad=False):
    """grtrans_tpu_torch's _calc_O, line by line, in jnp."""
    aI = a[0]
    fin = jnp.finfo(jnp.result_type(aI))
    eps = float(fin.eps)
    _, _, _, l1_0, l2_0 = _jlam12(*a[1:], *rho, eps)
    dthr = 10.0 * math.sqrt(eps)
    degen = (l1_0 * jnp.abs(dx) < dthr) & (l2_0 * jnp.abs(dx) < dthr)
    aq = jnp.where(degen, 1.0, a[1])
    au, av = (jnp.where(degen, 0.0, c) for c in a[2:])
    rhoq, rhou, rhov = (jnp.where(degen, 0.0, c) for c in rho)
    a2, p2, ap, lam1, lam2 = _jlam12(aq, au, av, rhoq, rhou, rhov, eps)
    theta = lam1 ** 2 + lam2 ** 2
    ith = 1.0 / jnp.where(theta > jsol._SQRT_TINY, theta, 1.0)
    sig = jnp.sign(ap)
    sig = jnp.where(sig == 0.0, 1.0, sig)
    z = jnp.zeros_like(aI)
    M2 = jsol._m4([
        [z, lam2 * aq - sig * lam1 * rhoq, lam2 * au - sig * lam1 * rhou,
         lam2 * av - sig * lam1 * rhov],
        [lam2 * aq - sig * lam1 * rhoq, z, sig * lam1 * av + lam2 * rhov,
         -sig * lam1 * au - lam2 * rhou],
        [lam2 * au - sig * lam1 * rhou, -sig * lam1 * av - lam2 * rhov, z,
         sig * lam1 * aq + lam2 * rhoq],
        [lam2 * av - sig * lam1 * rhov, sig * lam1 * au + lam2 * rhou,
         -sig * lam1 * aq - lam2 * rhoq, z]])
    M3 = jsol._m4([
        [z, lam1 * aq + sig * lam2 * rhoq, lam1 * au + sig * lam2 * rhou,
         lam1 * av + sig * lam2 * rhov],
        [lam1 * aq + sig * lam2 * rhoq, z, -sig * lam2 * av + lam1 * rhov,
         sig * lam2 * au - lam1 * rhou],
        [lam1 * au + sig * lam2 * rhou, sig * lam2 * av - lam1 * rhov, z,
         -sig * lam2 * aq + lam1 * rhoq],
        [lam1 * av + sig * lam2 * rhov, -sig * lam2 * au + lam1 * rhou,
         sig * lam2 * aq - lam1 * rhoq, z]])
    hp = (a2 + p2) / 2.0
    M4 = jsol._m4([
        [hp, av * rhou - au * rhov, aq * rhov - av * rhoq,
         au * rhoq - aq * rhou],
        [au * rhov - av * rhou, aq * aq + rhoq * rhoq - hp,
         aq * au + rhoq * rhou, av * aq + rhov * rhoq],
        [av * rhoq - aq * rhov, aq * au + rhoq * rhou,
         au * au + rhou * rhou - hp, au * av + rhou * rhov],
        [aq * rhou - au * rhoq, av * aq + rhov * rhoq,
         au * av + rhou * rhov, av * av + rhov * rhov - hp]])
    lo = -0.95 * math.log(float(fin.max))
    arg_p = jnp.clip((lam1 - aI) * dx, lo, 60.0)
    arg_m = jnp.clip(-(lam1 + aI) * dx, lo, 60.0)
    ep = jnp.exp(arg_p)
    ecp = 0.5 * (ep + jnp.exp(arg_m))
    ecm = -0.5 * ep * jnp.expm1(arg_m - arg_p)
    eno = jnp.exp(jnp.clip(-aI * dx, lo, 60.0))
    cs = jnp.cos(lam2 * dx) * eno
    sn = jnp.sin(lam2 * dx) * eno
    eye = jsol._eye4(M2)
    O = (0.5 * (ecp + cs) * eye - (sn * ith) * M2 - (ecm * ith) * M3
         + (ecp - cs) * ith * M4)
    bad = ~(jnp.max(jnp.abs(O), axis=(0, 1)) <= 1.0 + 1e-6)
    need_poly = degen | bad
    Kpoly = jsol._opac_m4(
        (z,) + tuple(jnp.where(need_poly, c, 0.0) for c in a[1:]),
        tuple(jnp.where(need_poly, c, 0.0) for c in rho))
    Znil = Kpoly * dx
    Z2n = jsol._mm(Znil, Znil)
    O_nil = eno * (eye - Znil + Z2n / 2.0 - jsol._mm(Z2n, Znil) / 6.0)
    nil_ok = jnp.max(jnp.abs(O_nil), axis=(0, 1)) <= 1.0 + 1e-6
    O = jnp.where(need_poly, jnp.where(nil_ok, O_nil, eno * eye), O)
    return (O, bad & ~degen) if with_bad else O


# ---------------------------------------------------------------------------
# the render of tests/test_gradients.py in both packages

TCAM = camera.make_camera(A, MU0, -10.0, 10.0, -10.0, 10.0, 6, 6, device=CPU)
JCAM = jcam.make_camera(A, MU0, -10.0, 10.0, -10.0, 10.0, 6, 6)


def port_image(n0=N0, t0=T0, iname="formal", a=A):
    """Stokes I of every pixel; a tensor spin recomputes (l, q2) from it
    (tests/test_gradients.py::test_spin_gradient_through_geodesics)."""
    model = load_fluid_model("SARIAF", device=CPU, n0=n0, t0=t0, beta=10.0)
    if torch.is_tensor(a):
        l, q2 = camera.constants_of_motion(a, MU0, TCAM.alpha, TCAM.beta)
    else:
        l, q2 = TCAM.l, TCAM.q2
    geo = geokerr.trace(a, MU0, TCAM.alpha, TCAM.beta, l, q2, TCAM.sm,
                        TCAM.u0, NPTS)
    fv = model.vals(geo.x, geo.k, a)
    sp = SourceParams(mbh=MBH)
    iv = driver.render_rays(geo, fv, model.convert(fv, sp), "POLSYNCHTH",
                            [2.3e11], MU0, TCAM.alpha, TCAM.beta, a, MBH, sp,
                            iname=iname, nvals=4)
    return iv[0][:, 0]


def jax_image(geo, n0=N0, t0=T0, iname="formal", a=A):
    model = jload("SARIAF", n0=n0, t0=t0, beta=10.0)
    fv = model.vals(geo.x, geo.k, a)
    sp = JSP(mbh=MBH)
    iv = jdriver.render_rays(geo, fv, model.convert(fv, sp), "POLSYNCHTH",
                             [2.3e11], MU0, JCAM.alpha, JCAM.beta, a, MBH,
                             sp, iname=iname, nvals=4)
    return iv[0][:, 0]


def jax_geo(a=A, spin_traced=False):
    if spin_traced:
        l = -JCAM.alpha * jnp.sqrt(1.0 - MU0 * MU0)
        q2 = JCAM.beta ** 2 - (a * a - JCAM.alpha ** 2) * MU0 * MU0
    else:
        l, q2 = JCAM.l, JCAM.q2
    return jgeo.trace(a, MU0, JCAM.alpha, JCAM.beta, l, q2, JCAM.sm,
                      JCAM.u0, NPTS)


def jax_flux_grad(iname, n0, t0):
    """jax.grad of the total Stokes I with respect to (n0, t0, spin), (l, q2)
    recomputed from the spin (tests/test_gradients.py's spin case; its
    (n0, t0) cases take the camera's l and q2, the same numbers to
    rounding)."""
    return np.asarray(jax.grad(lambda p: jnp.sum(jax_image(
        jax_geo(p[2], True), p[0], p[1], iname, a=p[2])))(
            jnp.array([n0, t0, A])))


def port_flux_grad(iname, n0, t0):
    """The port's (n0, t0, spin) gradient of the same total."""
    p = [f64(v).requires_grad_() for v in (n0, t0, A)]
    port_image(*p[:2], iname, a=p[2]).sum().backward()
    return np.array([v.grad.item() for v in p])


@pytest.fixture(scope="module")
def jax_refs():
    """grtrans_tpu's gradients, its matricant the port's (see the module
    docstring).  formal_solve, the jitted function that calls _calc_O,
    drops its compiled programs before and after, so that it traces the
    patched matricant and no other test sees it; the eager operations'
    compiles are kept.  One reverse pass a case gives all three
    derivatives (the second and third cases reuse the first's compiled
    operations)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsol, "_calc_O", _jax_port_O)
        jsol.formal_solve.clear_cache()
        try:
            return {"formal": jax_flux_grad("formal", N0, T0),
                    "delo": jax_flux_grad("delo", N0, T0),
                    "masked": jax_flux_grad("formal", 4e3, 2e10)}
        finally:
            jsol.formal_solve.clear_cache()


def _close(ours, ref, rtol, what):
    err = abs(ours - ref) / abs(ref)
    assert err <= rtol, f"{what}: {ours:.12e} vs {ref:.12e} ({err:.2e})"


@pytest.mark.parametrize("iname", ["formal", "delo"])
def test_flagship_param_grads_match_jax_and_fd(jax_refs, iname):
    """d(flux)/d(n0), d(flux)/d(t0) (and d/d(spin)) for both polarized
    solvers: jax.grad at 1e-8, central differences in n0 and t0 (h = 1e-4
    of the value, as in tests/test_gradients.py) at 1e-2."""
    ad = port_flux_grad(iname, N0, T0)
    assert np.isfinite(ad).all()
    for k, key in enumerate(("n0", "t0", "spin")):
        _close(ad[k], float(jax_refs[iname][k]), JAX_RTOL,
               f"{iname} d/d{key}")
    for k, (key, base) in enumerate((("n0", N0), ("t0", T0))):
        h = base * 1e-4
        with torch.no_grad():
            fd = (port_image(iname=iname, **{key: base + h}).sum()
                  - port_image(iname=iname, **{key: base - h}).sum()
                  ).item() / (2 * h)
        _close(ad[k], fd, FD_RTOL, f"{iname} d/d{key} vs FD")


def test_spin_gradient_through_geodesics(jax_refs):
    """d(flux)/d(spin) through the trace with (l, q2) recomputed from the
    spin: the total against jax.grad at 1e-8; every pixel's derivative
    (one forward-mode pass) summing to the reverse-mode total (1e-10) and
    against central differences (h = 2e-4) on >= 90% of the pixels within
    5e-2, as tests/test_gradients.py; the total against central
    differences at h = 1e-5, inside the branches that a wider step
    straddles (at h = 2e-4 the secant of the total has the wrong sign,
    measured).  grtrans_tpu's per-pixel jax.jacfwd is left out for its
    time: on a cold JAX cache it took 34 s more."""
    with fwAD.dual_level():
        image = port_image(a=fwAD.make_dual(f64(A), f64(1.0)))
        ad = fwAD.unpack_dual(image).tangent.numpy()
    assert np.isfinite(ad).all()
    total = port_flux_grad("formal", N0, T0)[2]
    _close(total, float(jax_refs["formal"][2]), JAX_RTOL,
           "d(flux)/d(spin)")
    _close(ad.sum(), total, 1e-10, "forward mode against reverse mode")
    with torch.no_grad():
        h = 2e-4
        fd = ((port_image(a=f64(A + h)) - port_image(a=f64(A - h)))
              .numpy() / (2 * h))
        hs = 1e-5
        fd_tot = (port_image(a=f64(A + hs)).sum()
                  - port_image(a=f64(A - hs)).sum()).item() / (2 * hs)
    rel = np.abs(ad - fd) / (np.maximum(np.abs(ad), np.abs(fd))
                             + 1e-3 * np.abs(fd).max())
    assert (rel < 5e-2).mean() >= 0.9, np.sort(rel)[-3:]
    _close(total, fd_tot, FD_RTOL, "d(flux)/d(spin) vs FD")


def test_grad_finite_with_masked_cells(jax_refs):
    """Most cells emit ~nothing at a tiny density and temperature: the
    gradient stays finite and equals jax.grad's."""
    ad = port_flux_grad("formal", 4e3, 2e10)
    assert np.isfinite(ad).all()
    for k, key in enumerate(("n0", "t0", "spin")):
        _close(ad[k], float(jax_refs["masked"][k]), JAX_RTOL,
               f"masked d/d{key}")


def test_march_recompute_leaves_the_gradient_unchanged(monkeypatch):
    """The march's per-block checkpoint (recompute in the backward pass)
    gives the gradient of the plain march bitwise."""
    def grads():
        n0 = f64(N0).requires_grad_()
        port_image(n0, iname="delo").sum().backward()
        return n0.grad.item()

    with_recompute = grads()
    march = solvers._march
    monkeypatch.setattr(solvers, "_march", lambda *args: march(
        *args[:4], False))
    assert grads() == with_recompute


STEPS = {"spin": 1e-4, "mu0": 1e-5}


def test_gradients_flow_through_the_table_samplers(tmp_path):
    """The FFJET flagship through InverseProblem (quad_gather in FFJet.vals
    and in POLSYNCHPL's cutoff table) and a HARM3D snapshot
    (quad_gather_rows), both at 8x8 x 32: d(loss)/d(spin, mu0) (the
    snapshot: mu0, a geometry-only fit) against central differences at
    1e-2, every backward through the weights' backward of the Function.  Steps: spin 1e-4, mu0 1e-5.  The loss
    moves by 1e-3 of itself per unit spin, so below h = 1e-5 the secant
    is the render's rounding (measured: FFJET's spin secant 3.22e-6 at
    1e-5, 2.45e-6 at 1e-6, 3.17e-6 at 1e-4 and 1e-3, against 3.17e-6)."""
    path = tmp_path / "ffjet.bin"
    write_ffjet_dump(path, nx=32)
    ffjet = InverseProblem(fname="FFJET", ename="POLSYNCHPL", freq=3.45e11,
                           mbh=3.4e9, nn=(8, 8, 32),
                           gridvals=(-40.0, 20.0, -20.0, 40.0),
                           fixed=dict(dfile=str(path), ntscl=2.0,
                                      nrscl=70.0), device="cpu")
    harm3d = InverseProblem(fname="HARM3D", ename="POLSYNCHTH", mbh=4.3e6,
                            nn=(8, 8, 32), uout=0.04,
                            gridvals=(-15.0, 15.0, -15.0, 15.0),
                            fixed=dict(dump=grmhd_dump.harm3d_dump(16, 12, 8)),
                            source=dict(mdot=4e13, mu=0.25, gmin=10.0),
                            device="cpu")
    for prob, spin, bwd in ((ffjet, 0.9, qg.quad_gather_bwd_w_ref),
                            (harm3d, grmhd_dump.A,
                             qg.quad_gather_rows_bwd_w_ref)):
        def loss(p):
            return prob.render(p).abs().sum()

        p = {"spin": f64(spin).requires_grad_(),
             "mu0": f64(0.6).requires_grad_()}
        if prob is harm3d:
            # the snapshot holds one spin: its gradient is mu0's alone
            p = {"spin": f64(spin), "mu0": p["mu0"]}
        before = obs.counters()[f"{bwd.__name__}.calls"]
        loss(p).backward()
        assert obs.counters()[f"{bwd.__name__}.calls"] > before
        for k, v in p.items():
            if not v.requires_grad:
                continue
            h = STEPS[k]
            q = {kk: vv.detach() for kk, vv in p.items()}
            with torch.no_grad():
                fd = (loss(dict(q, **{k: q[k] + h}))
                      - loss(dict(q, **{k: q[k] - h}))).item() / (2 * h)
            _close(v.grad.item(), fd, FD_RTOL, f"{prob.fname} d/d{k}")
