"""The POLSYNCHTH coefficients of a ray-integrating render as one CUDA kernel
(ops/render_polsynchth.py, csrc/render_polsynchth.cu) against the torch
code of driver.render_rays that it replaces on the card, its twin.

On the CPU (tier 1): which calls render_rays hands to the kernel and which
to the twin, with the wrapper replaced by a stand-in, and the obs counters
that show it.  On the card (marker `cuda`; no JAX here, so run with
`--noconftest`):

    python -m pytest --noconftest -m cuda tests/test_torch_render_kernel.py -q

kernel against twin on the coefficients that reach the march (j, K and the
mask ok, caught at solvers.observed_stokes) of a 24x24x64 HARM3D frame
whose inputs carry the edge samples of edge_frame(): frame_ok false, a NaN
u, B = 0, theta_e from 1e-4 to 10 (both sides of the 1e-2 split and of the
tanh step at 1), T = 0, a pole-on pixel (kappa1 = kappa2 = 0), k = 0
(knorm = 0), a sample 1e-6 r+ outside the horizon and samples not valid;
in float64 with nvals 4 and 1, with coefindx zeroing, at two frequencies,
and the float32 kernel against the mixed twin; then the 64x64x400 frame
through grtrans_run, image against image.

Bars.  Kernel and twin do the same operations in the same order and the
same type, so they differ where the kernel's build rounds a function
otherwise than torch's kernels (an ulp) or where an order of summation
differs; the rounding then grows through the cancellations of the tetrad
(s2xi, c2xi near B parallel to k) by a few orders at most.  Each column of
j and K is held to COEF_TOL of the column's max|twin| (1e-13 in float64,
1e-5 in float32: ~1e3 times a float64 ulp, ~1e2 times a float32 ulp), the
masks to equality, the image to 1e-12 of max|I| (the march kernel's bar).
"""

import dataclasses
import math

import pytest
import torch

from grtrans_tpu_torch import driver, obs
from grtrans_tpu_torch.integrate import solvers
from grtrans_tpu_torch.ops import render_polsynchth as rp

torch.set_num_threads(1)   # the suite runs in parallel worker processes

COEF_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}   # of max|twin|
IMAGE_TOL = 1e-12                                        # of max|I|


def counted(fn):
    """fn()'s result and the obs counters it moved."""
    before = obs.counters()
    out = fn()
    after = obs.counters()
    after.subtract(before)
    return out, after


def captured_render(cfg, model, device):
    """The positional arguments of render_rays' first call in
    grtrans_run(cfg, model), which runs with the call cut short."""
    from grtrans_tpu_torch.orchestrator import grtrans_run

    class Caught(Exception):
        pass

    seen = []

    def catch(*args, **kwargs):
        seen.append(args)
        raise Caught

    real = driver.render_rays
    driver.render_rays = catch
    try:
        grtrans_run(cfg, model, device=device)
    except Caught:
        pass
    finally:
        driver.render_rays = real
    return seen[0]


# ---- the CPU: which calls take the kernel ---------------------------------

@pytest.fixture(scope="module")
def sariaf_render():
    """render_rays' arguments for a 4x4x16 SARIAF frame on the CPU (the
    cases below replace fields, never write into a tensor)."""
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid.base import load_fluid_model

    cfg = GrtransConfig(fname="SARIAF", ename="POLSYNCHTH", nvals=4,
                        spin=0.9, nn=(4, 4, 16), mumin=0.5, mumax=0.5,
                        fmin=2.3e11, fmax=2.3e11, iname="formal", mbh=4e6,
                        gridvals=(-15.0, 15.0, -15.0, 15.0))
    return captured_render(cfg, load_fluid_model("SARIAF", device="cpu"),
                           "cpu")


@pytest.mark.parametrize("case", ["kernel", "polsynchpl", "gradient",
                                  "debug", "thin_disk", "cpu"])
def test_the_dispatch_and_its_counters(monkeypatch, sariaf_render, case):
    """render_rays hands a POLSYNCHTH ray render on the card to the kernel,
    one launch a frequency and no twin call; POLSYNCHPL, a recorded
    gradient, debug=True, standard=2 and the CPU take the twin, one call.
    The card is stood in for by marking the CPU operands as on it, the
    wrapper by a stand-in that records its call and returns zeros."""
    geo, fv, ei, ename, _, mu0, alpha, beta, a, mbh, sp = sariaf_render
    launched = []

    def stand_in(x, k, valid, u, b, alpha, beta, n, bfield, te, **kw):
        launched.append(kw)
        npix, npts = valid.shape
        return (torch.zeros(npix, npts, 4, dtype=x.dtype),
                torch.zeros(npix, npts, 7, dtype=x.dtype),
                torch.zeros(npix, npts, dtype=torch.bool))

    monkeypatch.setattr(rp, "render_polsynchth", stand_in)
    if case != "cpu":
        monkeypatch.setattr(driver, "_on_card", lambda *ts: True)
    kw = dict(iname="formal", nvals=4)
    if case == "polsynchpl":
        ename = "POLSYNCHPL"
    elif case == "gradient":
        ei = ei._replace(ncgs=ei.ncgs.clone().requires_grad_(True))
    elif case == "debug":
        kw["debug"] = True
    elif case == "thin_disk":
        kw["standard"] = 2
    freqs = [2.3e11, 3.45e11]
    out, c = counted(lambda: driver.render_rays(
        geo, fv, ei, ename, freqs, mu0, alpha, beta, a, mbh, sp, **kw))
    ivals = out[0] if case == "debug" else out
    assert ivals.shape == (2, geo.x.shape[0], 4)
    if case == "kernel":
        assert c["render.kernel.launches"] == 0   # the stand-in counts none
        assert [k["fghz"] for k in launched] == freqs
        assert launched[0] == dict(a=a, mu0=mu0, fghz=freqs[0], mbh=mbh,
                                   coefindx=None, rotate=True, mixed=False)
        assert c["render.twin.calls"] == 0
        assert (ivals == 0).all()
    else:
        assert launched == []
        assert c["render.twin.calls"] == 1
        assert torch.isfinite(ivals).all() and (ivals[..., 0] != 0).any()


# ---- the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _harm3d(dev, nn):
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.testing import grmhd_dump

    cfg = GrtransConfig(
        fname="HARM3D", ename="POLSYNCHTH", nvals=4, spin=0.9375, nn=nn,
        uout=0.04, mbh=4.3e6, mumin=0.5, mumax=0.5, fmin=2.3e11,
        fmax=2.3e11, iname="lsoda", mdotmin=4e13, mdotmax=4e13, gmin=10.0,
        muval=0.25, gridvals=(-15.0, 15.0, -15.0, 15.0))
    model = load_fluid_model("HARM3D", device=dev,
                             dump=grmhd_dump.harm3d_dump(32, 24, 16))
    return cfg, model


def edge_frame(dev):
    """render_rays' arguments for a 24x24x64 HARM3D frame with edge
    samples written in: frame_ok false (u = 0), a NaN u, B = 0 (b and B
    both 0), b = 0 alone (bdotb = 0), theta_e log-spaced over [1e-4, 10]
    along pixel 2, T = 0, k = 0 (knorm = 0), a sample 1e-6 r+ outside the
    horizon, samples not valid, and pixel 0 pole-on (alpha = -a sqrt(1 -
    mu0^2), beta = 0: kappa1 = kappa2 = 0)."""
    geo, fv, ei, ename, freqs, mu0, alpha, beta, a, mbh, sp = \
        captured_render(*_harm3d(dev, (24, 24, 64)), dev)
    x, k, valid = geo.x.clone(), geo.k.clone(), geo.valid.clone()
    u, b = fv.u.clone(), fv.b.clone()
    n, bf, te = ei.ncgs.clone(), ei.bcgs.clone(), ei.tcgs.clone()
    alpha, beta = alpha.clone(), beta.clone()
    alpha[0] = -(a * math.sqrt(1.0 - mu0 * mu0))
    beta[0] = 0.0
    u[1, 3] = 0.0
    u[1, 5, 1] = float("nan")
    b[1, 7] = 0.0
    bf[1, 7] = 0.0
    b[1, 9] = 0.0
    te[2] = torch.logspace(-4.0, 1.0, te.shape[1], dtype=te.dtype,
                           device=dev) * (9.10938188e-28 * 2.99792458e10
                                          ** 2 / 1.38e-16)
    te[3, 2] = 0.0
    k[3, 4] = 0.0
    rh = 1.0 + math.sqrt(1.0 - a * a)
    x[3, 6, 1] = rh * (1.0 + 1e-6)
    valid[4, 10:] = False
    geo = geo._replace(x=x, k=k, valid=valid)
    fv = fv._replace(u=u, b=b)
    ei = ei._replace(ncgs=n, bcgs=bf, tcgs=te)
    return geo, fv, ei, ename, freqs, mu0, alpha, beta, a, mbh, sp


def coefficients(monkeypatch, args, twin, **kw):
    """[(j, K, ok)] a frequency that render_rays hands the march, by the
    kernel or (twin=True) by the torch code, and the counters."""
    seen = []
    march = solvers.observed_stokes

    def catch(lam, j, K, method="formal", mask=None, **more):
        seen.append((j, K, mask))
        return march(lam, j, K, method=method, mask=mask, **more)

    with monkeypatch.context() as m:
        m.setattr(solvers, "observed_stokes", catch)
        if twin:
            m.setattr(driver, "_kernel_takes", lambda *a: False)
        _, c = counted(lambda: driver.render_rays(*args, **kw))
    torch.cuda.synchronize()
    return seen, c


CASES = {"f64": dict(),
         "nvals1": dict(nvals=1),
         "coefindx": dict(coefindx=(1.0, 0.0, 1.0, 0.0, 0.0, 1.0, 1.0)),
         "two_freqs": dict(freqs=[2.3e11, 8.6e11]),
         "mixed": dict(prec="mixed")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_the_twin_on_the_edges(dev, monkeypatch, case):
    opts = dict(CASES[case])
    args = list(edge_frame(dev))
    if "freqs" in opts:
        args[4] = opts.pop("freqs")
    if "coefindx" in opts:
        args[10] = dataclasses.replace(args[10],
                                       coefindx=opts.pop("coefindx"))
    kw = dict(iname="lsoda", nvals=opts.get("nvals", 4),
              prec=opts.get("prec", "f64"))
    kern, c = coefficients(monkeypatch, args, False, **kw)
    twin, ct = coefficients(monkeypatch, args, True, **kw)
    inst = "f32" if kw["prec"] == "mixed" else "f64"
    nfreq = len(args[4])
    assert c["render.kernel.launches"] == nfreq
    assert c[f"render.kernel.launches.{inst}"] == nfreq
    assert c["render.twin.calls"] == 0
    assert ct["render.twin.calls"] == 1 and ct["render.kernel.launches"] == 0
    assert len(kern) == len(twin) == nfreq
    for (jk, Kk, okk), (jt, Kt, okt) in zip(kern, twin):
        assert jk.dtype == jt.dtype and Kk.dtype == Kt.dtype
        assert torch.equal(okk, okt)
        assert not okt[1, 3] and not okt[1, 5] and not okt[3, 4]
        assert not okt[4, 10:].any() and okt.any()
        tol = COEF_TOL[jt.dtype]
        for name, kc, tc in (("j", jk, jt), ("K", Kk, Kt)):
            assert torch.isfinite(kc).all()
            for col in range(tc.shape[-1]):
                ref = tc[..., col].abs().max().item()
                err = (kc[..., col] - tc[..., col]).abs().max().item()
                assert err <= tol * ref, (name, col, err, ref)
            assert (kc[~okk] == 0).all()


@pytest.mark.cuda
def test_the_frame_through_the_kernel_matches_the_twin(dev, monkeypatch):
    """grtrans_run at 64x64x400 lsoda: one kernel launch a render and no
    twin call; the same frame with the twin, within IMAGE_TOL of max|I|."""
    from grtrans_tpu_torch.orchestrator import grtrans_run

    cfg, model = _harm3d(dev, (64, 64, 400))
    (ivals, _, _), c = counted(lambda: grtrans_run(cfg, model, device=dev))
    assert c["render.kernel.launches.f64"] == 1
    assert c["render.twin.calls"] == 0
    monkeypatch.setattr(driver, "_kernel_takes", lambda *a: False)
    (twin, _, _), c = counted(lambda: grtrans_run(cfg, model, device=dev))
    assert c["render.twin.calls"] == 1 and c["render.kernel.launches"] == 0
    ivals, twin = torch.as_tensor(ivals), torch.as_tensor(twin)
    imax = twin[..., 0].abs().max().item()
    assert torch.isfinite(ivals).all() and imax > 0.0
    assert (ivals - twin).abs().max().item() <= IMAGE_TOL * imax
