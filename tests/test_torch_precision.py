"""prec="mixed" in the port against grtrans_tpu's mixed path and against the
port's float64, on the CPU (tests/test_precision.py, which holds
grtrans_tpu's mixed path, is slow-marked; these tests guard the port's in
tier 1).  Each test's docstring gives its bars and the measured values.

The mixed path: the trace's per-point algebra in float32 with float64
landmarks, inversions and running sums (geokerr.trace(prec="mixed")); the
fluid sampled in float32, through a float32 copy of the table where the
model keeps one (FFJET, HARM, the 3-D snapshot stack); the tetrad, the
coefficients and the Stokes march in float32 with the affine parameter in
float64; the image float64.

One rule is the port's own: a plunging ray's last sample lies 1e-6 r+
outside the horizon, where float32 holds r - r+ to a few percent and the
projection onto the fluid frame gives any redshift; the float32 leg leaves
out the samples within ops.render_polsynchth.HOR_F32 = 1e-4 r+ of the
horizon.
grtrans_tpu keeps them, and on the SARIAF render below one pixel then
differs from the float64 image by 1.08e-2 of max|I| (measured, in
grtrans_tpu as in the port without the rule).  So the render tests hold
the port against grtrans_tpu's mixed path with the same rule applied to
its trace's valid mask (_jax_with_horizon_rule), every other stage
grtrans_tpu's own.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grtrans_tpu.config import GrtransConfig as JConfig
from grtrans_tpu.fluid.base import load_fluid_model as jload
from grtrans_tpu.geodesics import camera as jcam
from grtrans_tpu.geodesics import geokerr as jgeo
from grtrans_tpu.integrate import solvers as jsol
from grtrans_tpu.orchestrator import grtrans_run as jrun
from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.fluid.base import load_fluid_model as tload
from grtrans_tpu_torch.geodesics import camera as tcam
from grtrans_tpu_torch.geodesics import geokerr as tgeo
from grtrans_tpu_torch.integrate import solvers as tsol
from grtrans_tpu_torch.ops import quad_gather as qg
from grtrans_tpu_torch.ops import render_polsynchth as rp
from grtrans_tpu_torch.orchestrator import grtrans_run
from grtrans_tpu_torch.testing import grmhd_dump
from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump
from grtrans_tpu_torch.tools.invert import InverseProblem

torch.set_num_threads(1)   # the suite runs in parallel worker processes

IMAGE_BAR = 2e-3           # tests/test_precision.py:31, of max|I|

# tests/test_precision.py's cameras: the flagship camera for the trace,
# its SARIAF / POWERLAW renders shrunk from 12x12 to 8x8 pixels x 64 points
FLAG = (0.998, 0.906, -40.0, 20.0, -20.0, 40.0)
PREC_KW = dict(fname="SARIAF", ename="POLSYNCHTH", nvals=4, spin=0.9,
               standard=1, nn=(8, 8, 64), mbh=4e6, mumin=0.5, mumax=0.5,
               nmu=1, nfreq=2, fmin=1e11, fmax=3e11, iname="formal",
               gridvals=(-12.0, 12.0, -12.0, 12.0),
               fargs=dict(n0=4e7, t0=1.6e11, beta=10.0))
POWERLAW = dict(fname="POWERLAW", ename="POLSYNCHPL", gmin=100.0, gmax=1e5,
                fargs=dict(n0=3e7, t0=6e10, beta=10.0, nnth0=8e4))


def _jax_with_horizon_rule(monkeypatch):
    """grtrans_tpu's mixed trace with the port's near-horizon rule on its
    valid mask (see the module docstring)."""
    trace = jgeo.trace

    def ruled(*args, **kw):
        g = trace(*args, **kw)
        if kw.get("prec") == "mixed":
            a = args[0]
            rh = 1.0 + np.sqrt(1.0 - a * a)
            g = g._replace(valid=g.valid & (g.x[..., 1] - rh
                                            > rp.HOR_F32 * rh))
        return g

    monkeypatch.setattr(jgeo, "trace", ruled)


def _rel(ours, ref, scale):
    return float(np.abs(np.asarray(ours, np.float64)
                        - np.asarray(ref, np.float64)).max() / scale)


def _trace_bars(ours, ref):
    """tests/test_precision.py:33-75's bars of a mixed trace against a
    reference trace on their common valid samples."""
    v = np.asarray(ref.valid) & ours.valid.numpy()
    x, xr = ours.x.double().numpy(), np.asarray(ref.x, np.float64)
    k, kr = ours.k.double().numpy(), np.asarray(ref.k, np.float64)
    kmag = np.linalg.norm(kr, axis=-1, keepdims=True)
    lam, lr = ours.lam.numpy(), np.asarray(ref.lam)
    got = dict(
        r=np.abs((x[..., 1] - xr[..., 1]) / xr[..., 1])[v].max(),
        theta=np.abs(x[..., 2] - xr[..., 2])[v].max(),
        phi=np.percentile(np.abs(x[..., 3] - xr[..., 3])[v], 99.9),
        k=np.percentile((np.abs(k - kr) / kmag)[v], 99.9),
        lam=np.abs(lam - lr)[v].max() / np.abs(lr).max())
    bars = dict(r=1e-6, theta=1e-5, phi=5e-3, k=5e-6, lam=1e-5)
    for key, bar in bars.items():
        assert got[key] < bar, (key, got[key], bar)
    assert (ours.tpm.numpy() == np.asarray(ref.tpm))[v].all()
    assert (ours.tpr.numpy() == np.asarray(ref.tpr))[v].all()
    return got


def _traces(n, npts, coarse):
    a, mu0, *grid = FLAG
    jc = jcam.make_camera(a, mu0, *grid, n, n)
    tc = tcam.make_camera(a, mu0, *grid, n, n, device="cpu")

    def args(c):
        return (c.alpha, c.beta, c.l, c.q2, c.sm, c.u0, npts)

    ours = tgeo.trace(a, mu0, *args(tc), uout=0.01, prec="mixed",
                      coarse=coarse)
    jax32 = jgeo.trace(a, mu0, *args(jc), uout=0.01, prec="mixed",
                       coarse=coarse)
    f64 = tgeo.trace(a, mu0, *args(tc), uout=0.01)
    assert ours.x.dtype == ours.k.dtype == torch.float32
    assert ours.lam.dtype == ours.mino.dtype == torch.float64
    return ours, jax32, f64


def test_mixed_trace_matches_jax_and_f64():
    """The mixed trace at 20x20 x 128 points (coarse 1) on the flagship
    camera, against grtrans_tpu's mixed trace and the port's float64 one:
    r 1e-6 relative, theta 1e-5, phi at p99.9 5e-3, k at p99.9 5e-6 of
    |k|, lam 1e-5 of max|lam|, tpm and tpr equal (tests/test_precision.py
    :33-75).  Measured against grtrans_tpu: r 0, theta 2.4e-7, phi 3.0e-3,
    k 2.4e-7, lam 1.2e-6; against float64: r 8.8e-8, theta 2.6e-6, phi
    2.2e-3, k 6.8e-7, lam 5.8e-7."""
    ours, jax32, f64 = _traces(20, 128, 1)
    _trace_bars(ours, jax32)
    _trace_bars(ours, f64)


def test_mixed_coarse_hermite_trace_matches_jax():
    """coarse=4 at 4x4 pixels x 400 points (the inversions at every 4th
    point, the float32 Hermite fill between; tests/test_geodesics.py:
    192-197's case), same bars.  Measured against grtrans_tpu: r 2.4e-7,
    theta 1.6e-6, phi 2.0e-5, k 8.8e-7, lam 2.2e-6; against float64: r
    1.9e-7, theta 1.2e-6, phi 1.5e-5, k 3.6e-6, lam 2.2e-7."""
    ours, jax32, f64 = _traces(4, 400, 4)
    _trace_bars(ours, jax32)
    _trace_bars(ours, f64)


@pytest.mark.parametrize("case", ["SARIAF", "POWERLAW"])
def test_mixed_analytic_render(case, monkeypatch):
    """tests/test_precision.py:14-22's SARIAF + POLSYNCHTH and POWERLAW +
    POLSYNCHPL renders at 8x8 x 64 x 2 frequencies: the port's mixed image
    is float64, finite, and within 2e-3 of max|I| of the port's float64
    image and of grtrans_tpu's mixed one (with the horizon rule).
    Measured: SARIAF 2.5e-5 and 9.8e-4, POWERLAW 4.7e-6 and 7.0e-6."""
    kw = dict(PREC_KW, **(POWERLAW if case == "POWERLAW" else {}))
    ours, _, _ = grtrans_run(GrtransConfig(prec="mixed", **kw), device="cpu")
    f64, _, _ = grtrans_run(GrtransConfig(**kw), device="cpu")
    _jax_with_horizon_rule(monkeypatch)
    jax32, _, _ = jrun(JConfig(prec="mixed", **kw))
    assert ours.dtype == torch.float64 and torch.isfinite(ours).all()
    scale = f64[..., 0].abs().max().item()
    assert _rel(ours, f64, scale) <= IMAGE_BAR
    assert _rel(ours, jax32, scale) <= IMAGE_BAR


def _count_twin_tables(monkeypatch, name):
    """Record the dtype of every table the plain twin `name` is handed."""
    seen = []
    twin = getattr(qg, name)

    def spy(table, *args):
        seen.append(table.dtype)
        return twin(table, *args)

    monkeypatch.setattr(qg, name, spy)
    return seen


def test_mixed_ffjet_render_through_the_f32_table(tmp_path, monkeypatch):
    """The FFJET flagship camera at 8x8 x 64: three gathers, each of a
    float32 table (FFJet.vals' float32 copy and the POLSYNCHPL cutoff table
    twice; quad_gather's plain twin here, the kernel's on the card), the
    image within 2e-3 of max|I| of the port's float64 image and of
    grtrans_tpu's mixed one (which samples its fquad32).  Measured 6.1e-7
    and 4.6e-7."""
    dfile = tmp_path / "ffjet.bin"
    write_ffjet_dump(dfile, nx=32)
    kw = dict(fname="FFJET", ename="POLSYNCHPL", nvals=4, spin=0.998,
              standard=1, nn=(8, 8, 64), uout=0.01, mbh=3.4e9, mumin=0.906,
              mumax=0.906, nfreq=1, fmin=3.45e11, fmax=3.45e11,
              gridvals=(-40.0, 20.0, -20.0, 40.0), iname="formal",
              fargs=dict(dfile=str(dfile), ntscl=2.0, nrscl=70.0))
    f64, _, _ = grtrans_run(GrtransConfig(**kw), device="cpu")
    seen = _count_twin_tables(monkeypatch, "quad_gather_ref")
    ours, _, _ = grtrans_run(GrtransConfig(prec="mixed", **kw), device="cpu")
    assert seen == [torch.float32] * 3
    _jax_with_horizon_rule(monkeypatch)
    jax32, _, _ = jrun(JConfig(prec="mixed", **kw))
    assert ours.dtype == torch.float64 and torch.isfinite(ours).all()
    scale = f64[..., 0].abs().max().item()
    assert _rel(ours, f64, scale) <= IMAGE_BAR
    assert _rel(ours, jax32, scale) <= IMAGE_BAR


def test_mixed_harm3d_render_through_the_f32_rows(monkeypatch):
    """A HARM3D snapshot (16x12x8 synthetic dump) at 8x8 x 64: the sample
    is one quad_gather_rows call on the float32 stack (the plain twin on
    the CPU, the float32 kernel on the card), the image within 2e-3 of
    max|I| of the port's float64 image and of grtrans_tpu's mixed one.
    Measured 2.1e-6 and 6.5e-7."""
    dump = grmhd_dump.harm3d_dump(16, 12, 8)
    kw = dict(fname="HARM3D", ename="POLSYNCHTH", nvals=4,
              spin=grmhd_dump.A, standard=1, nn=(8, 8, 64), uout=0.04,
              mbh=4.3e6, mumin=0.5, mumax=0.5, nfreq=1, fmin=2.3e11,
              fmax=2.3e11, iname="formal", mdotmin=4e13, mdotmax=4e13,
              gmin=10.0, muval=0.25, gridvals=(-15.0, 15.0, -15.0, 15.0))
    model = tload("HARM3D", device="cpu", dump=dump)
    f64, _, _ = grtrans_run(GrtransConfig(**kw), model, device="cpu")
    seen = _count_twin_tables(monkeypatch, "quad_gather_rows_ref")
    ours, _, _ = grtrans_run(GrtransConfig(prec="mixed", **kw), model,
                             device="cpu")
    assert seen == [torch.float32]
    _jax_with_horizon_rule(monkeypatch)
    jax32, _, _ = jrun(JConfig(prec="mixed", **kw),
                       jload("HARM3D", dump=dump))
    assert ours.dtype == torch.float64 and torch.isfinite(ours).all()
    scale = f64[..., 0].abs().max().item()
    assert _rel(ours, f64, scale) <= IMAGE_BAR
    assert _rel(ours, jax32, scale) <= IMAGE_BAR


def test_calc_O_forms_the_faraday_phase_in_f64():
    """_calc_O(dx64=) on 4096 seeded rotation-thick float32 cells (aI 1e-3
    .. 1e-1, |a_pol| <= aI / 2, |rho| 1 .. 1e3, dlam 1 .. 100: phases up
    to 8.7e4 rad): its O is within 5e-3 of the float64 matricant on the
    same cells, the port's and grtrans_tpu's (measured 2.5e-3 and 2.5e-3;
    float32's lam2 carries 1.2e-7 of the phase, 1e-2 at 8.7e4 rad), while
    the float32 phase without dx64 is O(1) off (measured 0.91).
    grtrans_tpu's own float32 _calc_O(dx64=) is 1.77 off there (measured):
    its small eigenvalue, which cancels when |rho| >> |a| (ROADMAP, known
    faults of the reference), is noise in float32."""
    rng = np.random.default_rng(0)
    n = 4096

    def unit():
        v = rng.standard_normal((n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    aI = 10 ** rng.uniform(-3, -1, n)
    apol = (aI * rng.uniform(0, 0.5, n))[:, None] * unit()
    rho = (10 ** rng.uniform(0, 3, n))[:, None] * unit()
    dx64 = 10 ** rng.uniform(0, 2, n)
    a32 = np.concatenate([aI[:, None], apol], 1).astype(np.float32)
    r32 = rho.astype(np.float32)
    ta = tuple(torch.from_numpy(a32[:, i]) for i in range(4))
    tr = tuple(torch.from_numpy(r32[:, i]) for i in range(3))
    dx = torch.from_numpy(dx64)
    ours = tsol._calc_O(ta, tr, dx.float(), dx).double().numpy()
    plain = tsol._calc_O(ta, tr, dx.float()).double().numpy()
    f64 = tsol._calc_O(tuple(c.double() for c in ta),
                       tuple(c.double() for c in tr), dx).numpy()
    jax64 = np.asarray(jsol._calc_O(
        tuple(jnp.asarray(a32[:, i], jnp.float64) for i in range(4)),
        tuple(jnp.asarray(r32[:, i], jnp.float64) for i in range(3)),
        jnp.asarray(dx64)))
    assert np.isfinite(ours).all()
    assert np.abs(ours - f64).max() <= 5e-3
    assert np.abs(ours - jax64).max() <= 5e-3
    assert np.abs(plain - f64).max() > 0.1


def test_mixed_inverse_problem_gradient(tmp_path, monkeypatch):
    """InverseProblem(prec="mixed") on the FFJET flagship camera at 16x16
    x 64 (spin 0.998, mu0 0.906, rays from uout = 0.01): d(sum|image| /
    (npix 4))/d(spin, mu0) finite and within 1e-2 of the port's float64
    gradient (measured 1.2e-3 and 3.3e-5), the weights' gradient from the
    float32 backward (quad_gather_bwd_w's plain twin handed float32
    tables).  At (0.9, 0.9), fwdbwd_bench's point, the float64 render
    gives a ray's last sample, 1e-6 r+ outside the horizon, 6.8e-2 of
    max|I| of one pixel, which the float32 leg leaves out (the horizon
    rule; grtrans_tpu's float32 gives it a wrong redshift, 6.0e-2), and
    the spin derivative there differs by 12% (measured): not held here."""
    dfile = tmp_path / "ffjet.bin"
    write_ffjet_dump(dfile)
    seen = _count_twin_tables(monkeypatch, "quad_gather_bwd_w_ref")
    grads = {}
    for prec in ("f64", "mixed"):
        prob = InverseProblem(fname="FFJET", ename="POLSYNCHPL",
                              freq=3.45e11, mbh=3.4e9, nn=(16, 16, 64),
                              uout=0.01, gridvals=(-40.0, 20.0, -20.0, 40.0),
                              fixed=dict(dfile=str(dfile)), device="cpu",
                              prec=prec)
        p = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
             for k, v in (("spin", 0.998), ("mu0", 0.906))}
        img = prob.render(p)
        (img.abs().sum() / img.numel()).backward()
        grads[prec] = {k: v.grad.item() for k, v in p.items()}
    assert seen[-3:] == [torch.float32] * 3 and torch.float64 in seen[:3]
    for k, ref in grads["f64"].items():
        got = grads["mixed"][k]
        assert np.isfinite(got) and abs(got - ref) <= 1e-2 * abs(ref), \
            (k, got, ref)
