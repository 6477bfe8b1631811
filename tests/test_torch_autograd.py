"""The port's autograd pieces on the CPU: torch.autograd.gradcheck of the
gather Functions of ops/quad_gather.py in their weights (through the plain
twins), the refusal of a table that requires a gradient, and every place
where the spin or the inclination used to pass through Python's math as a
float, each held against jax.grad of grtrans_tpu's function (1e-10 of the
largest entry; the trace 2e-6, as its positions differ so between jitted
and eager grtrans_tpu, tests/test_torch_geodesics.py).  The gradients
through the render are in tests/test_torch_gradients.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grtrans_tpu.fluid import analytic as janalytic
from grtrans_tpu.geodesics import camera as jcam
from grtrans_tpu.geodesics import geokerr as jgeo
from grtrans_tpu.geometry import kerr as jkerr
from grtrans_tpu.geometry import tetrad as jtetrad
from grtrans_tpu_torch import obs
from grtrans_tpu_torch.fluid import analytic
from grtrans_tpu_torch.geodesics import camera, geokerr
from grtrans_tpu_torch.geometry import kerr, tetrad
from grtrans_tpu_torch.ops import quad_gather as qg

torch.set_num_threads(1)   # the suite runs in parallel worker processes

A, MU0, NPTS = 0.9, 0.5, 48
CPU = torch.device("cpu")
# tests/test_gradients.py's camera
TCAM = camera.make_camera(A, MU0, -10.0, 10.0, -10.0, 10.0, 6, 6, device=CPU)
JCAM = jcam.make_camera(A, MU0, -10.0, 10.0, -10.0, 10.0, 6, 6)


def f64(x):
    return torch.tensor(x, dtype=torch.float64)


# the gather Functions

def _gather_inputs(nc, nf, rows=None, n=37, ns=11, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)))
    shape = (n,) if rows is None else (n, rows)
    idx = torch.as_tensor(rng.integers(0, ns, shape), dtype=torch.int32)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, shape + (nc,)))
    return table, idx, w


@pytest.mark.parametrize("nc,nf", [(4, 9), (2, 6), (4, 6), (4, 10), (2, 101)])
def test_quad_gather_gradcheck(nc, nf):
    """torch.autograd.gradcheck of quad_gather in w (the plain twins on the
    CPU): FFJET, POLSYNCHPL and its per-sample p, HARM, PHATDISK."""
    table, idx, w = _gather_inputs(nc, nf)
    w.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda w: qg.quad_gather(table, idx, w, nc, nf), (w,))
    before = obs.counters()["quad_gather_bwd_w_ref.calls"]
    qg.quad_gather(table, idx, w, nc, nf).sum().backward()
    assert obs.counters()["quad_gather_bwd_w_ref.calls"] == before + 1


@pytest.mark.parametrize("r,nc,nf", [(4, 2, 10), (8, 2, 10), (1, 1, 10),
                                     (8, 1, 6)])
def test_quad_gather_rows_gradcheck(r, nc, nf):
    """gradcheck of quad_gather_rows in w: the snapshot (R = 4), slow light
    (R = 8), HARMPI (R = 1), KORAL's bins (R = 8 of 1 x 6)."""
    table, idx, w = _gather_inputs(nc, nf, rows=r)
    w.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda w: qg.quad_gather_rows(table, idx, w, nc, nf), (w,))
    g = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (idx.shape[0], nf)))
    dw = qg.quad_gather_rows_bwd_w(table, idx, g, nc, nf)
    ref = (table[idx.long()].view(*idx.shape, nc, nf) * g[:, None, None]
           ).sum(-1)
    assert dw.shape == (*idx.shape, nc)
    torch.testing.assert_close(dw, ref, rtol=1e-14, atol=0.0)


@pytest.mark.parametrize("rows", [None, 4])
def test_a_table_that_requires_grad_raises(rows):
    """The table gradient is not written: asking for it raises instead of
    returning None; under no_grad the call is a plain gather."""
    table, idx, w = _gather_inputs(2, 10, rows=rows)
    table.requires_grad_()
    fn = qg.quad_gather if rows is None else qg.quad_gather_rows
    with pytest.raises(NotImplementedError, match="table"):
        fn(table, idx, w, 2, 10)
    with torch.no_grad():
        assert fn(table, idx, w, 2, 10).shape == (idx.shape[0], 10)


# every place the spin or mu0 passed through math as a float

def _sites():
    """(name, port function of (a, mu0), grtrans_tpu's) returning a
    scalar, on arrays of the shape of a render of TCAM (pixels x
    points)."""
    n, m = TCAM.alpha.shape[0], NPTS
    grid = np.meshgrid(np.linspace(0.0, 1.0, n), np.linspace(0.0, 1.0, m),
                       indexing="ij")
    R, TH = 2.5 + 30.0 * grid[0] * grid[1], 0.3 + 2.5 * grid[1]
    r, th = torch.as_tensor(R), torch.as_tensor(TH)
    jr, jth = jnp.asarray(R), jnp.asarray(TH)

    def vec(v):
        return np.broadcast_to(np.asarray(v), (n, m, 4)).copy()

    u, b, k = (torch.as_tensor(vec(v)) for v in (
        [1.2, 0.1, 0.01, 0.05], [0.0, 0.3, 0.2, 0.4],
        [1.0, -0.8, 0.05, 0.02]))
    ju, jbv, jk = (jnp.asarray(x.numpy()) for x in (u, b, k))
    al, be = TCAM.alpha, TCAM.beta
    ja, jb = JCAM.alpha, JCAM.beta
    sm, jsm = TCAM.sm, JCAM.sm
    x4 = torch.stack([torch.zeros_like(r), r, th, torch.zeros_like(r)], -1)
    jx4 = jnp.stack([jnp.zeros_like(jr), jr, jth, jnp.zeros_like(jr)], -1)
    disk = analytic.ThinDisk(a=A, device=CPU)
    jdisk = janalytic.ThinDisk(a=A)
    return {
        "horizon": (lambda a, m: kerr.horizon(a),
                    lambda a, m: jkerr.horizon(a)),
        "metric_cov (_delta)": (
            lambda a, m: kerr.metric_cov(r, th, a).sum(),
            lambda a, m: jkerr.metric_cov(jr, jth, a).sum()),
        "bl2ks_time": (lambda a, m: kerr.bl2ks_time(r, r, a).sum(),
                       lambda a, m: jkerr.bl2ks_time(jr, jr, a).sum()),
        "bl2ks_phi": (lambda a, m: kerr.bl2ks_phi(r, th, a).sum(),
                      lambda a, m: jkerr.bl2ks_phi(jr, jth, a).sum()),
        "calc_rms": (lambda a, m: kerr.calc_rms(a),
                     lambda a, m: jkerr.calc_rms(a)),
        "calc_rms_constants": (
            lambda a, m: sum(kerr.calc_rms_constants(a)),
            lambda a, m: sum(jkerr.calc_rms_constants(a))),
        "krolikc": (lambda a, m: kerr.krolikc(r + 3.0, a).sum(),
                    lambda a, m: jkerr.krolikc(jr + 3.0, a).sum()),
        "tetrad kap1 (mu0)": (
            lambda a, m: sum(t.sum() for t in tetrad.comoving_ortho(
                r, th, a, al[:, None], be[:, None], m, u, b, k)[:5]),
            lambda a, m: sum(t.sum() for t in jtetrad.comoving_ortho(
                jr, jth, a, ja[:, None], jb[:, None], m, ju, jbv, jk)[:5])),
        "thindisk rin": (lambda a, m: disk.vals(x4, k, a).rho.sum(),
                         lambda a, m: jdisk.vals(jx4, jk, a).rho.sum()),
        "constants_of_motion": (
            lambda a, m: sum(c.sum() for c in camera.constants_of_motion(
                a, m, al, be)),
            lambda a, m: jnp.sum(-ja * jnp.sqrt(1.0 - m * m))
            + jnp.sum(jb ** 2 + (ja ** 2 - a * a) * m * m)),
        "trace (horizon, mu0)": (
            lambda a, m: geokerr.trace(a, m, al, be, *camera
                                       .constants_of_motion(a, m, al, be),
                                       sm, TCAM.u0, NPTS).x[..., 1:3].sum(),
            lambda a, m: jgeo.trace(a, m, ja, jb, -ja * jnp.sqrt(1 - m * m),
                                    jb ** 2 + (ja ** 2 - a * a) * m * m,
                                    jsm, JCAM.u0, NPTS).x[..., 1:3].sum()),
    }


SITES = _sites()
# the trace's positions themselves differ from grtrans_tpu's by up to 2e-6
# of their size near turning points, as jitted grtrans_tpu differs from
# eager (tests/test_torch_geodesics.py); their gradient here by 2.7e-7
# (measured)
SITE_RTOL = {"trace (horizon, mu0)": 2e-6}


@pytest.mark.parametrize("site", sorted(SITES))
def test_a_tensor_spin_or_mu0_keeps_its_gradient(site):
    """With a 0-d tensor spin and mu0 the result carries a grad_fn, and its
    gradient equals jax.grad of grtrans_tpu's function (1e-10 of the
    largest entry; the trace SITE_RTOL); with floats the value is the
    same."""
    ours, ref = SITES[site]
    a, m = f64(A).requires_grad_(), f64(MU0).requires_grad_()
    out = ours(a, m)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (a, m), allow_unused=True)
    got = np.array([0.0 if g is None else g.item() for g in got])
    want = np.array(jax.grad(ref, argnums=(0, 1))(A, MU0))
    scale = np.abs(want).max()
    bar = SITE_RTOL.get(site, 1e-10)
    assert scale > 0 and np.abs(got - want).max() <= bar * scale, \
        (got, want)
    assert float(ours(A, MU0)) == pytest.approx(out.item(), rel=1e-14)
