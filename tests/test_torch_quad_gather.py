"""Parity of the port's packed-row gather (grtrans_tpu_torch.ops.quad_gather)
with the Pallas kernel it replaces, run in interpret mode, and with the
XLA gather + combine of grtrans_tpu.  The CUDA kernel behind the wrapper
is held against the plain version on the card in test_torch_cuda.py.

Tolerances: rows exact; combined values max|d| <= tol * max|ref| with
tol 1e-14 (float64) / 1e-6 (float32) -- the corner sums may round in
another order; the same for the weights' gradients, sums over the fields.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from grtrans_tpu.emis import polsynchpl as jpl
from grtrans_tpu.ops.pallas_gather import (quad_combine, vmem_row_gather,
                                           xla_quad_gather)
from grtrans_tpu_torch import obs
from grtrans_tpu_torch.emis import polsynchpl as tpl
from grtrans_tpu_torch.ops import quad_gather as qgm
from grtrans_tpu_torch.ops.quad_gather import (quad_gather,
                                               quad_gather_bwd_w,
                                               quad_gather_ref,
                                               quad_gather_rows,
                                               quad_gather_rows_ref)

torch.set_num_threads(1)   # the suite runs in parallel worker processes

NS, NC, NF, N = 16384, 4, 9, 4096
TOL = {np.float32: 1e-6, np.float64: 1e-14}


def _inputs(dtype, n=N, nc=NC, nf=NF, ns=NS, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((ns, nc * nf)).astype(dtype)
    idx = rng.integers(0, ns, n).astype(np.int32)
    w = rng.uniform(0.0, 1.0, (n, nc)).astype(dtype)
    return table, idx, w


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rows_match_pallas_interpret(dtype):
    table, idx, w = _inputs(dtype)
    rows_j = np.asarray(vmem_row_gather(jnp.asarray(table), jnp.asarray(idx),
                                        interpret=True))
    ones = torch.ones((N, 1), dtype=torch.from_numpy(table).dtype)
    rows_t = quad_gather_ref(torch.from_numpy(table), torch.from_numpy(idx),
                             ones, 1, NC * NF)
    np.testing.assert_array_equal(rows_t.numpy(), rows_j)
    np.testing.assert_array_equal(rows_j, table[idx])

    out_t = quad_gather(torch.from_numpy(table), torch.from_numpy(idx),
                        torch.from_numpy(w), NC, NF).numpy()
    _close(out_t, quad_combine(jnp.asarray(rows_j), jnp.asarray(w), NF),
           TOL[dtype])
    _close(out_t, xla_quad_gather(jnp.asarray(table), jnp.asarray(idx),
                                  jnp.asarray(w), NF), TOL[dtype])


def test_ragged_n_matches_numpy():
    table, idx, w = _inputs(np.float64, n=4099, seed=1)
    out = quad_gather(torch.from_numpy(table), torch.from_numpy(idx),
                      torch.from_numpy(w), NC, NF).numpy()
    ref = np.einsum("nc,ncf->nf", w, table[idx].reshape(-1, NC, NF))
    _close(out, ref, 1e-14)


def test_g_all_shape_matches_jax_blend():
    """The _g_all use: C=2 bracketing rows x nf=6 tables."""
    table, idx, _ = _inputs(np.float64, n=N, nc=2, nf=6, ns=201, seed=2)
    wx = np.random.default_rng(3).uniform(0.0, 1.0, N)
    out = quad_gather(torch.from_numpy(table), torch.from_numpy(idx),
                      torch.from_numpy(np.stack([1 - wx, wx], -1)), 2, 6)
    q = jnp.asarray(table)[jnp.asarray(idx)]
    ref = q[:, :6] * (1 - wx)[:, None] + q[:, 6:] * wx[:, None]
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("p", [3.5, 2.2])
def test_g_all_matches_jax(p):
    x = 10.0 ** np.random.default_rng(4).uniform(-9.0, 4.0, (32, 20))
    ref = np.asarray(jpl._g_all(jnp.asarray(x), p))
    out = tpl._g_all(torch.from_numpy(x), p).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("nc,nf", [(4, 9), (2, 6), (3, 5), (2, 101)])
def test_kernel_choice_does_not_change_the_cpu_result(nc, nf):
    """The kernels are the card's choice alone: on the CPU the tiled
    shapes, the wide-row shape and any other go to the plain twin, one call
    of it a wrapper call, and equal the einsum."""
    table, idx, w = _inputs(np.float64, n=257, nc=nc, nf=nf, ns=300, seed=5)
    args = (torch.from_numpy(table), torch.from_numpy(idx),
            torch.from_numpy(w), nc, nf)
    before = obs.counters()["quad_gather_ref.calls"]
    out = quad_gather(*args)
    assert obs.counters()["quad_gather_ref.calls"] == before + 1
    ref = np.einsum("nc,ncf->nf", w, table[idx].reshape(-1, nc, nf))
    _close(out.numpy(), ref, 1e-14)


def test_wrapper_rejects_bad_arguments():
    table, idx, w = (torch.from_numpy(v) for v in _inputs(np.float64, n=8))
    with pytest.raises(TypeError):
        quad_gather(table, idx.long(), w, NC, NF)
    with pytest.raises(ValueError):
        quad_gather(table, idx, w.float(), NC, NF)
    with pytest.raises(ValueError):
        quad_gather(table, idx, w, 2, 6)
    with pytest.raises(ValueError):
        quad_gather(table[:, ::2], idx, w[:, :2], 2, 9)
    with pytest.raises(NotImplementedError):
        quad_gather(table.to("meta"), idx.to("meta"), w.to("meta"), NC, NF)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_one_row_of_quad_gather_rows_is_quad_gather(dtype):
    """R = 1 of the multi-row gather is quad_gather, and so the Pallas
    kernel's rows combined by quad_combine."""
    table, idx, w = _inputs(dtype, n=1024)
    args = [torch.from_numpy(v) for v in (table, idx[:, None], w[:, None])]
    out = quad_gather_rows(*args, NC, NF)
    assert torch.equal(out, quad_gather(torch.from_numpy(table),
                                        torch.from_numpy(idx),
                                        torch.from_numpy(w), NC, NF))
    assert torch.equal(out, quad_gather_rows_ref(*args, NC, NF))
    rows = vmem_row_gather(jnp.asarray(table), jnp.asarray(idx),
                           interpret=True)
    _close(out.numpy(), quad_combine(rows, jnp.asarray(w), NF), TOL[dtype])


@pytest.mark.parametrize("r", [4, 8])
def test_quad_gather_rows_matches_xla_gathers(r):
    """R rows a query against R fused XLA gather + combines, summed."""
    rng = np.random.default_rng(6)
    table = rng.standard_normal((700, 4 * 10))
    idx = rng.integers(0, 700, (513, r)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, (513, r, 4))
    out = quad_gather_rows(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(w), 4, 10).numpy()
    ref = sum(xla_quad_gather(jnp.asarray(table), jnp.asarray(idx[:, i]),
                              jnp.asarray(w[:, i]), 10) for i in range(r))
    _close(out, ref, 1e-14)


# (nc, nf) of every quad_gather caller and the kernel each gets on the card
GATHER_SHAPES = {"ffjet": ((4, 9), "tiled"), "polsynchpl": ((2, 6), "tiled"),
                 "polsynchpl_p": ((4, 6), "tiled"), "harm": ((4, 10), "tiled"),
                 "koral": ((4, 11), "tiled"), "sphacc": ((2, 2), "tiled"),
                 "numdisk": ((4, 1), "tiled"), "phatdisk": ((2, 101), "wide"),
                 "other": ((3, 5), "generic")}
# (R, nc, nf, itemsize) of every quad_gather_rows caller
ROWS_SHAPES = {
    "harm3d_f64": ((4, 2, 10, 8), "tiled"),
    "harm3d_f32": ((4, 2, 10, 4), "tiled"),
    "slowlight_f64": ((8, 2, 10, 8), "tiled"),
    "koral3d_f64": ((4, 2, 11, 8), "tiled"),
    "koral3d_f32": ((4, 2, 11, 4), "simple"),
    "bins3d_f64": ((8, 1, 6, 8), "simple"),
    "bins3d_f32": ((8, 1, 6, 4), "simple"),
    "bins2d_f64": ((4, 1, 6, 8), "simple"),
    "bins_odd_f64": ((8, 1, 3, 8), "simple"),
    "harmpi_f64": ((1, 1, 10, 8), "tiled"),
    "harmpi_kel_f64": ((1, 1, 13, 8), "simple"),
    "wide_rows_f64": ((1, 1, 40, 8), "simple"),
    "runtime_shape": ((3, 2, 5, 8), "simple"),
}


@pytest.mark.parametrize("name", sorted(GATHER_SHAPES))
def test_gather_kernel_choice(name):
    """The shape rule of quad_gather on the card: the tiled kernel for the
    narrow shapes in use when its 16-byte operands are aligned, the
    wide-row kernel for nf >= 32, the generic one otherwise."""
    (nc, nf), kernel = GATHER_SHAPES[name]
    assert qgm.gather_kernel(nc, nf, aligned=True) == kernel
    assert qgm.gather_kernel(nc, nf, aligned=False) == \
        ("wide" if kernel == "wide" else "generic")


@pytest.mark.parametrize("name", sorted(ROWS_SHAPES))
def test_rows_kernel_choice(name):
    """The shape rule of quad_gather_rows on the card: the bulk-copy
    kernel where a row is a whole number of 16-byte pieces (of at most 256
    bytes) of an aligned table and (R, nc) is instantiated (not the binned
    populations); the simple one otherwise."""
    (r, nc, nf, itemsize), kernel = ROWS_SHAPES[name]
    assert qgm.rows_kernel(r, nc, nf, itemsize, True) == kernel
    assert qgm.rows_kernel(r, nc, nf, itemsize, False) == "simple"


@pytest.mark.parametrize("name", sorted(GATHER_SHAPES))
def test_bwd_kernel_choice(name):
    """The shape rule of quad_gather_bwd_w on the card: the tiled kernel
    (the forward's tile pipeline) for the tiled forward's shapes when
    table, g and dw are aligned, the first design ("generic") otherwise;
    no wide-row backward."""
    (nc, nf), kernel = GATHER_SHAPES[name]
    want = "tiled" if kernel == "tiled" else "generic"
    assert qgm.bwd_kernel(nc, nf, aligned=True) == want
    assert qgm.bwd_kernel(nc, nf, aligned=False) == "generic"


@pytest.mark.parametrize("name", sorted(ROWS_SHAPES))
def test_rows_bwd_kernel_choice(name):
    """The shape rule of quad_gather_rows_bwd_w on the card: the forward's
    row rule (the bulk-copy pipeline where (R, nc) is instantiated and a
    row is whole 16-byte pieces of at most 256 bytes, table and g
    aligned), the first design ("simple") otherwise."""
    (r, nc, nf, itemsize), kernel = ROWS_SHAPES[name]
    assert qgm.rows_bwd_kernel(r, nc, nf, itemsize, True) == kernel
    assert qgm.rows_bwd_kernel(r, nc, nf, itemsize, False) == "simple"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bwd_w_matches_vjp_of_pallas_interpret(dtype):
    """The weights' gradient of quad_gather (quad_gather_bwd_w, and w.grad
    through the autograd Function) against jax.vjp in w of the JAX
    package's own kernel in interpret mode plus its epilogue,
    quad_combine(vmem_row_gather(table, idx), w): FFJET 4x9, N = 1024 (two
    BQ blocks); max|d| <= TOL * max|ref| (sums over the 9 fields, in
    another order)."""
    table, idx, w = _inputs(dtype, n=1024)
    g = np.random.default_rng(7).standard_normal((1024, NF)).astype(dtype)

    def f(wj):
        rows = vmem_row_gather(jnp.asarray(table), jnp.asarray(idx),
                               interpret=True)
        return quad_combine(rows, wj, NF)

    _, vjp = jax.vjp(f, jnp.asarray(w))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    dw = quad_gather_bwd_w(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(g), NC, NF)
    _close(dw.numpy(), ref, TOL[dtype])
    wt = torch.from_numpy(w).requires_grad_()
    quad_gather(torch.from_numpy(table), torch.from_numpy(idx), wt, NC,
                NF).backward(torch.from_numpy(g))
    assert torch.equal(wt.grad, dw)


@pytest.mark.parametrize("r", [4, 8])
def test_rows_bwd_w_matches_vjp_of_jnp_gather(r):
    """The weights' gradient of quad_gather_rows (quad_gather_rows_bwd_w,
    and w.grad through the autograd Function) against jax.vjp in w of the
    jnp multi-row gather plus weighted sum that the snapshot samplers of
    grtrans_tpu leave to XLA (Grmhd3D._gather_cols): R = 4 (a trilinear
    cell) and 8 (slow light's two slices) rows of nc = 2 x nf = 10, f64;
    max|d| <= 1e-14 * max|ref| (sums over the 10 fields)."""
    rng = np.random.default_rng(8)
    n, nc, nf = 515, 2, 10
    table = rng.standard_normal((700, nc * nf))
    idx = rng.integers(0, 700, (n, r)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, (n, r, nc))
    g = rng.standard_normal((n, nf))

    def f(wj):
        rows = jnp.asarray(table)[jnp.asarray(idx)].reshape(n, r, nc, nf)
        return jnp.sum(rows * wj[..., None], axis=(1, 2))

    _, vjp = jax.vjp(f, jnp.asarray(w))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    dw = qgm.quad_gather_rows_bwd_w(torch.from_numpy(table),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(g), nc, nf)
    _close(dw.numpy(), ref, 1e-14)
    wt = torch.from_numpy(w).requires_grad_()
    quad_gather_rows(torch.from_numpy(table), torch.from_numpy(idx), wt, nc,
                     nf).backward(torch.from_numpy(g))
    assert torch.equal(wt.grad, dw)
