"""The hand-written CUDA kernels of the port against their plain PyTorch
versions, on an NVIDIA card.

These tests import neither JAX nor grtrans_tpu, so they also run on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which sets JAX up).  Without a
card every test here skips.

Tolerance: max|kernel - plain| <= tol * max|plain| with tol 1e-14
(float64) / 1e-6 (float32); the corner sums may round in another order.
"""

import numpy as np
import pytest
import torch

from grtrans_tpu_torch import obs
from grtrans_tpu_torch.ops import quad_gather as qg

TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
# the HARMPI set-up's table on the card against the CPU's: 1e-13 but for
# vtl, the LNRF theta velocity, which carries dth/dx2 by a central
# difference of step 1e-6: an ulp between the card's and the host's sin /
# atan / pow becomes a relative 1e-10 there (1.2e-9 read on the card), the
# amplification tests/test_torch_zoo.py bars at 1e-8 against XLA
HARMPI_SETUP_TOL = {"vtl": 1e-8}
# the plain twins, whose calls a path on the card must not make
TWINS = ("quad_gather_ref", "quad_gather_rows_ref", "quad_gather_bwd_w_ref",
         "quad_gather_rows_bwd_w_ref")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _unaligned(t):
    """A contiguous copy of t that starts one element past 16 bytes: an
    operand the tiled kernels cannot take, so the pickers send it to the
    generic, simple or first-design kernel."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    out = flat[1:].view(t.shape)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 4099, 4_000_007])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ns,nc,nf", [(16384, 4, 9), (201, 2, 6), (77, 3, 5)],
                         ids=["ffjet", "polsynchpl", "generic"])
def test_quad_gather_kernel_matches_plain(dev, dtype, ns, nc, nf, n):
    """The tiled kernel (ffjet, polsynchpl shapes) and the generic one (the
    other shape, and every shape with weights off 16 bytes), at query
    counts ragged against the 128-query tile."""
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, n), dtype=torch.int32,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, (n, nc)), dtype=dtype,
                        device=dev)
    before = obs.counters()["quad_gather.launches"]
    out = qg.quad_gather(table, idx, w, nc, nf)
    ref = qg.quad_gather_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert obs.counters()["quad_gather.launches"] == before + 1
    assert qg.error_flag(dev).item() == 0
    assert out.shape == (n, nf) and out.dtype == dtype
    err = (out - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item()
    generic = obs.counters()["quad_gather.launches.generic"]
    off = qg.quad_gather(table, idx, _unaligned(w), nc, nf)
    assert obs.counters()["quad_gather.launches.generic"] == generic + 1
    assert (off - ref).abs().max().item() <= TOL[dtype] * \
        ref.abs().max().item()


@pytest.mark.cuda
def test_quad_gather_takes_unaligned_operands(dev):
    """A weight view that starts 8 bytes into its storage cannot feed
    16-byte loads: the wrapper sends it to the generic kernel."""
    rng = np.random.default_rng(1)
    table = torch.as_tensor(rng.standard_normal((201, 12)), device=dev)
    idx = torch.as_tensor(rng.integers(0, 201, 1000), dtype=torch.int32,
                          device=dev)
    flat = torch.as_tensor(rng.uniform(0, 1, 2001), device=dev)
    w = flat[1:].view(1000, 2)
    assert w.data_ptr() % 16 == 8 and w.is_contiguous()
    out = qg.quad_gather(table, idx, w, 2, 6)
    ref = qg.quad_gather_ref(table, idx, w, 2, 6)
    assert (out - ref).abs().max().item() <= 1e-14 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("nc,nf", [(3, 5), (4, 9), (2, 6)],
                         ids=["generic", "ffjet", "polsynchpl"])
def test_quad_gather_flags_out_of_range_rows(dev, nc, nf):
    table = torch.zeros((16, nc * nf), dtype=torch.float64, device=dev)
    idx = torch.tensor([0, 16, -1, 3], dtype=torch.int32, device=dev)
    w = torch.ones((4, nc), dtype=torch.float64, device=dev)
    flag = qg.error_flag(dev)
    try:
        out = qg.quad_gather(table, idx, w, nc, nf)
        torch.cuda.synchronize()
        assert flag.item() == 1
        assert torch.isnan(out[1:3]).all()
        assert (out[[0, 3]] == 0).all()
    finally:
        flag.zero_()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 1024 * 1024 + 3])
def test_quad_gather_at_the_phatdisk_shape(dev, n):
    """PHATDISK's pair-packed table, (500, 2 x 101) float64: the wide-row
    kernel the wrapper picks, with weights on 16 bytes and off them, at
    query counts ragged against its blocks."""
    rng = np.random.default_rng(2)
    table = torch.as_tensor(rng.standard_normal((500, 202)), device=dev)
    idx = torch.as_tensor(rng.integers(0, 499, n), dtype=torch.int32,
                          device=dev)
    wgt = torch.as_tensor(rng.uniform(0.0, 1.0, n), device=dev)
    w = torch.stack([1 - wgt, wgt], dim=-1)
    before = obs.counters()["quad_gather.launches"]
    out = qg.quad_gather(table, idx, w, 2, 101)
    ref = qg.quad_gather_ref(table, idx, w, 2, 101)
    torch.cuda.synchronize()
    assert obs.counters()["quad_gather.launches"] == before + 1
    assert qg.error_flag(dev).item() == 0
    assert out.shape == (n, 101)
    assert (out - ref).abs().max().item() <= 1e-14 * ref.abs().max().item()
    wide = obs.counters()["quad_gather.launches.wide"]
    off = qg.quad_gather(table, idx, _unaligned(w), 2, 101)
    assert obs.counters()["quad_gather.launches.wide"] == wide + 1
    assert (off - ref).abs().max().item() <= 1e-14 * ref.abs().max().item()


@pytest.mark.cuda
def test_phatdisk_vals_on_the_card_match_the_cpu(dev):
    """PhatDisk.vals launches the kernel once on the card and agrees with
    its CPU path (the plain version) on the same points."""
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    kw = dict(a=0.9, nr=500, nfreq_tab=100, nw=100)
    on_card = load_fluid_model("PHATDISK", device=dev, **kw)
    on_cpu = load_fluid_model("PHATDISK", device="cpu", **kw)
    rng = np.random.default_rng(3)
    x = np.zeros((4096, 1, 4))
    x[..., 1] = 10.0 ** rng.uniform(np.log10(1.5), 3.9, (4096, 1))
    x[..., 2] = np.pi / 2
    k = rng.normal(size=x.shape)
    before = obs.counters()["quad_gather.launches"]
    got = on_card.vals(torch.as_tensor(x, device=dev),
                       torch.as_tensor(k, device=dev), 0.9)
    assert obs.counters()["quad_gather.launches"] == before + 1
    want = on_cpu.vals(torch.from_numpy(x), torch.from_numpy(k), 0.9)
    assert got.fnu.shape == (4096, 1, 100) and got.fnu.device.type == "cuda"
    for field in ("fnu", "u", "b"):
        g, w = getattr(got, field).cpu(), getattr(want, field)
        fin = torch.isfinite(w)
        assert torch.equal(torch.isfinite(g), fin)
        assert (g[fin] - w[fin]).abs().max().item() \
            <= 1e-12 * w[fin].abs().max().item()


@pytest.mark.cuda
def test_harmpi_setup_on_the_card_matches_the_cpu(dev):
    """The HARMPI set-up (BL = 3, cylindrified, kel4a-d) builds its table
    on the card, waiting once for it at the end of its coordinate span,
    and agrees with the CPU's column by column, each to HARMPI_SETUP_TOL
    of its largest |value|."""
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.testing import grmhd_dump
    dump = grmhd_dump.harmpi_dump(48, 32, 16, bl=3, seed=3)
    dump["h"]["DOCYLINDRIFYCOORDS"] = 1.0
    before = obs.counters()["sync.harmpi.setup"]
    on_card = load_fluid_model("HARMPI", device=dev, dump=dump)
    assert obs.counters()["sync.harmpi.setup"] == before + 1
    on_cpu = load_fluid_model("HARMPI", device="cpu", dump=dump)
    assert on_card.fstack.device.type == "cuda"
    got, want = on_card.fstack.cpu(), on_cpu.fstack
    err = (got - want).abs().amax(0) / want.abs().amax(0).clamp_min(1e-300)
    for name, e in zip(on_cpu.PFIELDS, err.tolist()):
        assert e <= HARMPI_SETUP_TOL.get(name, 1e-13), (name, e)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nc,nf", [(2, 32), (3, 45), (32, 33), (1, 257)])
def test_wide_row_kernel_matches_plain(dev, dtype, nc, nf):
    """The wide-row kernel at widths ragged against the warp, at nc up to
    the 32 weights a warp can share, with a flagged row in the middle."""
    rng = np.random.default_rng(4)
    n, ns = 1003, 40
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, n), dtype=torch.int32,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, (n, nc)), dtype=dtype,
                        device=dev)
    before = obs.counters()["quad_gather.launches.wide"]
    out = qg.quad_gather(table, idx, w, nc, nf)
    ref = qg.quad_gather_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert obs.counters()["quad_gather.launches.wide"] == before + 1
    assert qg.error_flag(dev).item() == 0
    assert (out - ref).abs().max().item() <= TOL[dtype] * \
        ref.abs().max().item()
    flag = qg.error_flag(dev)
    try:
        idx[500] = ns
        out = qg.quad_gather(table, idx, w, nc, nf)
        torch.cuda.synchronize()
        assert flag.item() == 1 and torch.isnan(out[500]).all()
        keep = torch.arange(n, device=dev) != 500
        assert (out[keep] - ref[keep]).abs().max().item() <= TOL[dtype] * \
            ref.abs().max().item()
    finally:
        flag.zero_()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 4099, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r,nc,nf", [(4, 2, 10), (8, 2, 11), (8, 1, 6),
                                     (4, 1, 20), (1, 1, 14), (3, 2, 5)],
                         ids=["trilinear", "slowlight", "bins3d", "bins2d",
                              "nearest", "runtime"])
def test_quad_gather_rows_kernel_matches_plain(dev, dtype, r, nc, nf, n):
    """Every instantiation of the simple quad_gather_rows kernel and its
    run-time (R, nc) form, at query counts ragged against the 16 queries of
    a block: a table one element past 16 bytes goes to the simple kernel
    at every shape (the tiled kernel: test_quad_gather_rows_tiled_kernel_*)."""
    rng = np.random.default_rng(5)
    ns = 5000
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, (n, r)), dtype=torch.int32,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, (n, r, nc)), dtype=dtype,
                        device=dev)
    table = _unaligned(table)
    before = obs.counters()["quad_gather_rows.launches"]
    simple = obs.counters()["quad_gather_rows.launches.simple"]
    out = qg.quad_gather_rows(table, idx, w, nc, nf)
    ref = qg.quad_gather_rows_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert obs.counters()["quad_gather_rows.launches"] == before + 1
    assert obs.counters()["quad_gather_rows.launches.simple"] == simple + 1
    assert qg.error_flag(dev).item() == 0
    assert out.shape == (n, nf) and out.dtype == dtype
    assert (out - ref).abs().max().item() <= TOL[dtype] * \
        ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("r,nc", [(4, 2), (3, 2)], ids=["unrolled", "runtime"])
def test_quad_gather_rows_flags_out_of_range_rows(dev, r, nc):
    nf = 10
    table = _unaligned(torch.ones((16, nc * nf), dtype=torch.float64,
                                  device=dev))
    idx = torch.zeros((4, r), dtype=torch.int32, device=dev)
    idx[1, r - 1] = 16
    idx[2, 0] = -1
    w = torch.ones((4, r, nc), dtype=torch.float64, device=dev)
    flag = qg.error_flag(dev)
    try:
        out = qg.quad_gather_rows(table, idx, w, nc, nf)
        torch.cuda.synchronize()
        assert flag.item() == 1
        assert torch.isnan(out[1:3]).all()
        assert (out[[0, 3]] == r * nc).all()
    finally:
        flag.zero_()


@pytest.mark.cuda
def test_quad_gather_rows_offsets_past_int32(dev):
    """Rows whose element offset idx * (nc * nf) exceeds 2^31: the kernel
    forms it in 64 bits."""
    nc, nf = 2, 10
    ns = 2 ** 31 // (nc * nf) + 4096          # 107 M rows x 20 float32, 8.6 GB
    table = torch.zeros((ns, nc * nf), dtype=torch.float32, device=dev)
    top = torch.arange(ns - 4, ns, dtype=torch.int32, device=dev)
    table[top.long()] = torch.arange(4.0, device=dev)[:, None] + 1.0
    idx = top.view(1, 4).contiguous()
    w = torch.ones((1, 4, nc), dtype=torch.float32, device=dev)
    out = qg.quad_gather_rows(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert qg.error_flag(dev).item() == 0
    assert (out == 2.0 * (1 + 2 + 3 + 4)).all()


def _rows_inputs(dev, dtype, n, r, nc, nf, ns=5000, seed=6):
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, (n, r)), dtype=torch.int32,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, (n, r, nc)), dtype=dtype,
                        device=dev)
    return table, idx, w


def _rows_close(out, ref, dtype):
    assert out.shape == ref.shape and out.dtype == dtype
    assert (out - ref).abs().max().item() <= ROWS_TOL[dtype] * \
        ref.abs().max().item()


# the corner sums of quad_gather_rows run over 8-16 terms
ROWS_TOL = {torch.float32: 2e-6, torch.float64: 1e-14}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 4099, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r,nc,nf", [(4, 2, 10), (8, 2, 10), (1, 1, 12)],
                         ids=["trilinear", "slowlight", "nearest"])
def test_quad_gather_rows_tiled_kernel_matches_plain(dev, dtype, r, nc, nf,
                                                     n):
    """Every (R, nc) instantiation of the tiled (bulk-copy) kernel, at
    query counts ragged against its tiles of 128 / R queries and against
    its persistent grid."""
    table, idx, w = _rows_inputs(dev, dtype, n, r, nc, nf)
    assert qg.rows_kernel(r, nc, nf, table.element_size(), True) == "tiled"
    before = obs.counters()["quad_gather_rows.launches.tiled"]
    out = qg.quad_gather_rows(table, idx, w, nc, nf)
    ref = qg.quad_gather_rows_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert obs.counters()["quad_gather_rows.launches.tiled"] == before + 1
    assert qg.error_flag(dev).item() == 0
    _rows_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stream", ["one_row", "ray_runs"])
def test_quad_gather_rows_tiled_kernel_on_repeated_rows(dev, dtype, stream):
    """Every query on one row (the worst case of the deduplication: one
    distinct row a tile), and runs of neighbouring cells as along a ray."""
    n, r, nc, nf = 100_003, 4, 2, 10
    table, idx, w = _rows_inputs(dev, dtype, n, r, nc, nf)
    if stream == "one_row":
        idx.fill_(1234)
    else:
        base = torch.arange(n, device=dev, dtype=torch.int32) // 13 % 4000
        idx = (base[:, None] + torch.tensor([0, 1, 64, 65], device=dev,
                                            dtype=torch.int32)).contiguous()
    out = qg.quad_gather_rows(table, idx, w, nc, nf)
    ref = qg.quad_gather_rows_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert qg.error_flag(dev).item() == 0
    _rows_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["tiled", "simple"])
def test_quad_gather_rows_tiled_kernel_flags_out_of_range_rows(dev, kernel):
    """A bad index in one slot of a query: the flag, NaN for that query
    alone, in the middle of a tile and in a ragged last tile; on the tiled
    kernel and on the simple one (the table off 16 bytes)."""
    r, nc, nf, n = 4, 2, 10, 200
    table = torch.ones((16, nc * nf), dtype=torch.float64, device=dev)
    if kernel == "simple":
        table = _unaligned(table)
    idx = torch.zeros((n, r), dtype=torch.int32, device=dev)
    idx[1, r - 1] = 16
    idx[2, 0] = -1
    idx[n - 1, 1] = 2 ** 31 - 1
    w = torch.ones((n, r, nc), dtype=torch.float64, device=dev)
    flag = qg.error_flag(dev)
    launches = f"quad_gather_rows.launches.{kernel}"
    try:
        before = obs.counters()[launches]
        out = qg.quad_gather_rows(table, idx, w, nc, nf)
        torch.cuda.synchronize()
        assert obs.counters()[launches] == before + 1
        assert flag.item() == 1
        bad = torch.zeros(n, dtype=torch.bool, device=dev)
        bad[[1, 2, n - 1]] = True
        assert torch.isnan(out[bad]).all()
        assert (out[~bad] == r * nc).all()
    finally:
        flag.zero_()


@pytest.mark.cuda
def test_quad_gather_rows_offsets_past_int32_every_kernel(dev):
    """As test_quad_gather_rows_offsets_past_int32 (the tiled kernel) for
    the simple one: the table one element past 16 bytes."""
    nc, nf = 2, 10
    ns = 2 ** 31 // (nc * nf) + 4096          # 107 M rows x 20 float32, 8.6 GB
    flat = torch.zeros(ns * nc * nf + 1, dtype=torch.float32, device=dev)
    table = flat[1:].view(ns, nc * nf)
    top = torch.arange(ns - 4, ns, dtype=torch.int32, device=dev)
    table[top.long()] = torch.arange(4.0, device=dev)[:, None] + 1.0
    idx = top.view(1, 4).contiguous()
    w = torch.ones((1, 4, nc), dtype=torch.float32, device=dev)
    before = obs.counters()["quad_gather_rows.launches.simple"]
    out = qg.quad_gather_rows(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert obs.counters()["quad_gather_rows.launches.simple"] == before + 1
    assert qg.error_flag(dev).item() == 0
    assert (out == 2.0 * (1 + 2 + 3 + 4)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32_2x11", "f32_1x6", "unaligned_f64",
                                  "bins3d_f64", "bins2d_f64"])
def test_quad_gather_rows_picks_the_simple_kernel(dev, case):
    """Rows the bulk copy cannot take (not whole 16-byte pieces: KORAL3D's
    2 x 11 and the bins' 1 x 6 in float32; a table starting 8 bytes into
    its storage) and the binned populations (R = 8 or 4 of 1 x 6) go to
    the simple kernel, and it agrees."""
    dtype = torch.float32 if case.startswith("f32") else torch.float64
    r, nc, nf = {"f32_2x11": (4, 2, 11), "f32_1x6": (8, 1, 6),
                 "unaligned_f64": (4, 2, 10), "bins3d_f64": (8, 1, 6),
                 "bins2d_f64": (4, 1, 6)}[case]
    table, idx, w = _rows_inputs(dev, dtype, 4099, r, nc, nf)
    if case == "unaligned_f64":
        flat = torch.cat([table.new_zeros(1), table.reshape(-1)])
        table = flat[1:].view(table.shape)
        assert table.data_ptr() % 16 == 8 and table.is_contiguous()
    before = obs.counters()
    out = qg.quad_gather_rows(table, idx, w, nc, nf)
    ref = qg.quad_gather_rows_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    after = obs.counters()
    assert after["quad_gather_rows.launches.simple"] == \
        before["quad_gather_rows.launches.simple"] + 1
    assert after["quad_gather_rows.launches.tiled"] == \
        before["quad_gather_rows.launches.tiled"]
    _rows_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 129, 4_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ns,nc,nf", [(768, 4, 10), (36864, 4, 11),
                                      (120, 2, 2), (5000, 4, 1),
                                      (26331, 4, 6)],
                         ids=["harm", "koral", "sphacc", "numdisk",
                              "polsynchpl_p"])
def test_quad_gather_tiled_kernel_at_the_2d_table_shapes(dev, dtype, ns, nc,
                                                         nf, n):
    """HARM, KORAL, SPHACC, NUMDISK and the per-sample-p POLSYNCHPL table
    go to the tiled kernel, and it agrees with the plain version; with the
    weights off 16 bytes the generic kernel takes them."""
    rng = np.random.default_rng(7)
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, n), dtype=torch.int32,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, (n, nc)), dtype=dtype,
                        device=dev)
    before = obs.counters()["quad_gather.launches.tiled"]
    out = qg.quad_gather(table, idx, w, nc, nf)
    ref = qg.quad_gather_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert obs.counters()["quad_gather.launches.tiled"] == before + 1
    assert qg.error_flag(dev).item() == 0
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= TOL[dtype] * scale
    generic = obs.counters()["quad_gather.launches.generic"]
    off = qg.quad_gather(table, idx, _unaligned(w), nc, nf)
    assert obs.counters()["quad_gather.launches.generic"] == generic + 1
    assert (off - ref).abs().max().item() <= TOL[dtype] * scale


def _flagship_files(tmp_path, nn=(16, 16, 64)):
    """The FFJET flagship's dump, namelists and files.in under tmp_path."""
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.io import namelist
    from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump

    dfile = tmp_path / "ffjet.bin"
    write_ffjet_dump(dfile, nx=32)
    cfg = GrtransConfig(
        fname="FFJET", ename="POLSYNCHPL", nvals=4, spin=0.998, nn=nn,
        uout=0.01, mbh=3.4e9, mumin=0.906, mumax=0.906, fmin=3.45e11,
        fmax=3.45e11, gridvals=(-40.0, 20.0, -20.0, 40.0), iname="formal",
        fargs=dict(dfile=str(dfile), ntscl=2.0, nrscl=70.0))
    namelist.write_inputs(cfg, tmp_path / "inputs.in")
    namelist.write_files_in(tmp_path / "inputs.in", tmp_path / "cams.bin",
                            tmp_path / "files.in")
    return cfg


@pytest.mark.cuda
def test_cli_on_the_card_writes_the_render(dev, tmp_path):
    """main() with no --device renders on the card: the binary holds the
    float32 of Grtrans.run(device="cuda"), and quad_gather launched."""
    from grtrans_tpu_torch.__main__ import main
    from grtrans_tpu_torch.api import Grtrans
    from grtrans_tpu_torch.io.binio import read_camera_bin

    cfg = _flagship_files(tmp_path)
    before = obs.counters()["quad_gather.launches"]
    assert main([str(tmp_path / "files.in")]) == 0
    assert obs.counters()["quad_gather.launches"] > before
    x = Grtrans()
    x.cfg = cfg
    x.run(device="cuda")
    _, cams, _ = read_camera_bin(tmp_path / "cams.bin")
    np.testing.assert_array_equal(cams[0],
                                  x.ivals[:, :, 0].astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 100])
def test_gdfile_hit_on_the_card_equals_a_fresh_trace(dev, tmp_path, chunk):
    from grtrans_tpu_torch.orchestrator import grtrans_run

    cfg = _flagship_files(tmp_path)
    gd = str(tmp_path / "geo.npz")
    fresh, _, _ = grtrans_run(cfg, device=dev, chunk=chunk)
    saved, _, _ = grtrans_run(cfg, device=dev, chunk=chunk, gdfile=gd)
    loaded, _, _ = grtrans_run(cfg, device=dev, chunk=chunk, gdfile=gd)
    assert loaded.device.type == "cuda"
    assert torch.equal(saved, loaded)
    torch.testing.assert_close(loaded, fresh, rtol=0.0,
                               atol=1e-12 * fresh.abs().max().item())


@pytest.mark.cuda
def test_pgriter_through_a_loaded_snapshot_on_the_card(dev):
    """An mdot fit on a small HARM3D dump: no model load, one
    quad_gather_rows launch a render, and the fit converges."""
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.testing import grmhd_dump
    from grtrans_tpu_torch.tools import pgriter

    cfg = GrtransConfig(
        fname="HARM3D", ename="POLSYNCHTH", nvals=4, spin=grmhd_dump.A,
        nn=(16, 16, 64), uout=0.04, mbh=4.3e6, mumin=0.5, mumax=0.5,
        fmin=2.3e11, fmax=2.3e11, iname="formal", gmin=10.0, muval=0.25,
        gridvals=(-15.0, 15.0, -15.0, 15.0))
    model = load_fluid_model("HARM3D", device=dev,
                             dump=grmhd_dump.harm3d_dump(32, 24, 16))
    target, _ = pgriter.flux_at(cfg, 6e15, model=model, device=dev)
    before = obs.counters()["quad_gather_rows.launches"]
    fitted, flux, hist = pgriter.fit_flux(cfg, target, 4e15, model=model,
                                          device=dev)
    assert obs.counters()["quad_gather_rows.launches"] - before == len(hist)
    assert abs(np.log(flux / target)) < 1e-3
    assert abs(np.log(fitted / 6e15)) < 0.05


# every (R, nc, nf) of the forward kernels (R None: quad_gather): FFJET,
# POLSYNCHPL and its per-sample p, HARM, PHATDISK, SPHACC, NUMDISK; the
# snapshot, slow light, HARMPI, KORAL's bins, a run-time shape
BWD_SHAPES = [(None, 4, 9), (None, 2, 6), (None, 4, 6), (None, 4, 10),
              (None, 2, 101), (None, 2, 2), (None, 4, 1), (4, 2, 10),
              (8, 2, 10), (1, 1, 10), (8, 1, 6), (3, 3, 5)]


def _bwd(r):
    """(kernel wrapper, plain twin, first design's name) of the weights'
    backward of quad_gather (r None) or quad_gather_rows."""
    if r is None:
        return qg.quad_gather_bwd_w, qg.quad_gather_bwd_w_ref, "generic"
    return qg.quad_gather_rows_bwd_w, qg.quad_gather_rows_bwd_w_ref, "simple"


def _picked(r, nc, nf, dtype, aligned=True):
    itemsize = torch.finfo(dtype).bits // 8
    if r is None:
        return qg.bwd_kernel(nc, nf, aligned)
    return qg.rows_bwd_kernel(r, nc, nf, itemsize, aligned)


def _check_bwd(table, idx, g, nc, nf, kernel, forced=False):
    """One launch of the backward against its twin (TOL of max|twin|,
    widened for long rows), on the kernel `kernel` by its launch count,
    bitwise repeated from run to run; `forced`: g one element past 16
    bytes, which the first design alone takes.  Returns (dw, twin)."""
    r = idx.shape[1] if idx.dim() == 2 else None
    kern, twin, _ = _bwd(r)
    if forced:
        g = _unaligned(g)
    launches = f"{kern.__name__}.launches.{kernel}"
    before = obs.counters()[launches]
    out = kern(table, idx, g, nc, nf)
    ref = twin(table, idx, g, nc, nf)
    torch.cuda.synchronize()
    assert obs.counters()[launches] == before + 1
    assert qg.error_flag(table.device).item() == 0
    assert out.shape == idx.shape + (nc,) and out.dtype == table.dtype
    assert (out - ref).abs().max().item() <= TOL[table.dtype] * \
        ref.abs().max().item() * max(1.0, nf / 16)
    assert torch.equal(out, kern(table, idx, g, nc, nf))
    return out, ref


def _bwd_operands(dev, dtype, r, nc, nf, n, ns=257, seed=1):
    rng = np.random.default_rng(seed)
    shape = (n,) if r is None else (n, r)
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, shape), dtype=torch.int32,
                          device=dev)
    g = torch.as_tensor(rng.standard_normal((n, nf)), dtype=dtype,
                        device=dev)
    return table, idx, g


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [False, True],
                         ids=["picked", "first_design"])
@pytest.mark.parametrize("n", [1, 31, 4099, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r,nc,nf", BWD_SHAPES)
def test_backward_kernels_match_plain(dev, dtype, r, nc, nf, n, forced):
    """quad_gather_bwd_w (r None) and quad_gather_rows_bwd_w against their
    plain twins at every shape of the forward kernels, on the kernel the
    wrapper picks (tiled where the shape and alignment admit it) and on
    the first design (generic / simple; g off 16 bytes), at query counts ragged
    against the tiles, bitwise repeated from run to run (no atomics); the
    tiled kernel equals the first design to rounding (both sum the fields
    in one order)."""
    table, idx, g = _bwd_operands(dev, dtype, r, nc, nf, n)
    first = _bwd(r)[2]
    kernel = first if forced else _picked(r, nc, nf, dtype)
    out, ref = _check_bwd(table, idx, g, nc, nf, kernel, forced)
    if not forced:
        other, _ = _check_bwd(table, idx, g, nc, nf, first, forced=True)
        assert (out - other).abs().max().item() <= TOL[dtype] * \
            ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r,nc,nf", [(None, 4, 9), (None, 2, 6), (4, 2, 10)],
                         ids=["ffjet", "polsynchpl", "snapshot"])
def test_backward_takes_unaligned_operands(dev, dtype, r, nc, nf):
    """A gradient (or, for R = 1, a table) that starts 8 or 4 bytes into
    its storage cannot feed 16-byte loads: the wrapper sends it to the
    first design, which agrees with the twin."""
    table, idx, g = _bwd_operands(dev, dtype, r, nc, nf, 4099, seed=2)
    flat = torch.empty(g.numel() + 1, dtype=dtype, device=dev)
    flat[1:] = g.reshape(-1)
    shifted = flat[1:].view(g.shape)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    first = _bwd(r)[2]
    assert _picked(r, nc, nf, dtype, aligned=False) == first
    _check_bwd(table, idx, shifted, nc, nf, first)
    if r is None:
        tflat = torch.empty(table.numel() + 1, dtype=dtype, device=dev)
        tflat[1:] = table.reshape(-1)
        _check_bwd(tflat[1:].view(table.shape), idx, g, nc, nf, first)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["one_row", "warp_shares"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r,nc,nf", [(None, 4, 9), (4, 2, 10), (8, 2, 10),
                                     (1, 1, 10)])
def test_backward_on_shared_rows(dev, dtype, r, nc, nf, stream):
    """The tiled kernels where queries share rows: every query on one row
    (the warp dedup's worst case: one copy a warp), and the queries of a
    warp naming a few rows among them (neighbouring samples of a ray share
    cells), ragged N; against the twin and the first design."""
    n = 40_009
    table, idx, g = _bwd_operands(dev, dtype, r, nc, nf, n, ns=1000, seed=3)
    if stream == "one_row":
        idx.fill_(617)
    else:
        q = torch.arange(idx.numel(), device=dev, dtype=torch.int64)
        idx.view(-1).copy_((q // 11 * 7 + q % 3) % 1000)
    out, ref = _check_bwd(table, idx, g, nc, nf, _picked(r, nc, nf, dtype))
    first, _ = _check_bwd(table, idx, g, nc, nf, _bwd(r)[2], forced=True)
    assert (out - first).abs().max().item() <= TOL[dtype] * \
        ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [False, True],
                         ids=["picked", "first_design"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r,nc,nf", [(None, 4, 9), (None, 2, 6), (4, 2, 10),
                                     (8, 2, 10), (1, 1, 10)])
def test_backward_flags_out_of_range_rows(dev, dtype, r, nc, nf, forced):
    """A row outside [0, ns) in one query of a tile (and in the ragged last
    tile): the flag set, NaN in every dw of those queries, the others equal
    to the twin's."""
    n = 1000
    table, idx, g = _bwd_operands(dev, dtype, r, nc, nf, n, ns=300, seed=4)
    bad = [5, 513, n - 1]
    flat = idx.view(n, -1)
    flat[5, -1] = 300
    flat[513, 0] = -1
    flat[n - 1, 0] = 10 ** 6
    kern, twin, _ = _bwd(r)
    flag = qg.error_flag(dev)
    try:
        dw = kern(table, idx, _unaligned(g) if forced else g, nc, nf)
        torch.cuda.synchronize()
        assert flag.item() == 1
        good = torch.ones(n, dtype=torch.bool, device=dev)
        good[bad] = False
        assert torch.isnan(dw[~good]).all()
        fixed = idx.clone()
        fixed.view(n, -1)[~good] = 0
        ref = twin(table, fixed, g, nc, nf)
        assert (dw[good] - ref[good]).abs().max().item() <= TOL[dtype] * \
            ref.abs().max().item()
    finally:
        flag.zero_()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [False, True])
def test_gather_gradients_on_the_card(dev, rows):
    """autograd through the Functions on the card: the weights' gradient
    equals the CPU's (the twins), is launched as the backward kernel, and
    no plain twin runs on the card; the backward kernels flag an
    out-of-range row with NaN in that query's gradient."""
    rng = np.random.default_rng(2)
    r, nc, nf = (4, 2, 10) if rows else (None, 4, 9)
    shape = (999,) if r is None else (999, r)
    table = torch.as_tensor(rng.standard_normal((300, nc * nf)))
    idx = torch.as_tensor(rng.integers(0, 300, shape), dtype=torch.int32)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, shape + (nc,)))
    g = torch.as_tensor(rng.standard_normal((999, nf)))
    fwd = qg.quad_gather_rows if rows else qg.quad_gather
    bwd = qg.quad_gather_rows_bwd_w if rows else qg.quad_gather_bwd_w
    picked = _picked(r, nc, nf, torch.float64)
    grads = {}
    for where in ("cpu", dev):
        wt = w.to(where).clone().requires_grad_()
        out = fwd(table.to(where), idx.to(where), wt, nc, nf)
        before = obs.counters()
        out.backward(g.to(where))
        grads[str(where)] = wt.grad.cpu()
        if where == dev:
            after = obs.counters()
            name = bwd.__name__
            assert after[f"{name}.launches"] == \
                before[f"{name}.launches"] + 1
            assert after[f"{name}.launches.{picked}"] == \
                before[f"{name}.launches.{picked}"] + 1
            assert sum(after[f"{t}.calls"] for t in TWINS) == \
                sum(before[f"{t}.calls"] for t in TWINS)
    torch.testing.assert_close(grads[str(dev)], grads["cpu"], rtol=1e-14,
                               atol=1e-14)
    bad = idx.to(dev).clone()
    bad.view(-1)[0] = 300
    dw = bwd(table.to(dev), bad, g.to(dev), nc, nf)
    torch.cuda.synchronize()
    assert qg.error_flag(dev).item() == 1
    assert torch.isnan(dw[0]).all() and not torch.isnan(dw[1:]).any()
    qg.error_flag(dev).zero_()
