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

from grtrans_tpu_torch.ops import quad_gather as qg

TOL = {torch.float32: 1e-6, torch.float64: 1e-14}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 4099, 4_000_007])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ns,nc,nf", [(16384, 4, 9), (201, 2, 6), (77, 3, 5)],
                         ids=["ffjet", "polsynchpl", "generic"])
def test_quad_gather_kernel_matches_plain(dev, dtype, ns, nc, nf, n):
    """The tiled kernel (ffjet, polsynchpl shapes) and the generic one, at
    query counts ragged against the 128-query tile."""
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, n), dtype=torch.int32,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, (n, nc)), dtype=dtype,
                        device=dev)
    before = qg.quad_gather.launches
    out = qg.quad_gather(table, idx, w, nc, nf)
    ref = qg.quad_gather_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert qg.quad_gather.launches == before + 1
    assert qg.error_flag(dev).item() == 0
    assert out.shape == (n, nf) and out.dtype == dtype
    err = (out - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item()
    forced = qg.quad_gather(table, idx, w, nc, nf, generic=True)
    assert (forced - ref).abs().max().item() <= TOL[dtype] * \
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
    kernel the wrapper picks and the generic one, at query counts ragged
    against their blocks."""
    rng = np.random.default_rng(2)
    table = torch.as_tensor(rng.standard_normal((500, 202)), device=dev)
    idx = torch.as_tensor(rng.integers(0, 499, n), dtype=torch.int32,
                          device=dev)
    wgt = torch.as_tensor(rng.uniform(0.0, 1.0, n), device=dev)
    w = torch.stack([1 - wgt, wgt], dim=-1)
    before = qg.quad_gather.launches
    out = qg.quad_gather(table, idx, w, 2, 101)
    ref = qg.quad_gather_ref(table, idx, w, 2, 101)
    torch.cuda.synchronize()
    assert qg.quad_gather.launches == before + 1
    assert qg.error_flag(dev).item() == 0
    assert out.shape == (n, 101)
    assert (out - ref).abs().max().item() <= 1e-14 * ref.abs().max().item()
    wide = qg.quad_gather.launches_by_kernel["wide"]
    forced = qg.quad_gather(table, idx, w, 2, 101, generic=True)
    assert qg.quad_gather.launches_by_kernel["wide"] == wide
    assert (forced - ref).abs().max().item() <= 1e-14 * ref.abs().max().item()


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
    before = qg.quad_gather.launches
    got = on_card.vals(torch.as_tensor(x, device=dev),
                       torch.as_tensor(k, device=dev), 0.9)
    assert qg.quad_gather.launches == before + 1
    want = on_cpu.vals(torch.from_numpy(x), torch.from_numpy(k), 0.9)
    assert got.fnu.shape == (4096, 1, 100) and got.fnu.device.type == "cuda"
    for field in ("fnu", "u", "b"):
        g, w = getattr(got, field).cpu(), getattr(want, field)
        fin = torch.isfinite(w)
        assert torch.equal(torch.isfinite(g), fin)
        assert (g[fin] - w[fin]).abs().max().item() \
            <= 1e-12 * w[fin].abs().max().item()


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
    before = qg.quad_gather.launches_by_kernel["wide"]
    out = qg.quad_gather(table, idx, w, nc, nf)
    ref = qg.quad_gather_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert qg.quad_gather.launches_by_kernel["wide"] == before + 1
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
    a block (the tiled kernel: test_quad_gather_rows_tiled_kernel_*)."""
    rng = np.random.default_rng(5)
    ns = 5000
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, (n, r)), dtype=torch.int32,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, (n, r, nc)), dtype=dtype,
                        device=dev)
    before = qg.quad_gather_rows.launches
    simple = qg.quad_gather_rows.launches_by_kernel["simple"]
    out = qg.quad_gather_rows(table, idx, w, nc, nf, simple=True)
    ref = qg.quad_gather_rows_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert qg.quad_gather_rows.launches == before + 1
    assert qg.quad_gather_rows.launches_by_kernel["simple"] == simple + 1
    assert qg.error_flag(dev).item() == 0
    assert out.shape == (n, nf) and out.dtype == dtype
    assert (out - ref).abs().max().item() <= TOL[dtype] * \
        ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("r,nc", [(4, 2), (3, 2)], ids=["unrolled", "runtime"])
def test_quad_gather_rows_flags_out_of_range_rows(dev, r, nc):
    nf = 10
    table = torch.ones((16, nc * nf), dtype=torch.float64, device=dev)
    idx = torch.zeros((4, r), dtype=torch.int32, device=dev)
    idx[1, r - 1] = 16
    idx[2, 0] = -1
    w = torch.ones((4, r, nc), dtype=torch.float64, device=dev)
    flag = qg.error_flag(dev)
    try:
        out = qg.quad_gather_rows(table, idx, w, nc, nf, simple=True)
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
@pytest.mark.parametrize("dedup", [True, False], ids=["warp", "none"])
@pytest.mark.parametrize("n", [1, 63, 4099, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r,nc,nf", [(4, 2, 10), (8, 2, 10), (1, 1, 12)],
                         ids=["trilinear", "slowlight", "nearest"])
def test_quad_gather_rows_tiled_kernel_matches_plain(dev, dtype, r, nc, nf,
                                                     n, dedup):
    """Every (R, nc) instantiation of the tiled (bulk-copy) kernel, with and
    without deduplication, at query counts ragged against its tiles of
    128 / R queries and against its persistent grid."""
    table, idx, w = _rows_inputs(dev, dtype, n, r, nc, nf)
    assert qg.rows_kernel(r, nc, nf, table.element_size(), True) == "tiled"
    before = qg.quad_gather_rows.launches_by_kernel["tiled"]
    out = qg.quad_gather_rows(table, idx, w, nc, nf, dedup=dedup)
    ref = qg.quad_gather_rows_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert qg.quad_gather_rows.launches_by_kernel["tiled"] == before + 1
    assert qg.error_flag(dev).item() == 0
    _rows_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dedup", [True, False], ids=["warp", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stream", ["one_row", "ray_runs"])
def test_quad_gather_rows_tiled_kernel_on_repeated_rows(dev, dtype, stream,
                                                        dedup):
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
    out = qg.quad_gather_rows(table, idx, w, nc, nf, dedup=dedup)
    ref = qg.quad_gather_rows_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert qg.error_flag(dev).item() == 0
    _rows_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["warp", "none", "simple"])
def test_quad_gather_rows_tiled_kernel_flags_out_of_range_rows(dev, kernel):
    """A bad index in one slot of a query: the flag, NaN for that query
    alone, in the middle of a tile and in a ragged last tile."""
    r, nc, nf, n = 4, 2, 10, 200
    table = torch.ones((16, nc * nf), dtype=torch.float64, device=dev)
    idx = torch.zeros((n, r), dtype=torch.int32, device=dev)
    idx[1, r - 1] = 16
    idx[2, 0] = -1
    idx[n - 1, 1] = 2 ** 31 - 1
    w = torch.ones((n, r, nc), dtype=torch.float64, device=dev)
    flag = qg.error_flag(dev)
    try:
        out = qg.quad_gather_rows(table, idx, w, nc, nf,
                                  simple=kernel == "simple",
                                  dedup=kernel == "warp")
        torch.cuda.synchronize()
        assert flag.item() == 1
        bad = torch.zeros(n, dtype=torch.bool, device=dev)
        bad[[1, 2, n - 1]] = True
        assert torch.isnan(out[bad]).all()
        assert (out[~bad] == r * nc).all()
    finally:
        flag.zero_()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["none", "simple"])
def test_quad_gather_rows_offsets_past_int32_every_kernel(dev, kernel):
    """As test_quad_gather_rows_offsets_past_int32 (which takes the kernel
    the wrapper picks) for the others."""
    nc, nf = 2, 10
    ns = 2 ** 31 // (nc * nf) + 4096          # 107 M rows x 20 float32, 8.6 GB
    table = torch.zeros((ns, nc * nf), dtype=torch.float32, device=dev)
    top = torch.arange(ns - 4, ns, dtype=torch.int32, device=dev)
    table[top.long()] = torch.arange(4.0, device=dev)[:, None] + 1.0
    idx = top.view(1, 4).contiguous()
    w = torch.ones((1, 4, nc), dtype=torch.float32, device=dev)
    out = qg.quad_gather_rows(table, idx, w, nc, nf,
                              simple=kernel == "simple", dedup=False)
    torch.cuda.synchronize()
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
    before = dict(qg.quad_gather_rows.launches_by_kernel)
    out = qg.quad_gather_rows(table, idx, w, nc, nf)
    ref = qg.quad_gather_rows_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    after = qg.quad_gather_rows.launches_by_kernel
    assert after["simple"] == before.get("simple", 0) + 1
    assert after["tiled"] == before.get("tiled", 0)
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
    go to the tiled kernel, and it agrees with the plain version; the
    generic kernel still takes them when forced."""
    rng = np.random.default_rng(7)
    table = torch.as_tensor(rng.standard_normal((ns, nc * nf)), dtype=dtype,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, ns, n), dtype=torch.int32,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.0, 1.0, (n, nc)), dtype=dtype,
                        device=dev)
    before = qg.quad_gather.launches_by_kernel["tiled"]
    out = qg.quad_gather(table, idx, w, nc, nf)
    ref = qg.quad_gather_ref(table, idx, w, nc, nf)
    torch.cuda.synchronize()
    assert qg.quad_gather.launches_by_kernel["tiled"] == before + 1
    assert qg.error_flag(dev).item() == 0
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= TOL[dtype] * scale
    forced = qg.quad_gather(table, idx, w, nc, nf, generic=True)
    assert (forced - ref).abs().max().item() <= TOL[dtype] * scale


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
    before = qg.quad_gather.launches
    assert main([str(tmp_path / "files.in")]) == 0
    assert qg.quad_gather.launches > before
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
    before = qg.quad_gather_rows.launches
    fitted, flux, hist = pgriter.fit_flux(cfg, target, 4e15, model=model,
                                          device=dev)
    assert qg.quad_gather_rows.launches - before == len(hist)
    assert abs(np.log(flux / target)) < 1e-3
    assert abs(np.log(fitted / 6e15)) < 0.05
