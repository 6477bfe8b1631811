"""The hand-written CUDA kernel of the port against its plain PyTorch
version, on an NVIDIA card.

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ns,nc,nf", [(16384, 4, 9), (201, 2, 6)],
                         ids=["ffjet", "polsynchpl"])
def test_quad_gather_kernel_matches_plain(dev, dtype, ns, nc, nf):
    n = 4099                                  # ragged against any block size
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


@pytest.mark.cuda
def test_quad_gather_flags_out_of_range_rows(dev):
    table = torch.zeros((16, 4), dtype=torch.float64, device=dev)
    idx = torch.tensor([0, 16, -1, 3], dtype=torch.int32, device=dev)
    w = torch.ones((4, 2), dtype=torch.float64, device=dev)
    flag = qg.error_flag(dev)
    try:
        out = qg.quad_gather(table, idx, w, 2, 2)
        torch.cuda.synchronize()
        assert flag.item() == 1
        assert torch.isnan(out[1:3]).all()
        assert (out[[0, 3]] == 0).all()
    finally:
        flag.zero_()
