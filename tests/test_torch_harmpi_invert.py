"""HARMPI's jetcoords inversion as two CUDA kernels (ops/harmpi_invert.py,
csrc/harmpi_invert.cu) against the torch twins they replace on the card
(fluid.harmpi.x1_of_r_twin and x2_of_th_bl3_twin: thickdisk.bisect over
calcrmks and calcthmksbl3).

On the CPU (tier 1): vals' dispatch and the obs counters that show it, the
wrapper's checks, the library's name, the float32 kernels' scalars, and
the twins bit for bit the torch bisections that x1_of_r and x2_of_th_bl3
ran before the kernels.  On the card (marker `cuda`; no JAX here, so run
with `--noconftest`), in float64 and in float32 (prec="mixed"):

    python -m pytest --noconftest -m cuda tests/test_torch_harmpi_invert.py -q

kernel against twin on samples drawn over the whole map of the
benchmark's grid, with its edges forced (x1 on both sides of xbr = ln 400;
r at the horizon, at the grid's inner edge and at 1,000 M; th at 0, pi / 2
and pi; |x2| on each side of 0.25, 0.5 and 0.6, the ftr band's edges and
thetaofx2's branch edges), and their zones on the benchmark's 288 x 128
grid (none may differ); the nearest rows vals picks from either; a
64x64x400 frame through grtrans_run; two launches a sampled camera.

Bars.  Kernel and twin do the same float64 operations in the same order,
so they differ only where a transcendental function rounds otherwise in
the kernel's build than in torch's (an ulp).  A comparison f(mid) > target
that such an ulp turns moves the bisection's result by about an ulp of f
over the map's slope: dr / dx1 = r - R0 gives 2.2e-16 in x1, and
dth / dx2 >= 0.3 on this grid gives ~1.5e-15 in x2.  X_TOL = 1e-13 leaves
two orders of magnitude above that and is far below a zone (dx1 ~ 0.03,
dx2 ~ 0.016), so the rows agree; the frame is held to 1e-12 of max|I|, the
march kernel's bar.  In float32 the same argument gives ~1.2e-7 in x1 and
~8e-7 in x2 (an ulp of pi over 0.3): X_TOL32 = 1e-5 is an order above it
and three below a zone.  The mixed frame's march runs in float32 either
way, so with the same rows its image is the twin's; it is held to the
same 1e-12 of max|I|.
"""

import dataclasses
import math

import pytest
import torch

from grtrans_tpu_torch import obs
from grtrans_tpu_torch.fluid import harmpi
from grtrans_tpu_torch.fluid.base import load_fluid_model
from grtrans_tpu_torch.fluid.thickdisk import bisect
from grtrans_tpu_torch.ops import _build
from grtrans_tpu_torch.ops import formal_march as fm
from grtrans_tpu_torch.ops import harmpi_invert as hi
from grtrans_tpu_torch.testing import grmhd_dump

torch.set_num_threads(1)   # the suite runs in parallel worker processes

A = 0.9375
R_PLUS = 1.0 + math.sqrt(1.0 - A * A)
X_TOL = 1e-13              # x1, x2: kernel against twin (see above)
X_TOL32 = 1e-5             # the same in float32
ZONES = (288, 128)         # the benchmark grid's x1 and x2 zones
IMAGE_TOL = 1e-12          # of max|I|


def benchmark_grid():
    """BL3Params of the benchmark's HARMPI grid (harmpi_sgra_eheat: from
    0.87 r+, read_bl3_vars's defaults) and its inner edge."""
    rin = 0.87 * R_PLUS
    return harmpi.bl3_params_from_header(
        dict(R0=0.0, hslope=0.3, startx1=math.log(rin))), rin


def samples(n, p, rin, seed, device, dtype=torch.float64):
    """(r, th) as the x[..., 1] and x[..., 2] views of an (n, 4) sample
    tensor of dtype: r log-uniform over [rin, 2000] with the forced radii, th the
    map's at a uniform x2 (a tenth uniform in [0, pi]) with the forced
    angles and band edges."""
    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64)
    u = torch.rand(n, generator=g, **f64)
    r = torch.exp(math.log(rin) + u * (math.log(2000.0) - math.log(rin)))
    x2 = 2.0 * torch.rand(n, generator=g, **f64) - 1.0
    xbr = p.xbr
    radii = [R_PLUS, rin, 1000.0, 400.0]
    radii += [math.exp(xbr + s * d) for s in (-1, 1)
              for d in (1e-12, 1e-9, 1e-3, 0.3)]
    k = len(radii)
    r[:k] = torch.tensor(radii, **f64)
    edges = [s * (e + d) for s in (-1, 1) for e in (0.25, 0.5, 0.6)
             for d in (-1e-3, -1e-10, 0.0, 1e-10, 1e-3)]
    m = len(edges)
    x2[k:k + m] = torch.tensor(edges, **f64)
    th = harmpi.calcthmksbl3(x2, r, p)
    th[k + m:k + m + 3] = torch.tensor([0.0, math.pi / 2, math.pi], **f64)
    tail = k + m + 3
    th[tail:tail + n // 10] = math.pi * torch.rand(n // 10, generator=g,
                                                   **f64)
    z = torch.zeros_like(r)
    x = torch.stack([z, r, th, z], dim=-1).to(device, dtype)
    return x[:, 1], x[:, 2]


def counted(fn):
    """fn()'s result and the obs counters it moved."""
    before = obs.counters()
    out = fn()
    after = obs.counters()
    after.subtract(before)
    return out, after


def sample_x(n, seed, device="cpu"):
    """An (n, 4) sample tensor over the synthetic dump's radii."""
    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64)
    r = torch.exp(math.log(1.5) + torch.rand(n, generator=g, **f64)
                  * math.log(40.0 / 1.5))
    th = math.pi * torch.rand(n, generator=g, **f64)
    ph = 2.0 * math.pi * torch.rand(n, generator=g, **f64)
    return torch.stack([torch.zeros_like(r), r, th, ph], -1).to(device)


# ---- the CPU: dispatch, counters, the wrapper's checks --------------------

@pytest.mark.parametrize("bl,twins,dtype", [(3, 2, torch.float64),
                                             (1, 0, torch.float64),
                                             (3, 2, torch.float32)])
def test_a_cpu_vals_takes_the_twin_and_counts_it(bl, twins, dtype):
    """A CPU HARMPI vals, float64 or float32: BL = 3 calls both twins, each
    counted as "harmpi.invert.twin.calls", and launches no kernel; BL = 1
    inverts in closed form and by Newton steps, neither."""
    model = load_fluid_model("HARMPI", device="cpu",
                             dump=grmhd_dump.harmpi_dump(12, 8, 4, bl=bl))
    x = sample_x(64, seed=bl).to(dtype)
    out, c = counted(lambda: model.vals(x, torch.zeros_like(x), A))
    assert c["harmpi.invert.twin.calls"] == twins
    assert c["harmpi.invert.kernel.launches"] == 0
    assert c["fluid.invert.samples"] == 64
    assert torch.isfinite(out.rho).all()


def test_the_twins_are_the_torch_bisections_bit_for_bit():
    """On the CPU x1_of_r and x2_of_th_bl3 return what they returned before
    the kernels: thickdisk.bisect over calcrmks on [-2, 12] and over
    calcthmksbl3 on [-1, 1], 60 steps each, bit for bit."""
    p, rin = benchmark_grid()
    r, th = samples(4096, p, rin, seed=1, device="cpu")
    x1 = harmpi.x1_of_r(r, p)
    x2 = harmpi.x2_of_th_bl3(th, r, p)
    assert torch.equal(x1, bisect(lambda v: harmpi.calcrmks(v, p), r,
                                  -2.0, 12.0, 60))
    assert torch.equal(x2, bisect(lambda v: harmpi.calcthmksbl3(v, r, p),
                                  th, -1.0, 1.0, 60))
    assert torch.equal(x1, harmpi.x1_of_r_twin(r, p))
    assert torch.equal(x2, harmpi.x2_of_th_bl3_twin(th, r, p))


def _operands():
    p, rin = benchmark_grid()
    r, th = samples(64, p, rin, seed=2, device="cpu")
    return th, r, p


@pytest.mark.parametrize("bad,error,x1_too", [
    (lambda th, r: (th, r), NotImplementedError, True),
    (lambda th, r: (th.float(), r), TypeError, False),
    (lambda th, r: (th, r.float()), TypeError, False),
    (lambda th, r: (th.half(), r.half()), TypeError, True),
    (lambda th, r: (th, r[:32]), ValueError, False),
    (lambda th, r: (th, torch.empty_like(r, device="meta")), ValueError,
     False),
], ids=["cpu", "float32", "r float32", "float16", "shape",
        "another device"])
def test_the_wrapper_raises_and_does_not_fall_back(bad, error, x1_too):
    """Each operand the kernels do not take (a CPU tensor, th and r of two
    dtypes, float16, two shapes, two devices) raises before any launch,
    and no twin is called: fluid.harmpi, not the wrapper, picks the
    twin."""
    th, r, p = _operands()
    th, r = bad(th, r)
    _, c = counted(lambda: pytest.raises(error, hi.x2_of_th_bl3, th, r, p))
    assert c["harmpi.invert.kernel.launches"] == 0
    assert c["harmpi.invert.twin.calls"] == 0
    if x1_too:
        _, c = counted(lambda: pytest.raises(error, hi.x1_of_r, r, p))
        assert c["harmpi.invert.kernel.launches"] == 0
        assert c["harmpi.invert.twin.calls"] == 0


def test_the_library_is_keyed_by_source_and_flags(tmp_path):
    """The library's name carries a hash of the source's bytes and of every
    nvcc flag, as the march's does."""
    path = _build.library_path(hi.SOURCE, hi.NVCC_FLAGS)
    assert path == _build.library_path(hi.SOURCE, hi.NVCC_FLAGS)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libharmpi_invert_")
    assert path != _build.library_path(hi.SOURCE)
    assert path != _build.library_path(hi.SOURCE, ("-fmad=true",))
    assert path != _build.library_path(fm.SOURCE, hi.NVCC_FLAGS)
    changed = tmp_path / hi.SOURCE.name
    changed.write_bytes(hi.SOURCE.read_bytes() + b"\n")
    assert _build.library_path(changed, hi.NVCC_FLAGS) != path


def test_the_float32_scalars_are_torchs():
    """The float32 kernels' scalars are what torch's float32 operations
    receive on the card: each float64 scalar cast to float32, a divisor's
    reciprocal too (torch forms it in float64 and casts it, which on this
    grid's r0 differs from the float32 reciprocal of the cast r0)."""
    p = benchmark_grid()[0]
    f64 = dict(zip(hi.PARAMS, hi.kernel_params(p)))
    f32 = dict(zip(hi.PARAMS, hi.kernel_params(p, torch.float32)))
    assert len(f64) == len(f32) == len(hi.PARAMS)
    assert f64["inv_r0jet"] == 1.0 / p.r0jet
    assert f64["inv_band"] == 1.0 / ((1 - p.fracjet) - p.fracdisk)
    for name in hi.PARAMS:
        assert f32[name] == torch.tensor(f64[name],
                                         dtype=torch.float32).item(), name
    one = torch.ones((), dtype=torch.float32)
    assert f32["inv_r0jet"] != (one / torch.tensor(
        p.r0jet, dtype=torch.float32)).item()


# ---- the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


TOL = {torch.float64: X_TOL, torch.float32: X_TOL32}
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])


def zones(x, lo, hi, nz):
    return torch.floor((x - lo) / (hi - lo) * nz)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernels_match_the_twins(dev, seed, dtype):
    """x1 and x2 of the kernels within X_TOL (X_TOL32) of the twins' on the
    card, on 2^20 + 3 samples (ragged against the 256-thread block), one
    launch each and no twin call; their zones on the benchmark's grid are
    the twins' on every sample."""
    p, rin = benchmark_grid()
    r, th = samples(2 ** 20 + 3, p, rin, seed, dev, dtype)
    (x1, x2), c = counted(lambda: (harmpi.x1_of_r(r, p),
                                   harmpi.x2_of_th_bl3(th, r, p)))
    torch.cuda.synchronize()
    assert c["harmpi.invert.kernel.launches"] == 2
    assert c["harmpi.invert.twin.calls"] == 0
    t1 = harmpi.x1_of_r_twin(r, p)
    t2 = harmpi.x2_of_th_bl3_twin(th, r, p)
    x1out = harmpi.x1_of_r_twin(
        torch.tensor([1e3], dtype=torch.float64, device=dev), p).item()
    for name, ours, twin, lo, hi_, nz in (
            ("x1", x1, t1, math.log(rin), x1out, ZONES[0]),
            ("x2", x2, t2, -1.0, 1.0, ZONES[1])):
        assert ours.shape == r.shape and ours.dtype == dtype
        assert torch.isfinite(ours).all()
        err = (ours - twin).abs().max().item()
        assert err <= TOL[dtype], (name, err)
        assert torch.equal(zones(ours, lo, hi_, nz), zones(twin, lo, hi_, nz))


@pytest.mark.cuda
@DTYPES
def test_kernels_take_every_size(dev, dtype):
    """No sample, one, one block of threads plus one."""
    p, rin = benchmark_grid()
    r, th = samples(4096, p, rin, 3, dev, dtype)
    for n in (0, 1, 257):
        x1 = harmpi.x1_of_r(r[:n], p)
        x2 = harmpi.x2_of_th_bl3(th[:n], r[:n], p)
        assert x1.shape == x2.shape == (n,)
        assert x1.dtype == x2.dtype == dtype
        if n:
            t1 = harmpi.x1_of_r_twin(r[:n], p)
            t2 = harmpi.x2_of_th_bl3_twin(th[:n], r[:n], p)
            assert (x1 - t1).abs().max().item() <= TOL[dtype]
            assert (x2 - t2).abs().max().item() <= TOL[dtype]


def _twins(monkeypatch):
    monkeypatch.setattr(harmpi, "_kernel_takes", lambda t: False)


@pytest.mark.cuda
@DTYPES
def test_vals_picks_the_twins_rows(dev, monkeypatch, dtype):
    """The nearest rows vals gathers (ix1, ix2, ix3 as one row index) are
    the same with the kernels as with the twins, on every sample."""
    model = load_fluid_model("HARMPI", device=dev,
                             dump=grmhd_dump.harmpi_dump(96, 64, 8, bl=3))
    x = sample_x(2 ** 18, seed=4, device=dev).to(dtype)
    kept = []
    gather = harmpi.quad_gather_rows

    def spy(table, idx, *args):
        kept.append(idx.clone())
        return gather(table, idx, *args)

    monkeypatch.setattr(harmpi, "quad_gather_rows", spy)
    _, c = counted(lambda: model.vals(x, torch.zeros_like(x), A))
    assert c["harmpi.invert.kernel.launches"] == 2
    _twins(monkeypatch)
    _, c = counted(lambda: model.vals(x, torch.zeros_like(x), A))
    assert c["harmpi.invert.twin.calls"] == 2
    assert c["harmpi.invert.kernel.launches"] == 0
    assert torch.equal(kept[0], kept[1])


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f64", "mixed"])
def test_a_frame_through_the_kernels_matches_the_twins(dev, monkeypatch,
                                                       prec):
    """grtrans_run of a HARMPI BL = 3 frame at 64x64x400 lsoda (the
    benchmark's camera, electron model and sigma cut), in float64 and in
    the mixed precision that samples the fluid in float32: two kernel
    launches and no twin call a sampled camera; then with the twins,
    within IMAGE_TOL of max|I|."""
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.orchestrator import grtrans_run

    model = load_fluid_model("HARMPI", device=dev,
                             dump=grmhd_dump.harmpi_dump(96, 64, 16, bl=3))
    cfg = GrtransConfig(
        fname="HARMPI", ename="POLSYNCHTH", nvals=4, spin=A,
        nn=(64, 64, 400), uout=0.04, mbh=4e6, mumin=0.6, mumax=0.6,
        fmin=2.3e11, fmax=2.3e11, iname="lsoda", mdotmin=1.2e17,
        mdotmax=1.2e17, gmin=-1.0, sigcut=1.0,
        gridvals=(-15.0, 15.0, -15.0, 15.0), prec=prec)
    (ivals, _, _), c = counted(lambda: grtrans_run(cfg, model, device=dev))
    assert c["harmpi.invert.kernel.launches"] == 2
    assert c["harmpi.invert.twin.calls"] == 0
    _twins(monkeypatch)
    (twin, _, _), c = counted(lambda: grtrans_run(cfg, model, device=dev))
    assert c["harmpi.invert.twin.calls"] == 2
    assert c["harmpi.invert.kernel.launches"] == 0
    ivals, twin = torch.as_tensor(ivals), torch.as_tensor(twin)
    assert torch.isfinite(ivals).all()
    imax = twin[..., 0].abs().max().item()
    assert imax > 0.0
    assert (ivals - twin).abs().max().item() <= IMAGE_TOL * imax
    # two sampled cameras, two frequencies of one camera: launches a camera
    cfg2 = dataclasses.replace(cfg, mumin=0.4, mumax=0.8, nmu=2,
                               nn=(16, 16, 64))
    monkeypatch.undo()
    _, c = counted(lambda: grtrans_run(cfg2, model, device=dev))
    assert c["harmpi.invert.kernel.launches"] == 4
