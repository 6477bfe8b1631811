"""The Stokes march as one CUDA kernel (ops/formal_march.py,
csrc/formal_march.cu) against the torch march it replaces on the card
(integrate.solvers._twin_march: _march fed by _formal_maps).

On the CPU (tier 1): formal_solve's dispatch and the obs counters that
show it, and the wrapper's checks.  On the card (marker `cuda`; no JAX
here, so run with `--noconftest`):

    python -m pytest --noconftest -m cuda tests/test_torch_march_kernel.py -q

the kernel and the twin on the same clamped coefficients and mask, within
1e-12 of max|I| in float64 and 4e-5 in the mixed leg's float32, each
launch synchronized so that a fault shows where it happened; then the
FFJET and HARM3D frames at 64x64x400 through grtrans_run, kernel against
twin, in both precisions.  Kernel and twin do the same arithmetic in the
same precision, so the bars are rounding's: on an H100 the largest reading
over these cases, six seeds each, and the frames here and at 256x256x400
was 3.4e-15 (float64) and 3.7e-6 (float32) of max|I|; the float32 bar is
about ten times that, far below the 2e-3 that holds mixed against float64
(tests/test_torch_precision.py), which a fault of the float32 branch alone
could hide under.

The cases (coefficients()), at 300 pixels (ragged against the kernel's
128-thread block) x 77 points (76 cells: ragged against BLK), the first
three pixels masked whole:
  generic          random passive coefficients, tau << 1: the Taylor form;
  thick            opacity x 300, tau ~ 100: deep cells, the exact
                   emission, the photosphere stop at max_tau;
  faraday_thick    |rho| dlam ~ 1e2 a cell;
  scrambled        every other pixel's Faraday phase past phase_max;
  degenerate       |a_pol|, |rho| 1e-9 of aI: the cubic nilpotent O;
  near_degenerate  lam dlam on both sides of the degenerate threshold in
                   float64 (a tenth of the cells below it), all below it
                   in float32;
  overflow         every third pixel's |rho| x 1e150 (x 1e30 in float32):
                   the eigen form overflows to NaN (`bad`), so does the
                   cubic, and the cell takes exp(-aI dlam) I with the
                   trapezoid's emission;
  rotation         aI = a_pol = 0: a singular K in deep cells, the
                   trapezoid.
"""

import math
import re

import numpy as np
import pytest
import torch

from grtrans_tpu_torch import obs
from grtrans_tpu_torch.integrate import solvers
from grtrans_tpu_torch.integrate.solvers import BLK
from grtrans_tpu_torch.ops import _build
from grtrans_tpu_torch.ops import formal_march as fm
from grtrans_tpu_torch.ops import harmpi_invert as hi
from grtrans_tpu_torch.ops import quad_gather as qg
from grtrans_tpu_torch.ops import render_polsynchth as rp

torch.set_num_threads(1)   # the suite runs in parallel worker processes

NPIX, NPTS = 300, 77
MASKED = 3                 # leading pixels masked whole
TOL = {torch.float64: 1e-12, torch.float32: 4e-5}   # of max|I|
CASES = ("generic", "thick", "faraday_thick", "scrambled", "degenerate",
         "near_degenerate", "overflow", "rotation")
I0 = np.array([2e-2, 3e-3, -1e-3, 5e-4])


def coefficients(case, npix=NPIX, npts=NPTS, seed=0, big=1e150):
    """lam (npix, npts), j (.., 4), K (.., 7), mask (npix, npts) as numpy
    float64 arrays of the named case (`big`: the overflow case's factor)."""
    rng = np.random.default_rng(seed)
    shape = (npix, npts)
    lam = np.cumsum(rng.uniform(0.5, 1.5, shape), axis=-1)
    lam -= lam[:, :1]
    aI = 10.0 ** rng.uniform(-4.0, -2.0, shape)
    apol = rng.normal(size=shape + (3,))
    apol *= (0.8 * aI * rng.uniform(0, 1, shape)
             / np.linalg.norm(apol, axis=-1))[..., None]
    rho = rng.normal(size=shape + (3,)) * aI[..., None]
    if case == "thick":
        aI, apol = aI * 300.0, apol * 300.0
    elif case == "faraday_thick":
        rho *= 1e4
    elif case == "scrambled":
        rho[::2] *= 3e16
    elif case == "degenerate":
        apol, rho = apol * 1e-9, rho * 1e-9
    elif case == "near_degenerate":
        f = 10.0 ** rng.uniform(-4.0, -2.5, shape)[..., None]
        apol, rho = apol * f, rho * f
    elif case == "overflow":
        rho[::3] *= big
    elif case == "rotation":
        aI, apol = 0.0 * aI, 0.0 * apol
        rho = rng.normal(size=shape + (3,)) * rng.uniform(0.5, 2.0, shape +
                                                          (1,))
    jI = 10.0 ** rng.uniform(-3.0, -1.0, shape)
    jpol = rng.normal(size=shape + (3,))
    jpol *= (0.7 * jI / np.linalg.norm(jpol, axis=-1))[..., None]
    j = np.concatenate([jI[..., None], jpol], -1)
    K = np.concatenate([aI[..., None], apol, rho], -1)
    mask = rng.uniform(size=shape) > 0.05
    mask[:MASKED] = False
    return lam, j, K, mask


def tensors(case, device, prec="f64", seed=0, **kw):
    """coefficients() as tensors: lam float64, j and K float64 or, mixed,
    float32."""
    dt = torch.float32 if prec == "mixed" else torch.float64
    lam, j, K, mask = coefficients(
        case, seed=seed, big=1e150 if dt == torch.float64 else 1e30, **kw)
    return (torch.tensor(lam, device=device),
            torch.tensor(j, dtype=dt, device=device),
            torch.tensor(K, dtype=dt, device=device),
            torch.tensor(mask, device=device))


def counted(fn):
    """fn()'s result and the obs counters it moved."""
    before = obs.counters()
    out = fn()
    after = obs.counters()
    after.subtract(before)
    return out, after


# ---- the CPU: dispatch, counters, the wrapper's checks --------------------

@pytest.mark.parametrize("path", ["observer", "profile", "gradient"])
@pytest.mark.parametrize("substeps", [1, 2])
def test_the_cpu_takes_the_twin_and_counts_it(path, substeps):
    """formal_solve on the CPU, observer-only, per-sample profile or with a
    gradient recorded: the torch march, counted as "march.twin.calls", no
    kernel launch, and "march.blocks" = ceil(ncell / BLK)."""
    lam, j, K, mask = tensors("generic", "cpu", npix=40)
    if path == "gradient":
        K.requires_grad_(True)
    out, c = counted(lambda: solvers.formal_solve(
        lam, j, K, mask, substeps=substeps, profile=path == "profile"))
    assert c["march.twin.calls"] == 1
    assert c["march.kernel.launches"] == 0
    assert c["march.blocks"] == math.ceil((NPTS - 1) / BLK) == 10
    assert out.shape == ((40, NPTS, 4) if path == "profile" else (40, 4))
    assert out.requires_grad == (path == "gradient")
    assert torch.isfinite(out).all()


def test_observed_stokes_counts_one_twin_call_a_march():
    """lsoda and formal through observed_stokes: one twin call each; DELO's
    profile march is the twin too."""
    lam, j, K, mask = tensors("generic", "cpu", npix=16)
    _, c = counted(lambda: [solvers.observed_stokes(lam, j, K, m, mask=mask)
                            for m in ("formal", "lsoda", "delo")])
    assert c["march.twin.calls"] == 3 and c["march.kernel.launches"] == 0
    assert c["march.blocks"] == 3 * 10


def _wrapper_operands(dt=torch.float64):
    lam, j, K, mask = tensors("generic", "cpu", npix=8)
    return dict(lam=lam.to(dt), j=j.to(dt), K=K.to(dt),
                cell_ok=mask[:, 1:] & mask[:, :-1], I0=None,
                dlam64=None if dt == torch.float64 else
                lam[:, 1:] - lam[:, :-1])


@pytest.mark.parametrize("bad,error", [
    (dict(lam=lambda o: o["lam"][:, :, None]), ValueError),
    (dict(lam=lambda o: o["lam"].to(torch.float16)), TypeError),
    (dict(j=lambda o: o["j"][:, :, :3]), ValueError),
    (dict(K=lambda o: o["K"].float()), ValueError),
    (dict(cell_ok=lambda o: o["cell_ok"].to(torch.uint8)), ValueError),
    (dict(cell_ok=lambda o: o["cell_ok"][:, 1:]), ValueError),
    (dict(I0=lambda o: torch.zeros(8, 3, dtype=torch.float64)), ValueError),
    (dict(dlam64=lambda o: o["lam"][:, 1:] - o["lam"][:, :-1]), TypeError),
    (dict(j=lambda o: o["j"].transpose(0, 1).contiguous()
          .transpose(0, 1)), ValueError),
    (dict(K=lambda o: o["K"].transpose(0, 1).contiguous()
          .transpose(0, 1)), ValueError),
    ({}, NotImplementedError),
], ids=["lam 3-D", "lam float16", "j 3 columns", "K float32",
        "cell_ok uint8", "cell_ok short", "I0 3 columns",
        "float64 with dlam64", "j non-contiguous", "K non-contiguous",
        "cpu"])
def test_the_wrapper_raises_and_does_not_fall_back(bad, error):
    """Each operand the kernel does not take raises before any launch; a
    CPU tensor raises too (formal_solve, not the wrapper, picks the
    twin)."""
    ops = _wrapper_operands()
    for key, make in bad.items():
        ops[key] = make(ops)
    _, c = counted(lambda: pytest.raises(error, fm.formal_march, **ops))
    assert c["march.kernel.launches"] == 0 and c["march.twin.calls"] == 0


def test_the_wrapper_wants_dlam64_with_float32():
    ops = _wrapper_operands(torch.float32)
    ops["dlam64"] = None
    with pytest.raises(TypeError, match="dlam64"):
        fm.formal_march(**ops)
    ops = _wrapper_operands(torch.float32)
    with pytest.raises(NotImplementedError):
        fm.formal_march(**ops)


@pytest.mark.parametrize("source", ["formal_march", "quad_gather"])
def test_the_library_is_keyed_by_source_and_flags(tmp_path, source):
    """A built library's name carries a hash of its source's bytes and of
    every nvcc flag: another flag set, or a changed source, never loads a
    library built before it."""
    src = _build.BUILD_DIR.parent / "csrc" / f"{source}.cu"
    path = _build.library_path(src, fm.NVCC_FLAGS)
    assert path == _build.library_path(src, fm.NVCC_FLAGS)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith(f"lib{source}_")
    assert path != _build.library_path(src)
    assert path != _build.library_path(src, ("-fmad=true",))
    changed = tmp_path / src.name
    changed.write_bytes(src.read_bytes() + b"\n")
    assert _build.library_path(changed, fm.NVCC_FLAGS) != path


@pytest.mark.parametrize("module", [fm, hi, qg, rp],
                         ids=["formal_march", "harmpi_invert", "quad_gather",
                              "render_polsynchth"])
def test_the_signatures_match_the_sources(module):
    """Each wrapper's ctypes table (ARGTYPES, which ops/_build.load binds)
    against its csrc/*.cu: every entry point declared there is in the
    table and none other, each parameter of the type the table gives it,
    one by one.  A signature that drifted from its source would pass
    arguments of the wrong width on the card."""
    declared = _build.entry_points(module.SOURCE)
    assert declared, f"no extern \"C\" entry point in {module.SOURCE.name}"
    assert sorted(declared) == sorted(module.ARGTYPES)
    for name, types in declared.items():
        assert types == list(module.ARGTYPES[name]), name


def test_load_refuses_a_drifted_signature(tmp_path):
    """A source whose entry point lost a parameter (as quad_gather_rows_*
    lost one) is refused before anything is built or loaded."""
    old = tmp_path / "quad_gather.cu"
    old.write_text(re.sub(r"(quad_gather_rows_f64\([^)]*?)void\* stream",
                          r"\1int dedup, void* stream",
                          qg.SOURCE.read_text(), count=1))
    assert _build.entry_points(old) != _build.entry_points(qg.SOURCE)
    with pytest.raises(ValueError, match="differ from the signatures"):
        _build.load(old, qg.NVCC_FLAGS, qg.ARGTYPES)


# ---- the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def kernel_and_twin(monkeypatch, lam, j, K, mask, I0, substeps):
    """formal_solve(profile=False) on the card, which must launch the kernel
    once and call no twin, and the twin on the operands the kernel got."""
    seen = []
    kernel = solvers._kernel_march

    def spy(*args):
        seen.append(args)
        return kernel(*args)

    monkeypatch.setattr(solvers, "_kernel_march", spy)
    out, c = counted(lambda: solvers.formal_solve(
        lam, j, K, mask, I0=I0, substeps=substeps, profile=False))
    torch.cuda.synchronize()
    name = "f32" if j.dtype == torch.float32 else "f64"
    assert c["march.kernel.launches"] == 1
    assert c[f"march.kernel.launches.{name}"] == 1
    assert c["march.twin.calls"] == 0
    assert c["march.blocks"] == math.ceil((lam.shape[1] - 1) / BLK)
    twin = solvers._twin_march(*seen[0])
    torch.cuda.synchronize()
    return out, twin


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [1, 2, 4])
@pytest.mark.parametrize("prec", ["f64", "mixed"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_the_torch_march(dev, monkeypatch, case, prec,
                                        substeps):
    lam, j, K, mask = tensors(case, dev, prec, seed=substeps)
    start = torch.tensor(I0, device=dev) if case == "generic" else None
    out, twin = kernel_and_twin(monkeypatch, lam, j, K, mask, start,
                                substeps)
    assert out.shape == (NPIX, 4) and out.dtype == j.dtype
    assert torch.isfinite(out).all() and torch.isfinite(twin).all()
    start = (torch.zeros(4, dtype=j.dtype, device=dev) if start is None
             else start.to(j.dtype))
    assert (out[:MASKED] == start).all()
    err = (out - twin).abs().max().item()
    assert err <= TOL[j.dtype] * twin[:, 0].abs().max().item(), err


@pytest.mark.cuda
def test_kernel_takes_every_ray_shape(dev, monkeypatch):
    """One pixel, one sample (no cell), two samples, and one block of
    threads plus one pixel."""
    for npix, npts in ((1, 77), (5, 1), (5, 2), (129, 9)):
        lam, j, K, mask = tensors("thick", dev, npix=npix, npts=npts)
        mask[:] = True
        out, twin = kernel_and_twin(monkeypatch, lam, j, K, mask, None, 2)
        err = (out - twin).abs().max().item()
        assert err <= 1e-12 * twin[:, 0].abs().max().item(), (npix, npts)


def _frame(name, dev, tmp_path):
    from grtrans_tpu_torch import convert
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid.ffjet import load_ffjet_file
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.testing import grmhd_dump
    from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump

    if name == "ffjet":
        dfile = tmp_path / "ffjet.bin"
        write_ffjet_dump(dfile)
        cfg = GrtransConfig(
            fname="FFJET", ename="POLSYNCHPL", nvals=4, spin=0.998,
            nn=(64, 64, 400), uout=0.01, mbh=3.4e9, mumin=0.906,
            mumax=0.906, fmin=3.45e11, fmax=3.45e11,
            gridvals=(-40.0, 20.0, -20.0, 40.0), iname="lsoda")
        return cfg, convert.ffjet_from_arrays(*load_ffjet_file(dfile),
                                              device=dev)
    cfg = GrtransConfig(
        fname="HARM3D", ename="POLSYNCHTH", nvals=4, spin=0.9375,
        nn=(64, 64, 400), uout=0.04, mbh=4.3e6, mumin=0.5, mumax=0.5,
        fmin=2.3e11, fmax=2.3e11, iname="lsoda", mdotmin=4e13,
        mdotmax=4e13, gmin=10.0, muval=0.25,
        gridvals=(-15.0, 15.0, -15.0, 15.0))
    model = load_fluid_model("HARM3D", device=dev,
                             dump=grmhd_dump.harm3d_dump(32, 24, 16))
    return cfg, model


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f64", "mixed"])
@pytest.mark.parametrize("name", ["ffjet", "harm3d"])
def test_a_frame_through_the_kernel_matches_the_twin(dev, monkeypatch,
                                                     tmp_path, name, prec):
    """grtrans_run at 64x64x400 lsoda, float64 or mixed: one kernel launch
    of its instantiation a render and no twin call; then the same frame
    with the twin in the kernel's place, within TOL of max|I|."""
    import dataclasses

    from grtrans_tpu_torch.orchestrator import grtrans_run

    cfg, model = _frame(name, dev, tmp_path)
    cfg = dataclasses.replace(cfg, prec=prec)
    (ivals, _, _), c = counted(lambda: grtrans_run(cfg, model, device=dev))
    inst = "f32" if prec == "mixed" else "f64"
    assert c[f"march.kernel.launches.{inst}"] == 1
    assert c["march.twin.calls"] == 0
    monkeypatch.setattr(solvers, "_kernel_march",
                        lambda *args: solvers._twin_march(*args))
    (twin, _, _), c = counted(lambda: grtrans_run(cfg, model, device=dev))
    assert c["march.twin.calls"] == 1 and c["march.kernel.launches"] == 0
    ivals, twin = torch.as_tensor(ivals), torch.as_tensor(twin)
    assert torch.isfinite(ivals).all()
    imax = twin[..., 0].abs().max().item()
    assert imax > 0.0
    tol = TOL[torch.float32 if prec == "mixed" else torch.float64]
    assert (ivals - twin).abs().max().item() <= tol * imax
