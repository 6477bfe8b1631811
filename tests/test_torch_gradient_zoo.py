"""The mu0 gradient through every snapshot model, and the two rules that
make it finite and smooth, on the CPU, the port alone (no JAX compile).

Set-up (ROADMAP Queue 3): d(sum|image|)/d(mu0) at mu0 = 0.6 through
tools/invert.InverseProblem, POLSYNCHTH, mbh 4.3e6, 8x8 pixels x 32 points
from uout = 0.04, gridvals +-15, source mdot 4e13, mu 0.25, gmin 10, the
spin of testing/grmhd_dump; 16x12x8 synthetic dumps (KORAL 24x12 and
24x12x6), against central differences at h = 1e-5, bar 1e-2.  Measured
|autograd - central difference| / |central difference|: HARM 6.1e-5,
HARM3D 8.2e-5, IHARM 1.5e-5, HARMPI BL=1 1.6e-6, BL=3 1.7e-7, KORAL
6.1e-8, KORAL3D 5.2e-8, THICKDISK 5.1e-4, MB09 4.7e-4.

What was wrong before:
- KORAL, KORAL3D: a cell of the synthetic dump has a Faraday phase
  |rho_V| dlam of ~3e15 rad, which float64 holds to ~0.5 rad: the forward
  was rounding there, and its autograd gradient 1e12-1e13 (measured
  5.45e12 and -3.59e12 on this set-up).  integrate/solvers._calc_O now
  gives a cell whose phase is beyond phase_max (9.0e12 rad in float64) its
  phase-averaged rotation.  The port's gradients are 8.613e-4 (KORAL) and
  8.940e-4 (KORAL3D); grtrans_tpu's jax.grad on this set-up gives
  2.2784e-3 and 2.3622e-3 (its central differences agree with it; its
  losses are 5.193e-4 and 5.409e-4 against the port's 3.308e-4 and
  3.399e-4): a factor 2.6 apart, as the forwards are apart, on the
  Faraday-thick cells, where grtrans_tpu keeps the rounding phase and its
  matricant loses the small eigenvalue (ROADMAP, known faults of the
  reference).
- THICKDISK, MB09: NaN.  Samples off the grid (rho = 0) and samples whose
  b.b < 0 (bmag = 0) gave sqrt(0) and 1/0 factors infinite derivatives in
  convert (fluid/base.scale_sim_units, monika_e) and in the emissivity
  (polsynch.bnu at T = 0, the Faraday fits' root at B = 0); each now takes
  a safe operand under a double torch.where, the forward unchanged bit for
  bit (test_thickdisk_mb09_forward_is_unchanged).
"""

import math

import pytest
import torch

from grtrans_tpu_torch.emis import polsynch
from grtrans_tpu_torch.fluid import base
from grtrans_tpu_torch.integrate import solvers
from grtrans_tpu_torch.orchestrator import grtrans_run
from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.testing import grmhd_dump as gd
from grtrans_tpu_torch.tools.invert import InverseProblem

torch.set_num_threads(1)   # the suite runs in parallel worker processes

# the models of tests/test_torch_zoo.py's ZOO and tests/test_torch_grmhd.py
ZOO = {
    "HARM": ("HARM", lambda: gd.harm_dump(16, 12)),
    "HARM3D": ("HARM3D", lambda: gd.harm3d_dump(16, 12, 8)),
    "IHARM": ("IHARM", lambda: gd.iharm_dump(16, 12, 8)),
    "HARMPI_bl1": ("HARMPI", lambda: gd.harmpi_dump(16, 12, 8, bl=1)),
    "HARMPI_bl3": ("HARMPI", lambda: gd.harmpi_dump(16, 12, 8, bl=3)),
    "KORAL": ("KORAL", lambda: gd.koral_dump(24, 12)),
    "KORAL3D": ("KORAL3D", lambda: gd.koral_dump(24, 12, 6)),
    "THICKDISK": ("THICKDISK", lambda: gd.thickdisk_dump(16, 12, 8)),
    "MB09": ("MB09", lambda: gd.mb09_dump(16, 12, 8)),
}
SOURCE = dict(mdot=4e13, mu=0.25, gmin=10.0)
MU0, H = 0.6, 1e-5


def f64(v, grad=False):
    return torch.tensor(v, dtype=torch.float64, requires_grad=grad)


@pytest.mark.parametrize("case", sorted(ZOO))
def test_snapshot_mu0_gradient_matches_central_differences(case):
    fname, dump = ZOO[case]
    prob = InverseProblem(fname=fname, ename="POLSYNCHTH", mbh=4.3e6,
                          nn=(8, 8, 32), uout=0.04,
                          gridvals=(-15.0, 15.0, -15.0, 15.0),
                          fixed=dict(dump=dump()), source=SOURCE,
                          device="cpu")

    def loss(mu0):
        return prob.render({"spin": f64(gd.A), "mu0": mu0}).abs().sum()

    mu0 = f64(MU0, grad=True)
    loss(mu0).backward()
    with torch.no_grad():
        fd = (loss(f64(MU0 + H)) - loss(f64(MU0 - H))).item() / (2 * H)
    ad = mu0.grad.item()
    assert math.isfinite(ad) and abs(ad - fd) <= 1e-2 * abs(fd), (ad, fd)


def _cells(n=512, seed=0):
    """Seeded cells: aI, a_pol, rho of random direction and size, and
    steps; the phases span 1e-2 .. 1e16 rad."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g,
                                           dtype=torch.float64)

    def unit():
        v = torch.randn(n, 3, generator=g, dtype=torch.float64)
        return v / v.norm(dim=1, keepdim=True)

    aI = 10 ** u(-6, 0, n)
    apol = (aI * u(0, 0.9, n))[:, None] * unit()
    rho = (10 ** u(-2, 16, n))[:, None] * unit()
    dx = 10 ** u(-2, 0, n)
    return (aI,) + tuple(apol.unbind(1)), tuple(rho.unbind(1)), dx


def test_calc_O_phase_rule(monkeypatch):
    """Below phase_max (9.0e12 rad in float64) _calc_O is the formula as it
    was, bit for bit (the rule switched off by PHASE_TOL = inf); above it
    the cell's O does not depend on the phase's rounding: a step 1e-13
    longer turns a phase of 1e13-1e16 rad by 1 .. 1e3 rad, which moves the
    formula's O by O(1) and the rule's by the change of its attenuation
    alone (measured 3.6e-14)."""
    a, rho, dx = _cells()
    ruled = solvers._calc_O(a, rho, dx)
    ph = solvers._lam12(*a[1:], *rho, torch.finfo(dx.dtype).eps)[4] * dx
    thick = ph.abs() > solvers.phase_max(torch.float64)
    assert 0 < int(thick.sum()) < thick.numel()
    longer = solvers._calc_O(a, rho, dx * (1 + 1e-13))
    monkeypatch.setattr(solvers, "PHASE_TOL", math.inf)
    formula = solvers._calc_O(a, rho, dx)
    assert torch.equal(ruled[..., ~thick], formula[..., ~thick])
    moved = (solvers._calc_O(a, rho, dx * (1 + 1e-13)) - formula)[..., thick]
    assert moved.abs().amax() > 0.1
    assert (longer - ruled)[..., thick].abs().amax() <= 1e-12
    assert torch.isfinite(ruled).all()
    assert ruled.abs().amax() <= 1.0 + 1e-6


# the formulas of fluid/base.py and emis/polsynch.py before their safe
# operands, as they were: the forward must not have moved
def _scale_sim_units_as_was(mbh, mdotcgs, mdot_code, rho, p, bmag):
    from grtrans_tpu_torch import constants as pc
    lcgs = pc.G * mbh * pc.msun / pc.c ** 2
    tcgs = lcgs / pc.c
    rhocgs = mdotcgs / mdot_code / lcgs ** 3 * tcgs * rho
    ncgs = rhocgs / pc.mp
    safe = torch.where(rho > 0, rho, 1.0)
    pcgs = p * rhocgs / safe * pc.c ** 2
    tempcgs = pcgs / ncgs.clamp_min(1e-37) / pc.k
    bcgs = bmag * (rhocgs / safe).sqrt() * pc.c * math.sqrt(4.0 * math.pi)
    return ncgs, bcgs, tempcgs, rhocgs


def _monika_e_as_was(rho, p, b, rlow, rhigh):
    beta = p / (b * b).clamp_min(1e-37) / 0.5
    b2 = beta * beta
    return torch.where(b > 0.0,
                       rhigh * b2 / (1.0 + b2) + rlow / (1.0 + b2), rhigh)


def _bnu_as_was(T, nu):
    from grtrans_tpu_torch import constants as pc
    x = pc.h * nu / (pc.k * T)
    rj = 2.0 * nu * nu * pc.k * T / pc.c2
    planck = 2.0 * pc.h * nu ** 3 / pc.c2 / torch.expm1(x.clamp_min(1e-6))
    return torch.where(x < 1e-6, rj, planck).clamp_min(2.2e-16)


def _xarg_as_was(thetae, sth, omega0, nu):
    return thetae * torch.sqrt(math.sqrt(2.0) * sth
                               * (1e3 * omega0 / (2.0 * math.pi * nu)))


@pytest.mark.parametrize("case", ["THICKDISK", "MB09"])
def test_thickdisk_mb09_forward_is_unchanged(case, monkeypatch):
    """The THICKDISK and MB09 images of the gradient's camera (8x8 x 32,
    whose rays cross the samples off the grid and those with bmag = 0)
    equal, bit for bit, the images rendered with the formulas as they were
    before their safe operands."""
    fname, dump = ZOO[case]
    cfg = GrtransConfig(fname=fname, ename="POLSYNCHTH", nvals=4,
                        spin=gd.A, nn=(8, 8, 32), uout=0.04, mbh=4.3e6,
                        mumin=MU0, mumax=MU0, fmin=2.3e11, fmax=2.3e11,
                        iname="formal", mdotmin=4e13, mdotmax=4e13,
                        gmin=10.0, muval=0.25,
                        gridvals=(-15.0, 15.0, -15.0, 15.0),
                        fargs=dict(dump=dump()))
    now, _, _ = grtrans_run(cfg, device="cpu")
    monkeypatch.setattr(base, "scale_sim_units", _scale_sim_units_as_was)
    monkeypatch.setattr(base, "monika_e", _monika_e_as_was)
    monkeypatch.setattr(polsynch, "bnu", _bnu_as_was)
    monkeypatch.setattr(polsynch, "_xarg", _xarg_as_was)
    was, _, _ = grtrans_run(cfg, device="cpu")
    assert torch.isfinite(now).all() and now.abs().max() > 0
    assert torch.equal(now, was)
