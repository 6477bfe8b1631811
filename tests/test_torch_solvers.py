"""Parity of the port's observer-only formal solver with grtrans_tpu's
formal_solve, both its sequential march (seq=True, profile=False) and its
associative scan (seq=False), on random passive coefficients at 256
pixels x 80 points.  Tolerance: max|d| <= 1e-12 * max|ref| per Stokes
component.

The Faraday-thick case (|rho| dlam ~ 1e2 a cell, |rho| >> |a|) is held
against an independent reference instead of grtrans_tpu: there
grtrans_tpu's small matricant eigenvalue lam1 = sqrt(rt - (p2 - a2)/2)
cancels (its O is 2.5e-7 of max|O| off, its small I<->QUV entries up to
3.7 times their own size), while the port takes it from the product
lam1 lam2 = |a.rho| (3.7e-14 and 2.8e-11).  Reference: exp(-K dlam) of
each cell by scaling and squaring in extended precision
(numpy.longdouble), checked against scipy.linalg.expm on every 97th cell
at 1e-11 (measured 1.2e-12: at these norms, |K dlam| ~ 200, scipy's expm
is not good to 1e-12 of max|O|).  Bars: every entry of O within 1e-12 of
max|O|, the small I<->QUV entries within 1e-8 of their own size, and the
Stokes profile of a test-side march built on those O within 1e-10 of its
largest value per component."""

import numpy as np
import pytest
import scipy.linalg
import torch

from grtrans_tpu.integrate import solvers as jsol
from grtrans_tpu_torch.integrate import solvers as tsol

torch.set_num_threads(1)   # the suite runs in parallel worker processes

NPIX, NPTS = 256, 80


def _coefficients(case, seed=0):
    rng = np.random.default_rng(seed)
    lam = np.cumsum(rng.uniform(0.5, 1.5, (NPIX, NPTS)), axis=-1)
    lam -= lam[:, :1]
    aI = 10.0 ** rng.uniform(-4.0, -2.0, (NPIX, NPTS))
    apol = rng.normal(size=(NPIX, NPTS, 3))
    apol *= (0.8 * aI * rng.uniform(0, 1, (NPIX, NPTS))
             / np.linalg.norm(apol, axis=-1))[..., None]
    rho = rng.normal(size=(NPIX, NPTS, 3)) * aI[..., None]
    if case == "faraday_thick":
        rho *= 1e4                       # |rho| dlam ~ 1e2 per cell
    if case == "tau_over_10":
        aI = aI * 300.0                  # total tau ~ 100: truncation
        apol *= 300.0
    jI = 10.0 ** rng.uniform(-3.0, -1.0, (NPIX, NPTS))
    jpol = rng.normal(size=(NPIX, NPTS, 3))
    jpol *= (0.7 * jI / np.linalg.norm(jpol, axis=-1))[..., None]
    j = np.concatenate([jI[..., None], jpol], -1)
    K = np.concatenate([aI[..., None], apol, rho], -1)
    mask = rng.uniform(size=(NPIX, NPTS)) > 0.05
    return lam, j, K, mask


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert (np.abs(a - b).max(0) <= rtol * np.abs(b).max(0)).all()


@pytest.mark.parametrize("case,rtol", [("generic", 1e-12),
                                       ("tau_over_10", 1e-12)])
def test_observed_stokes(case, rtol):
    lam, j, K, mask = _coefficients(case)
    lam_t, j_t, K_t, mask_t = (torch.tensor(x) for x in (lam, j, K, mask))
    ours = tsol.observed_stokes(lam_t, j_t, K_t, mask=mask_t)
    seq = jsol.formal_solve(lam, j, K, mask, seq=True, profile=False)
    scan = jsol.formal_solve(lam, j, K, mask, seq=False)[:, 0, :]
    assert ours.shape == (NPIX, 4)
    assert np.isfinite(np.asarray(seq)).all()
    _close(ours, seq, rtol)
    _close(ours, scan, rtol)
    if case == "tau_over_10":
        tau, _ = jsol._cell_tau_mask(lam, K, None, jsol.MAX_TAU)
        assert (np.asarray(tau)[:, -1] > 10.0).mean() > 0.9


def _opacity(K):
    """(..., 4, 4) opacity matrices from (..., 7) coefficient rows."""
    aI, aQ, aU, aV, rQ, rU, rV = np.moveaxis(K, -1, 0)
    return np.stack([np.stack(r, -1) for r in (
        (aI, aQ, aU, aV), (aQ, aI, rV, -rU), (aU, -rV, aI, rQ),
        (aV, rU, -rQ, aI))], -2)


def _expm_longdouble(A):
    """exp(A) of a stack of 4x4 matrices: Taylor series of A / 2^s to 24
    terms with |A / 2^s|_1 <= 1/4, then s squarings, in numpy.longdouble."""
    A = A.astype(np.longdouble)
    norm = np.abs(A).sum(-2).max(-1)
    s = np.maximum(0, np.ceil(np.log2(norm.astype(float) * 4.0))).astype(int)
    B = A / (np.longdouble(2.0) ** s)[:, None, None]
    E = np.broadcast_to(np.eye(4, dtype=np.longdouble), A.shape).copy()
    term = E.copy()
    for k in range(1, 25):
        term = term @ B / k
        E = E + term
    for step in range(s.max()):
        sq = E @ E
        E = np.where((step < s)[:, None, None], sq, E)
    return E


def _faraday_thick_cells():
    """The midpoint coefficients and widths of every cell of the
    Faraday-thick case, and exp(-K dlam) of each from the reference."""
    lam, j, K, mask = _coefficients("faraday_thick")
    Kc = (0.5 * (K[:, 1:] + K[:, :-1])).reshape(-1, 7)
    dl = np.diff(lam, axis=-1).reshape(-1)
    ref = _expm_longdouble(-_opacity(Kc) * dl[:, None, None])
    return Kc, dl, ref.astype(np.float64)


def test_faraday_thick_matricant_matches_expm():
    Kc, dl, ref = _faraday_thick_cells()
    # the extended-precision reference is scipy's expm where that is exact
    pick = slice(0, None, 97)
    sci = np.stack([scipy.linalg.expm(-m * d) for m, d in
                    zip(_opacity(Kc[pick]), dl[pick])])
    sci_err = (np.abs(sci - ref[pick]).max((1, 2))
               / np.abs(ref[pick]).max((1, 2)))
    assert (sci_err <= 1e-11).all()
    kt = torch.tensor(Kc)
    O = tsol._calc_O(tuple(kt[:, :4].T), tuple(kt[:, 4:].T),
                     torch.tensor(dl)).permute(2, 0, 1).numpy()
    theirs = np.moveaxis(np.asarray(jsol._calc_O(
        tuple(Kc[:, :4].T), tuple(Kc[:, 4:].T), dl)), (0, 1), (-2, -1))
    scale = np.abs(ref).max((1, 2))
    # the small I<->QUV entries, each to its own size; |rho| >> |a| in
    # every cell, so these are 1e-9 .. 1e-3 of max|O|
    small = np.concatenate([ref[:, 0, 1:], ref[:, 1:, 0]], -1)

    def errors(X):
        entries = np.concatenate([X[:, 0, 1:], X[:, 1:, 0]], -1)
        return (float((np.abs(X - ref).max((1, 2)) / scale).max()),
                float((np.abs(entries - small) / np.abs(small)).max()))

    print(f"{len(dl)} cells; O against the reference (every entry, the "
          f"small entries): port {errors(O)}, grtrans_tpu "
          f"{errors(theirs)}; scipy's expm {sci_err.max():.2e}")
    assert (np.abs(small) < 1e-2 * scale[:, None]).all()
    assert errors(O)[0] <= 1e-12 and errors(O)[1] <= 1e-8


def _emission(O, Kc, jn, jf, dl):
    """The port's per-cell emission rule (_cell_emission) for given O:
    (I - O) K^-1 j_mid on deep cells, its Taylor form on shallow ones."""
    Kop = _opacity(Kc)
    deep = np.abs(Kc).max(-1) * dl > 0.3
    S = np.linalg.solve(Kop, 0.5 * (jn + jf)[..., None])[..., 0]
    p_exact = np.einsum("nij,nj->ni", np.eye(4) - O, S)
    Z = Kop * dl[:, None, None]
    Z2 = Z @ Z
    Z3 = Z2 @ Z
    eye = np.eye(4)
    Wn = 0.5 * eye - Z / 6.0 + Z2 / 24.0 - Z3 / 120.0
    Wf = 0.5 * eye - Z / 3.0 + Z2 / 8.0 - Z3 / 30.0
    p_taylor = dl[:, None] * (np.einsum("nij,nj->ni", Wn, jn)
                              + np.einsum("nij,nj->ni", Wf, jf))
    return np.where(deep[:, None], p_exact, p_taylor)


def test_faraday_thick_profile_matches_an_expm_march():
    lam, j, K, mask = _coefficients("faraday_thick")
    Kc, dl, O = _faraday_thick_cells()
    ncell = NPTS - 1
    jn = j[:, :-1].reshape(-1, 4)
    jf = j[:, 1:].reshape(-1, 4)
    p = _emission(O, Kc, jn, jf, dl).reshape(NPIX, ncell, 4)
    O = O.reshape(NPIX, ncell, 4, 4)
    # active cells: valid at both ends, near edge at tau <= MAX_TAU
    tau = np.cumsum(0.5 * (K[:, 1:, 0] + K[:, :-1, 0]) * np.diff(lam), -1)
    tau_near = np.concatenate([np.zeros((NPIX, 1)), tau[:, :-1]], -1)
    ok = (tau_near <= tsol.MAX_TAU) & mask[:, 1:] & mask[:, :-1]
    ref = np.zeros((NPIX, NPTS, 4))
    I = np.zeros((NPIX, 4))
    for c in range(ncell - 1, -1, -1):          # far end first
        step = np.einsum("nij,nj->ni", O[:, c], I) + p[:, c]
        I = np.where(ok[:, c, None], step, I)
        ref[:, c] = I
    lam_t, j_t, K_t, mask_t = (torch.tensor(x) for x in (lam, j, K, mask))
    prof = tsol.formal_solve(lam_t, j_t, K_t, mask=mask_t).numpy()
    obs = tsol.observed_stokes(lam_t, j_t, K_t, mask=mask_t).numpy()
    assert prof.shape == ref.shape
    bar = 1e-10 * np.abs(ref).max((0, 1))
    assert (np.abs(prof - ref).max((0, 1)) <= bar).all()
    assert (np.abs(obs - ref[:, 0]).max(0) <= bar).all()


def test_passivity_clamp():
    _, j, K, _ = _coefficients("generic", seed=1)
    K[..., 1:4] *= 3.0                  # |a_pol| > aI on many samples
    jt, Kt = tsol.passivity_clamp(torch.tensor(j), torch.tensor(K))
    jr, Kr = jsol.passivity_clamp(j, K)
    np.testing.assert_array_equal(jt.numpy(), np.asarray(jr))
    _close(Kt.numpy().reshape(-1, 7), np.asarray(Kr).reshape(-1, 7))


def test_rejects_other_integrators():
    lam, j, K, mask = (torch.tensor(x) for x in _coefficients("generic"))
    with pytest.raises(ValueError):
        tsol.observed_stokes(lam, j, K, method="rk4")
