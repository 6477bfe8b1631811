"""Polarized (Stokes IQUV) radiative-transfer integrators.

Port of grtrans_tpu/integrate/solvers.py (reference
radtrans_integrate.f90): the formal matricant solver (iflag=2) with
in-cell substeps ('lsoda' = 2 substeps; lsoda_solve doubles them under an
error estimate), DELO (iflag=1), the spherical-Stokes splitting
integrator (iflag=3) and the unpolarized quadrature.  Each
grid cell of the polarized solvers is an affine map I -> O I + p; for the
formal solver O = exp(-K dlam) is the analytic matricant of the opacity
matrix (Landi Degl'Innocenti 1985) in overflow-safe form and p the exact
linear-in-j emission.  One march serves them all: it builds the maps of
BLK cells at a time, far end first, and either composes the block and
applies it to the running Stokes vector (observer only) or applies the
cells one by one and records the profile.

Layout: 4x4 matrices are (4, 4, *batch) with the batch trailing; public
arrays are (npix, npts, ...) ordered along the trace (index 0 = observer).
K columns are [aI aQ aU aV rhoQ rhoU rhoV].
"""

import math

import torch
import torch.utils.checkpoint

from grtrans_tpu_torch import obs

MAX_TAU = 10.0
THIN = 1e-2    # DELO: cells shallower than this take the Taylor branch
BLK = 8     # cells composed per march step

# underflow floors at float32 scale, as in grtrans_tpu (its f64 is
# emulated with the f32 exponent range); on a native f64 device they only
# touch fully transparent or masked cells
_TINY = float(torch.finfo(torch.float32).tiny)
_SQRT_TINY = _TINY ** 0.5
# A cell's Faraday phase |lam2 dlam| is resolved while one unit roundoff
# of it (2^-53 of it in float64, 2^-24 in float32) stays below 1e-3 rad:
# up to 9.0e12 rad in float64.  Beyond, _calc_O gives the cell its
# phase-averaged rotation (phase_max).
PHASE_TOL = 1e-3


def phase_max(dtype):
    """The largest Faraday phase [rad] that `dtype` holds to PHASE_TOL."""
    return PHASE_TOL * 2.0 / torch.finfo(dtype).eps


def _m4(rows):
    """(4, 4, *batch) matrix from 4 rows of 4 batch tensors."""
    return torch.stack([torch.stack(r, dim=0) for r in rows], dim=0)


def _eye4(like):
    """Identity broadcastable against a (4, 4, *batch) matrix."""
    return torch.eye(4, dtype=like.dtype, device=like.device).reshape(
        (4, 4) + (1,) * (like.dim() - 2))


def _mm(A, B):
    """(4, 4, *b) @ (4, k, *b) over the leading indices."""
    return (A[:, :, None] * B[None]).sum(1)


def _opac_m4(a, rho):
    """Mueller opacity matrix from a = (aI, aQ, aU, aV), rho = (rQ, rU, rV)
    (radtrans_integrate.f90:735-744)."""
    aI, aQ, aU, aV = a
    rQ, rU, rV = rho
    return _m4([
        [aI, aQ, aU, aV],
        [aQ, aI, rV, -rU],
        [aU, -rV, aI, rQ],
        [aV, rU, -rQ, aI],
    ])


def _lam12(aq, au, av, rq, ru, rv, eps):
    a2 = aq ** 2 + au ** 2 + av ** 2
    p2 = rq ** 2 + ru ** 2 + rv ** 2
    ap = aq * rq + au * ru + av * rv
    # regularized sqrts keep the eigenvalue kinks at pure rotation / pure
    # absorption finite, with negligible eigenvalue error
    scale = eps ** 1.5 * (a2 + p2) + _TINY
    h = (a2 - p2) / 2.0
    rt = (h ** 2 + ap ** 2 + scale * scale).sqrt()
    # the large root is lam^2 = rt + |h|; the small one, rt - |h|, cancels
    # when |rho| >> |a| (or |a| >> |rho|), so it is taken from the product
    # (rt - |h|)(rt + |h|) = ap^2 + scale^2, which keeps it exact to
    # rounding however small ap is and keeps it > 0
    big = rt + h.abs()
    big_sq = big + scale
    small_sq = (ap ** 2 + scale * scale) / big.clamp_min(_TINY)
    lam1 = torch.where(h >= 0.0, big_sq, small_sq).sqrt()
    lam2 = torch.where(h >= 0.0, small_sq, big_sq).sqrt()
    return a2, p2, ap, lam1, lam2


def _calc_O(a, rho, dx, dx64=None):
    """exp(-K dx) of the constant opacity matrix, (4, 4, *batch)
    (radtrans_integrate.f90:615-683).  a: 4-tuple, rho: 3-tuple of batch
    tensors.

    Cells whose eigen-decomposition is unusable -- lam*dx tiny (degen),
    or |O| > 1 / NaN from lost cancellation (bad) -- take the cubic
    I - Z + Z^2/2 - Z^3/6 of the (near-)nilpotent polarized part, or
    scalar attenuation if that still breaks passivity.

    The Faraday phase lam2 dx: a cell whose phase its dtype cannot hold
    to PHASE_TOL (|phase| > phase_max, 9.0e12 rad in float64) rotates the
    linear polarization by an angle that is rounding; its rotation block
    takes the average over the phase (cos = sin = 0: the cell depolarizes
    what it rotates), and its gradient through the phase is 0.  Every
    other cell's O is the formula's.

    dx64: a float64 copy of dx when the coefficients are float32
    (prec="mixed", grtrans_tpu's dx64): the phase is formed in float64
    and reduced mod 2 pi before the float32 cos and sin, since it reaches
    1e3-1e6 rad on rotation-thick cells, beyond float32's resolution."""
    aI = a[0]
    fin = torch.finfo(aI.dtype)
    _, _, _, l1_0, l2_0 = _lam12(*a[1:], *rho, fin.eps)
    dthr = 10.0 * math.sqrt(fin.eps)
    degen = (l1_0 * dx.abs() < dthr) & (l2_0 * dx.abs() < dthr)

    aq = torch.where(degen, 1.0, a[1])
    au = torch.where(degen, 0.0, a[2])
    av = torch.where(degen, 0.0, a[3])
    rhoq = torch.where(degen, 0.0, rho[0])
    rhou = torch.where(degen, 0.0, rho[1])
    rhov = torch.where(degen, 0.0, rho[2])
    a2, p2, ap, lam1, lam2 = _lam12(aq, au, av, rhoq, rhou, rhov, fin.eps)
    theta = lam1 ** 2 + lam2 ** 2
    ith = 1.0 / torch.where(theta > _SQRT_TINY, theta, 1.0)
    sig = torch.sign(ap)
    sig = torch.where(sig == 0.0, 1.0, sig)
    z = torch.zeros_like(aI)

    M2 = _m4([
        [z, lam2 * aq - sig * lam1 * rhoq, lam2 * au - sig * lam1 * rhou,
         lam2 * av - sig * lam1 * rhov],
        [lam2 * aq - sig * lam1 * rhoq, z, sig * lam1 * av + lam2 * rhov,
         -sig * lam1 * au - lam2 * rhou],
        [lam2 * au - sig * lam1 * rhou, -sig * lam1 * av - lam2 * rhov, z,
         sig * lam1 * aq + lam2 * rhoq],
        [lam2 * av - sig * lam1 * rhov, sig * lam1 * au + lam2 * rhou,
         -sig * lam1 * aq - lam2 * rhoq, z],
    ])
    M3 = _m4([
        [z, lam1 * aq + sig * lam2 * rhoq, lam1 * au + sig * lam2 * rhou,
         lam1 * av + sig * lam2 * rhov],
        [lam1 * aq + sig * lam2 * rhoq, z, -sig * lam2 * av + lam1 * rhov,
         sig * lam2 * au - lam1 * rhou],
        [lam1 * au + sig * lam2 * rhou, sig * lam2 * av - lam1 * rhov, z,
         -sig * lam2 * aq + lam1 * rhoq],
        [lam1 * av + sig * lam2 * rhov, -sig * lam2 * au + lam1 * rhou,
         sig * lam2 * aq - lam1 * rhoq, z],
    ])
    hp = (a2 + p2) / 2.0
    M4 = _m4([
        [hp, av * rhou - au * rhov, aq * rhov - av * rhoq,
         au * rhoq - aq * rhou],
        [au * rhov - av * rhou, aq * aq + rhoq * rhoq - hp,
         aq * au + rhoq * rhou, av * aq + rhov * rhoq],
        [av * rhoq - aq * rhov, aq * au + rhoq * rhou,
         au * au + rhou * rhou - hp, au * av + rhou * rhov],
        [aq * rhou - au * rhoq, av * aq + rhov * rhoq,
         au * av + rhou * rhov, av * av + rhov * rhov - hp],
    ])

    # exp(-aI dx) combined with cosh/sinh(lam1 dx), both arguments clipped
    # so exp never overflows
    lo = -0.95 * math.log(fin.max)
    arg_p = ((lam1 - aI) * dx).clamp(lo, 60.0)
    arg_m = (-(lam1 + aI) * dx).clamp(lo, 60.0)
    ep = torch.exp(arg_p)
    ecp = 0.5 * (ep + torch.exp(arg_m))
    # exp(-aI dx) sinh(lam1 dx) without the cancellation of a difference
    # of exps when lam1 dx is small (a Faraday-thick cell)
    ecm = -0.5 * ep * torch.expm1(arg_m - arg_p)
    eno = torch.exp((-aI * dx).clamp(lo, 60.0))
    if dx64 is not None and lam2.dtype != torch.float64:
        ph = lam2.double() * dx64
    else:
        ph = lam2 * dx
    # the trig sees 0 where the phase is rounding, so that no derivative
    # of the noise reaches the backward pass
    scrambled = ph.abs() > phase_max(ph.dtype)
    ph = torch.where(scrambled, 0.0, ph)
    if ph.dtype != lam2.dtype:
        two_pi = 2.0 * math.pi
        ph = (ph - two_pi * torch.floor(ph / two_pi)).to(lam2.dtype)
    cs = torch.where(scrambled, 0.0, torch.cos(ph) * eno)
    sn = torch.where(scrambled, 0.0, torch.sin(ph) * eno)
    eye = _eye4(M2)
    O = (0.5 * (ecp + cs) * eye
         - (sn * ith) * M2
         - (ecm * ith) * M3
         + (ecp - cs) * ith * M4)
    # `~(max <= bound)`: a NaN matricant must land in `bad`
    bad = ~(O.abs().amax(dim=(0, 1)) <= 1.0 + 1e-6)
    need_poly = degen | bad
    Kpoly = _opac_m4(
        (z,) + tuple(torch.where(need_poly, c, 0.0) for c in a[1:]),
        tuple(torch.where(need_poly, c, 0.0) for c in rho))
    Znil = Kpoly * dx
    Z2n = _mm(Znil, Znil)
    O_nil = eno * (eye - Znil + Z2n / 2.0 - _mm(Z2n, Znil) / 6.0)
    nil_ok = O_nil.abs().amax(dim=(0, 1)) <= 1.0 + 1e-6
    return torch.where(need_poly, torch.where(nil_ok, O_nil, eno * eye), O)


def opacity_matrix(a, rho):
    """Mueller opacity matrix (..., 4, 4) from a (..., 4) = [aI aQ aU aV]
    and rho (..., 3) = [rhoQ rhoU rhoV]."""
    m = _opac_m4(tuple(a.unbind(-1)), tuple(rho.unbind(-1)))
    return m.movedim((0, 1), (-2, -1))


def calc_O(a, rho, dx):
    """exp(-K dx), (..., 4, 4), of the opacity matrix of a (..., 4) and
    rho (..., 3) over dx (...)."""
    m = _calc_O(tuple(a.unbind(-1)), tuple(rho.unbind(-1)), dx)
    return m.movedim((0, 1), (-2, -1))


def passivity_clamp(j, K):
    """Clamp |a_pol| to (1 - 1e-8) aI so exp(-K dx) stays a contraction
    (the synchrotron fits can violate |a_pol| <= aI outside their
    domain)."""
    aI = K[..., :1].abs()
    ap = K[..., 1:4]
    an2 = (ap * ap).sum(-1, keepdim=True)
    bound = (1.0 - 1e-8) * aI
    viol = an2 > bound * bound
    an = torch.where(viol, an2, 1.0).sqrt()
    fa = torch.where(viol, bound / torch.where(viol, an, 1.0), 1.0)
    return j, torch.cat([K[..., :1], ap * fa, K[..., 4:]], dim=-1)


def _inv4(m):
    """Closed-form 4x4 inverse via the adjugate (radtrans_integrate.f90:
    685-733).  Returns (inv, good); `good` flags determinants large enough
    to trust, and the others are divided by 1 (callers mask them)."""
    def e(i, k):
        return m[i, k]
    s0 = e(0, 0) * e(1, 1) - e(1, 0) * e(0, 1)
    s1 = e(0, 0) * e(1, 2) - e(1, 0) * e(0, 2)
    s2 = e(0, 0) * e(1, 3) - e(1, 0) * e(0, 3)
    s3 = e(0, 1) * e(1, 2) - e(1, 1) * e(0, 2)
    s4 = e(0, 1) * e(1, 3) - e(1, 1) * e(0, 3)
    s5 = e(0, 2) * e(1, 3) - e(1, 2) * e(0, 3)
    c5 = e(2, 2) * e(3, 3) - e(3, 2) * e(2, 3)
    c4 = e(2, 1) * e(3, 3) - e(3, 1) * e(2, 3)
    c3 = e(2, 1) * e(3, 2) - e(3, 1) * e(2, 2)
    c2 = e(2, 0) * e(3, 3) - e(3, 0) * e(2, 3)
    c1 = e(2, 0) * e(3, 2) - e(3, 0) * e(2, 2)
    c0 = e(2, 0) * e(3, 1) - e(3, 0) * e(2, 1)
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    adj = _m4([
        [e(1, 1) * c5 - e(1, 2) * c4 + e(1, 3) * c3,
         -e(0, 1) * c5 + e(0, 2) * c4 - e(0, 3) * c3,
         e(3, 1) * s5 - e(3, 2) * s4 + e(3, 3) * s3,
         -e(2, 1) * s5 + e(2, 2) * s4 - e(2, 3) * s3],
        [-e(1, 0) * c5 + e(1, 2) * c2 - e(1, 3) * c1,
         e(0, 0) * c5 - e(0, 2) * c2 + e(0, 3) * c1,
         -e(3, 0) * s5 + e(3, 2) * s2 - e(3, 3) * s1,
         e(2, 0) * s5 - e(2, 2) * s2 + e(2, 3) * s1],
        [e(1, 0) * c4 - e(1, 1) * c2 + e(1, 3) * c0,
         -e(0, 0) * c4 + e(0, 1) * c2 - e(0, 3) * c0,
         e(3, 0) * s4 - e(3, 1) * s2 + e(3, 3) * s0,
         -e(2, 0) * s4 + e(2, 1) * s2 - e(2, 3) * s0],
        [-e(1, 0) * c3 + e(1, 1) * c1 - e(1, 2) * c0,
         e(0, 0) * c3 - e(0, 1) * c1 + e(0, 2) * c0,
         -e(3, 0) * s3 + e(3, 1) * s1 - e(3, 2) * s0,
         e(2, 0) * s3 - e(2, 1) * s1 + e(2, 2) * s0],
    ])
    scale = adj.abs().amax(dim=(0, 1))
    eps = torch.finfo(det.dtype).eps
    good = det.abs() > 100.0 * eps * scale + _TINY
    return adj / torch.where(good, det, 1.0), good


def inv4(m):
    """Closed-form inverse in the public (..., 4, 4) layout.  Returns
    (inv, good) as _inv4 does."""
    inv, good = _inv4(m.movedim((-2, -1), (0, 1)))
    return inv.movedim((0, 1), (-2, -1)), good


def _imatrix4(m):
    """Closed-form 4x4 inverse (reference imatrix_4) in the (4, 4, *batch)
    layout; ill-conditioned cells (optically pathological, masked or
    thin-branched by the callers) give the identity."""
    inv, good = _inv4(m)
    return torch.where(good, inv, _eye4(m))


def _cell_emission(O, ac, rc, jn, jf, dlam):
    """Emission term p of the cell map I -> O I + p.

    O (4,4,*b); ac (4-tuple), rc (3-tuple) of batch tensors; jn/jf
    (4,1,*b) near/far emission; dlam (*b).  Shallow cells (max |K| dlam
    <= 0.3) use the 4-term Taylor form of the exact linear-in-j
    quadrature in the full Z = K dlam; deep cells the exact
    constant-coefficient p = (I - O) K^-1 j_mid; deep cells with singular
    K keep the trapezoid."""
    p_trap = 0.5 * dlam * (_mm(O, jf) + jn)
    # normalize by the largest coefficient magnitude so the adjugate's
    # cubic products stay in range
    s = ac[0].abs()
    for c in tuple(ac[1:]) + tuple(rc):
        s = torch.maximum(s, c.abs())
    s = s.clamp_min(_SQRT_TINY)
    ia0 = 1.0 / s
    Kn = _opac_m4(tuple(c * ia0 for c in ac), tuple(c * ia0 for c in rc))
    iK, inv_ok = _inv4(Kn)
    S = _mm(iK, 0.5 * (jn + jf) * ia0)
    p_exact = S - _mm(O, S)
    zmax = s * dlam
    Z = Kn * zmax                                         # = K dlam
    Z2 = _mm(Z, Z)
    Z3 = _mm(Z2, Z)
    eye = _eye4(Z)
    Wn = 0.5 * eye - Z / 6.0 + Z2 / 24.0 - Z3 / 120.0
    Wf = 0.5 * eye - Z / 3.0 + Z2 / 8.0 - Z3 / 30.0
    p_taylor = dlam * (_mm(Wn, jn) + _mm(Wf, jf))
    deep = zmax > 0.3
    return torch.where(deep & inv_ok, p_exact,
                       torch.where(deep, p_trap, p_taylor))


def _compose(f, g):
    """Affine composition f after g, f = (A2, b2), g = (A1, b1)."""
    A2, b2 = f
    A1, b1 = g
    return _mm(A2, A1), _mm(A2, b1) + b2


def _mask_cells(O, p, mask):
    """Replace masked-out cells by the identity map."""
    return torch.where(mask, O, _eye4(O)), torch.where(mask, p, 0.0)


def _cell_tau_mask(lam, K, mask, max_tau):
    """Optical depth from the observer at cell far edges, and the active
    cells: those whose NEAR edge lies at tau <= max_tau (the cell holding
    the photosphere stays; its map saturates to the source function)."""
    dlam = lam[..., 1:] - lam[..., :-1]
    a_mid = 0.5 * (K[..., 1:, 0].abs() + K[..., :-1, 0].abs())
    tau = (a_mid * dlam).cumsum(-1)
    tau_near = torch.cat([torch.zeros_like(tau[..., :1]), tau[..., :-1]],
                         dim=-1)
    cell_ok = tau_near <= max_tau
    if mask is not None:
        cell_ok = cell_ok & mask[..., 1:] & mask[..., :-1]
    return tau, cell_ok


def _far_first(x, pad):
    """Reverse the trailing (cell) axis and zero-pad its near end."""
    y = x.flip(-1)
    if pad:
        y = torch.cat([y, y.new_zeros(y.shape[:-1] + (pad,))], dim=-1)
    return y


def _initial_stokes(I0, npix, like):
    """(4, 1, npix) starting Stokes vector at the far end."""
    if I0 is None:
        return like.new_zeros((4, 1, npix))
    I0 = torch.as_tensor(I0, dtype=like.dtype, device=like.device)
    return torch.atleast_2d(I0).expand(npix, 4).transpose(0, 1)[:, None]


def _pad(ncell):
    """Cells to add at the near end so the cell axis is whole blocks."""
    return (-ncell) % BLK


def _march(maps, cell_ok, I, profile, recompute=False):
    """Far-to-near march over the cells.  `maps(blk)` returns the affine
    maps (O (4,4,npix,BLK), p (4,1,npix,BLK)) of the cells in slice `blk`
    of the far-first, padded cell axis (_far_first); `cell_ok`
    (npix, ncell) in trace order masks cells to the identity.  Cells past
    the near end are padding, masked too.

    profile=False composes each block (the farthest cell applied first;
    affine composition is associative, so the grouping is exact) and
    returns the observed (npix, 4).  profile=True applies the cells one
    by one and returns (npix, npts, 4): entry i is the Stokes vector at
    sample i, entry 0 the observer's, the last the starting vector.

    recompute=True (a gradient flows through the coefficients): each block
    step runs under torch.utils.checkpoint, so that the backward pass
    holds one block's intermediates at a time and recomputes them from
    the block's inputs, as grtrans_tpu wraps its block step in
    jax.checkpoint (integrate/solvers.py:600-605, :622)."""
    ncell = cell_ok.shape[-1]
    cell_ok = _far_first(cell_ok, _pad(ncell))
    nblocks = cell_ok.shape[-1] // BLK
    obs.count("march.blocks", nblocks)
    I_far = I
    rows = []

    def step(I, lo):
        blk = slice(lo, lo + BLK)
        O, p = _mask_cells(*maps(blk), cell_ok[..., blk])
        if profile:
            out = []
            for jj in range(BLK):
                I = _mm(O[..., jj], I) + p[..., jj]
                out.append(I[:, 0])
            return I, torch.stack(out)
        Ob, pb = O[..., 0], p[..., 0]
        for jj in range(1, BLK):
            Ob, pb = _compose((O[..., jj], p[..., jj]), (Ob, pb))
        return _mm(Ob, I) + pb, None

    with obs.span("march", blocks=nblocks):
        for lo in range(0, cell_ok.shape[-1], BLK):
            if recompute:
                I, out = torch.utils.checkpoint.checkpoint(
                    step, I, lo, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                I, out = step(I, lo)
            if profile:
                rows.extend(out.unbind(0))
    if not profile:
        return I[:, 0].transpose(0, 1)
    # rows[m]: after the first m + 1 cells from the far end, so sample i
    # is rows[ncell - 1 - i]; the far sample is the starting vector
    prof = torch.stack(rows[:ncell][::-1] + [I_far[:, 0]], dim=0)
    return prof.permute(2, 0, 1)


def _needs_grad(*tensors):
    """Whether a gradient is being recorded through any of `tensors`."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _formal_maps(a, rho, jc, dlam, substeps, dlam64=None):
    """Cell-map builder of the formal solver for _march.  a (4-tuple),
    rho (3-tuple) of (npix, npts) sample coefficients, jc (4,1,npix,npts),
    dlam (npix, ncell) in the coefficients' dtype, dlam64 its float64
    copy when that is float32 (_calc_O's dx64).

    substeps == 1: midpoint opacity, linear-in-j emission.  substeps > 1:
    each cell is cut into substeps with linearly interpolated
    coefficients, composed with the FAR substep applied first (the other
    order converges to the within-cell-mirrored profile)."""
    pad = _pad(dlam.shape[-1])

    def near(x):
        return _far_first(x[..., :-1], pad)

    def far(x):
        return _far_first(x[..., 1:], pad)

    a_n, a_f = [near(c) for c in a], [far(c) for c in a]
    r_n, r_f = [near(c) for c in rho], [far(c) for c in rho]
    j_n, j_f = near(jc), far(jc)
    dl = _far_first(dlam, pad)
    dl64 = None if dlam64 is None else _far_first(dlam64, pad)

    def maps(blk):
        an = [c[..., blk] for c in a_n]
        af = [c[..., blk] for c in a_f]
        rn = [c[..., blk] for c in r_n]
        rf = [c[..., blk] for c in r_f]
        jn, jf, d = j_n[..., blk], j_f[..., blk], dl[..., blk]
        d64 = None if dl64 is None else dl64[..., blk]
        if substeps == 1:
            ac = tuple(0.5 * (n + f) for n, f in zip(an, af))
            rc = tuple(0.5 * (n + f) for n, f in zip(rn, rf))
            O = _calc_O(ac, rc, d, d64)
            return O, _cell_emission(O, ac, rc, jn, jf, d)
        dsub = d / substeps
        dsub64 = None if d64 is None else d64 / substeps
        cell = None
        for s in reversed(range(substeps)):
            fr = (s + 0.5) / substeps
            ac = tuple(n * (1 - fr) + f * fr for n, f in zip(an, af))
            rc = tuple(n * (1 - fr) + f * fr for n, f in zip(rn, rf))
            e0, e1 = s / substeps, (s + 1) / substeps
            O = _calc_O(ac, rc, dsub, dsub64)
            step = (O, _cell_emission(O, ac, rc, jn * (1 - e0) + jf * e0,
                                      jn * (1 - e1) + jf * e1, dsub))
            cell = step if cell is None else _compose(step, cell)
        return cell

    return maps


def formal_solve(lam, j, K, mask=None, max_tau=MAX_TAU, I0=None, substeps=1,
                 profile=True):
    """Matricant solver (reference iflag=2, radtrans_integrate.f90:
    844-876).

    lam (npix, npts) affine parameter increasing along the trace; j
    (npix, npts, 4); K (npix, npts, 7); mask (npix, npts) validity; I0
    the Stokes vector entering at the far end (zero by default).
    Midpoint opacity and linear-in-j emission per cell (2nd order);
    substeps > 1 subdivides each cell with linearly interpolated
    coefficients; integration stops at the cell holding tau = max_tau.
    Returns the (npix, npts, 4) Stokes profile (index 0 = observer), or
    only the observer's (npix, 4) with profile=False.

    float32 coefficients with a float64 lam (prec="mixed") march in
    float32: the cells' affine parameter steps are those of lam rounded
    to float32, and each cell's Faraday phase is formed from the float64
    step (_calc_O's dx64), as grtrans_tpu's formal_solve does."""
    j, K = passivity_clamp(j, K)
    mixed = j.dtype == torch.float32 and lam.dtype == torch.float64
    dlam64 = lam[..., 1:] - lam[..., :-1] if mixed else None
    if mixed:
        lam = lam.to(j.dtype)
    a = tuple(K[..., 0:4].movedim(-1, 0))
    rho = tuple(K[..., 4:7].movedim(-1, 0))
    jc = j.movedim(-1, 0)[:, None]                       # (4,1,npix,npts)
    dlam = lam[..., 1:] - lam[..., :-1]                  # (npix, ncell)
    _, cell_ok = _cell_tau_mask(lam, K, mask, max_tau)
    return _march(_formal_maps(a, rho, jc, dlam, substeps, dlam64), cell_ok,
                  _initial_stokes(I0, lam.shape[0], j), profile,
                  _needs_grad(lam, j, K, I0 if torch.is_tensor(I0) else None))


def _delo_cells(j0, j1, K0, K1, aI0, aI1, dlam, thin):
    """Per-cell DELO affine map (Q, P) on any batch shape; "0" is the
    observer-side sample and "1" the far side.  Each endpoint's
    absorption is floored relative to the cell's mean, so a cell with one
    nearly transparent endpoint does not blow S = j / a up."""
    eye = _eye4(K0)
    delta = 0.5 * (aI0 + aI1) * dlam
    floor = _SQRT_TINY
    avg_a = delta / dlam.clamp_min(floor)
    rel = (1e-8 * avg_a).clamp_min(floor)
    a0 = torch.maximum(aI0, rel)
    a1 = torch.maximum(aI1, rel)

    # thick branch (delta > thin)
    thick = delta > thin
    E = torch.exp(-delta)
    F = 1.0 - E
    G = (1.0 - (1.0 + delta) * E) / torch.where(thick, delta, 1.0)
    Sp0 = j0 / a0
    Sp1 = j1 / a1
    Kp0 = K0 / a0 - eye
    Kp1 = K1 / a1 - eye
    iM = _imatrix4(eye + (F - G) * Kp0)
    Pthick = _mm(iM, (F - G) * Sp0 + G * Sp1)
    Qthick = _mm(iM, E * eye - G * Kp1)

    # thin branch: Taylor in delta (reference :746-793)
    dx = dlam
    iMt = _imatrix4((1.0 - delta / 2.0 + delta ** 2 / 6.0) * eye
                    + (0.5 * dx - dx ** 2 * a0 / 6.0) * K0)
    Pthin = _mm(iMt, (0.5 * dx - dx ** 2 * a0 / 6.0) * j0
                + (0.5 * dx - dx ** 2 * a0 / 3.0) * j1)
    Qthin = _mm(iMt, (1.0 - 0.5 * dx * a0 + dx ** 2 * a0 ** 2 / 6.0) * eye
                - (0.5 * dx - dx ** 2 / 3.0) * K1)
    return torch.where(thick, Qthick, Qthin), torch.where(thick, Pthick,
                                                          Pthin)


def delo_solve(lam, j, K, mask=None, max_tau=MAX_TAU, thin=THIN, I0=None):
    """DELO linear short-characteristics solver (reference iflag=1,
    radtrans_integrate.f90:795-842) with the optically thin Taylor branch
    (:746-793).  Returns the (npix, npts, 4) profile."""
    j, K = passivity_clamp(j, K)
    comps = tuple(K.movedim(-1, 0))
    jc = j.movedim(-1, 0)[:, None]
    dlam = lam[..., 1:] - lam[..., :-1]
    _, cell_ok = _cell_tau_mask(lam, K, mask, max_tau)
    pad = _pad(dlam.shape[-1])
    K0 = [_far_first(c[..., :-1], pad) for c in comps]
    K1 = [_far_first(c[..., 1:], pad) for c in comps]
    j0 = _far_first(jc[..., :-1], pad)
    j1 = _far_first(jc[..., 1:], pad)
    dl = _far_first(dlam, pad)

    def maps(blk):
        k0 = [c[..., blk] for c in K0]
        k1 = [c[..., blk] for c in K1]
        return _delo_cells(j0[..., blk], j1[..., blk],
                           _opac_m4(k0[:4], k0[4:]), _opac_m4(k1[:4], k1[4:]),
                           k0[0], k1[0], dl[..., blk], thin)

    return _march(maps, cell_ok, _initial_stokes(I0, lam.shape[0], j), True,
                  _needs_grad(lam, j, K, I0 if torch.is_tensor(I0) else None))


def quadrature_solve(lam, j, K, mask=None, max_tau=MAX_TAU):
    """Unpolarized quadrature I = int j exp(-tau) dlam (reference
    radtrans_integrate.f90:878-882), cumulative from the far end toward
    the observer.  Returns (npix, npts, 4) with Q = U = V = 0."""
    aI = K[..., 0].abs()
    dlam = lam[..., 1:] - lam[..., :-1]
    dtau = 0.5 * (aI[..., 1:] + aI[..., :-1]) * dlam
    zero = torch.zeros_like(lam[..., :1])
    tau = torch.cat([zero, dtau.cumsum(-1)], dim=-1)
    # 80 only keeps exp from underflowing; truncation is the tau mask
    integ = j[..., 0] * torch.exp(-tau.clamp_max(80.0))
    if mask is not None:
        integ = torch.where(mask, integ, 0.0)
    integ = torch.where(tau <= max_tau, integ, 0.0)
    seg = 0.5 * (integ[..., 1:] + integ[..., :-1]) * dlam
    cum = torch.cat([zero, seg.cumsum(-1)], dim=-1)
    prof_I = cum[..., -1:] - cum
    z = torch.zeros_like(prof_I)
    return torch.stack([prof_I, z, z, z], dim=-1)


def _phi1(z):
    """phi1(z) = (1 - e^-z) / z, the weight of the exact affine update;
    Taylor branch near z = 0 so the division never sees a small
    denominator."""
    small = z.abs() < 1e-4
    zs = torch.where(small, 1.0, z)
    return torch.where(small, 1.0 - z / 2.0 + z * z / 6.0,
                       -torch.expm1(-zs) / zs)


def _sph_substep(I, P, jv, Kv, h):
    """One Strang-split substep of the polarized transfer equation, exact
    in each split part and so stable at any optical or Faraday depth.

    State: I (*b,), P = (Q, U, V) (*b, 3).  Part (i) is Faraday rotation
    dP/ds = rho x P, an exact rigid rotation (Rodrigues) about
    rho = (rhoQ, rhoU, rhoV).  Part (ii) is absorption, emission and
    exchange, diagonal in the basis {I + P_par, I - P_par, P_perp} along
    a = (aQ, aU, aV) with decay rates {aI + |a|, aI - |a|, aI}, each
    updated by the exact scalar affine solution.  Composition:
    half-rotation, full exchange, half-rotation.  Over a substep a and
    the polarized emission rotate at the Faraday rate relative to P, so
    their components across rho enter window-averaged (sinc(|rho| h / 2))."""
    tiny = _SQRT_TINY
    jI = jv[..., 0]
    jp = jv[..., 1:4]
    aI = Kv[..., 0]
    av = Kv[..., 1:4]
    rho = Kv[..., 4:7]

    rmag = (rho * rho).sum(-1).sqrt()
    hasr = rmag > tiny
    rhat = torch.where(hasr[..., None],
                       rho / torch.where(hasr, rmag, 1.0)[..., None], 0.0)

    def rotate(P, ang_h):
        ang = rmag * ang_h
        c = torch.cos(ang)[..., None]
        sn = torch.sin(ang)[..., None]
        ndP = (rhat * P).sum(-1, keepdim=True)
        turned = c * P + sn * torch.linalg.cross(rhat, P) \
            + (1.0 - c) * ndP * rhat
        return torch.where(hasr[..., None], turned, P)

    P = rotate(P, 0.5 * h)

    thh = 0.5 * rmag * h
    smallth = thh.abs() < 1e-4
    ths = torch.where(smallth, 1.0, thh)
    sinc = torch.where(smallth, 1.0 - thh * thh / 6.0, torch.sin(ths) / ths)

    def secular(w):
        wpar = (rhat * w).sum(-1, keepdim=True) * rhat
        return wpar + sinc[..., None] * (w - wpar)

    av = torch.where(hasr[..., None], secular(av), av)
    jp = torch.where(hasr[..., None], secular(jp), jp)

    amag2 = (av * av).sum(-1)
    hasa = amag2 > tiny * tiny
    amag = torch.where(hasa, torch.where(hasa, amag2, 1.0).sqrt(), 0.0)
    ah = torch.where(hasa[..., None],
                     av / torch.where(hasa, amag, 1.0)[..., None], 0.0)
    Ppar = (ah * P).sum(-1)
    Pperp = P - Ppar[..., None] * ah
    jpar = (ah * jp).sum(-1)
    jperp = jp - jpar[..., None] * ah

    def affine(x, jeff, lam, hh):
        z = lam * hh
        return x * torch.exp(-z) + jeff * hh * _phi1(z)

    u = affine(I + Ppar, jI + jpar, aI + amag, h)
    v = affine(I - Ppar, jI - jpar, aI - amag, h)
    Pperp = affine(Pperp, jperp, aI[..., None], h[..., None])
    I = 0.5 * (u + v)
    Ppar = 0.5 * (u - v)
    P = Pperp + Ppar[..., None] * ah
    return I, rotate(P, 0.5 * h)


def sphstokes_solve(lam, j, K, mask=None, max_tau=MAX_TAU, nsub=4):
    """Spherical-Stokes integrator (reference iflag=3 / iname='lsodasph',
    radtrans_integrate.f90:468-613).  The reference integrates (I, p,
    phi, psi) with adaptive LSODA because the linear Stokes form is
    stiff; here the polarization vector marches by exponential operator
    splitting (_sph_substep), `nsub` substeps a cell with midpoint
    coefficients, sequentially over the cells and batched over pixels.
    Returns the (npix, npts, 4) linear Stokes profile (index 0 =
    observer)."""
    # float32 coefficients with a float64 lam march in float64 here, as
    # grtrans_tpu's promotion runs them
    dt = torch.promote_types(lam.dtype, j.dtype)
    j, K = passivity_clamp(j.to(dt), K.to(dt))
    _, cell_ok = _cell_tau_mask(lam, K, mask, max_tau)
    dlam = lam[..., 1:] - lam[..., :-1]
    npts = lam.shape[-1]
    I = lam.new_zeros(lam.shape[:1])
    P = lam.new_zeros(lam.shape[:1] + (3,))
    rows = [torch.cat([I[..., None], P], dim=-1)]
    # far -> observer: the cell between samples i and i + 1 starts from
    # its far sample i + 1
    for i in range(npts - 2, -1, -1):
        jn, jf = j[:, i + 1], j[:, i]
        Kn, Kf = K[:, i + 1], K[:, i]
        ok = cell_ok[:, i]
        h = dlam[:, i] / nsub
        In, Pn = I, P
        for s in range(nsub):
            f = (s + 0.5) / nsub                 # substep midpoint
            In, Pn = _sph_substep(In, Pn, jn * (1 - f) + jf * f,
                                  Kn * (1 - f) + Kf * f, h)
        In = In.clamp_min(0.0)
        I = torch.where(ok, In, I)
        P = torch.where(ok[..., None], Pn, P)
        rows.append(torch.cat([I[..., None], P], dim=-1))
    return torch.stack(rows[::-1], dim=1)


def integrate(lam, j, K, method="formal", mask=None, max_tau=MAX_TAU,
              thin=THIN, I0=None):
    """Stokes profile (npix, npts, 4) by integrator name (rad_trans.f90:
    29-37): 'formal', 'lsoda' (the formal solver with 2 substeps a cell;
    lsoda_solve has the error control), 'delo', 'lsodasph', 'quadrature'."""
    if method in ("formal", 2):
        return formal_solve(lam, j, K, mask, max_tau, I0)
    if method in ("delo", 1):
        return delo_solve(lam, j, K, mask, max_tau, thin, I0)
    if method in ("lsoda", 0):
        return formal_solve(lam, j, K, mask, max_tau, I0, substeps=2)
    if method in ("lsodasph", 3):
        return sphstokes_solve(lam, j, K, mask, max_tau)
    if method == "quadrature":
        return quadrature_solve(lam, j, K, mask, max_tau)
    raise ValueError(f"unknown method {method}")


def observed_stokes(lam, j, K, method="formal", mask=None, max_tau=MAX_TAU,
                    thin=THIN, I0=None):
    """Observer-side Stokes vector only, (npix, 4): integrate(...)[:, 0],
    but the formal solvers skip the per-sample profile."""
    if method in ("formal", 2):
        return formal_solve(lam, j, K, mask, max_tau, I0, profile=False)
    if method in ("lsoda", 0):
        return formal_solve(lam, j, K, mask, max_tau, I0, substeps=2,
                            profile=False)
    return integrate(lam, j, K, method, mask, max_tau, thin, I0)[..., 0, :]


def lsoda_solve(lam, j, K, mask=None, max_tau=MAX_TAU, I0=None, atol=1e-8,
                rtol=1e-6, max_substeps=32):
    """The 'lsoda' path with the reference's error-control semantics
    (atol / rtol of radtrans_integrate.f90:20,68-104).

    A cell's matricant is exact for constant coefficients, so the only
    discretization error is within-cell coefficient variation, 2nd order
    in the substep width.  The substep count doubles, s = 1, 2, 4, ...,
    max_substeps, with the Richardson estimate err(I_2s) ~ |I_s - I_2s| / 3,
    until max(err / (atol + rtol |I|)) <= 1 over the whole profile.  The
    estimate is reduced on the device; one scalar a doubling reaches the
    host.

    Returns (profile, info): the (npix, npts, 4) profile at the accepted
    substep count, and info with 'substeps', 'err_est' (numpy (4,), max
    abs per Stokes component), 'err_scaled' and 'converged' (False when
    the cap was hit)."""
    prev = None
    s = 1
    while True:
        cur = formal_solve(lam, j, K, mask, max_tau, I0, substeps=s)
        if prev is not None:
            diff = (cur - prev).abs() / 3.0
            with obs.sync("lsoda_solve"):
                err_scaled = (diff / (atol + rtol * cur.abs())).max().item()
            if err_scaled <= 1.0 or s >= max_substeps:
                info = {"substeps": s,
                        "err_est": diff.reshape(-1, 4).amax(0).cpu().numpy(),
                        "err_scaled": err_scaled,
                        "converged": err_scaled <= 1.0}
                return cur, info
        prev = cur
        s *= 2
