"""Polarized (Stokes IQUV) formal solver, observer-only.

Port of the observer path of grtrans_tpu/integrate/solvers.py (reference
radtrans_integrate.f90, iflag=2).  Each grid cell is an affine map
I -> O I + p with O = exp(-K dlam), the analytic matricant of the
midpoint opacity matrix (Landi Degl'Innocenti 1985) in overflow-safe
form, and p the exact linear-in-j emission.  The march composes BLK cells
at a time, far end first, and applies each block to the running Stokes
vector.

Layout: 4x4 matrices are (4, 4, *batch) with the batch trailing; public
arrays are (npix, npts, ...) ordered along the trace (index 0 = observer).
K columns are [aI aQ aU aV rhoQ rhoU rhoV].
"""

import math

import torch

MAX_TAU = 10.0
BLK = 8     # cells composed per march step

# underflow floors at float32 scale, as in grtrans_tpu (its f64 is
# emulated with the f32 exponent range); on a native f64 device they only
# touch fully transparent or masked cells
_TINY = float(torch.finfo(torch.float32).tiny)
_SQRT_TINY = _TINY ** 0.5


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
    rt = ((a2 - p2) ** 2 / 4.0 + ap ** 2 + scale * scale).sqrt()
    lam1 = ((rt + (a2 - p2) / 2.0).clamp_min(0.0) + scale).sqrt()
    lam2 = ((rt - (a2 - p2) / 2.0).clamp_min(0.0) + scale).sqrt()
    return a2, p2, ap, lam1, lam2


def _calc_O(a, rho, dx):
    """exp(-K dx) of the constant opacity matrix, (4, 4, *batch)
    (radtrans_integrate.f90:615-683).  a: 4-tuple, rho: 3-tuple of batch
    tensors.

    Cells whose eigen-decomposition is unusable -- lam*dx tiny (degen),
    or |O| > 1 / NaN from lost cancellation (bad) -- take the cubic
    I - Z + Z^2/2 - Z^3/6 of the (near-)nilpotent polarized part, or
    scalar attenuation if that still breaks passivity."""
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
    ecp = 0.5 * (torch.exp(arg_p) + torch.exp(arg_m))
    ecm = 0.5 * (torch.exp(arg_p) - torch.exp(arg_m))
    eno = torch.exp((-aI * dx).clamp(lo, 60.0))
    ph = lam2 * dx
    cs = torch.cos(ph) * eno
    sn = torch.sin(ph) * eno
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


def _march(ac, rc, jc, dlam, cell_ok):
    """Streaming blocked march, far end first.  Each step builds the maps
    of BLK cells (batch (npix, BLK)), composes them (the farthest applied
    first) and applies the block to I; affine composition is associative,
    so the grouping is exact.  Cells past the near end are padding,
    masked to the identity.  Returns the observed (npix, 4)."""
    ncell = dlam.shape[-1]
    pad = (-ncell) % BLK

    def far_first(x):
        y = x.flip(-1)
        if pad:
            y = torch.cat([y, y.new_zeros(y.shape[:-1] + (pad,))], dim=-1)
        return y

    ac = [far_first(c) for c in ac]
    rc = [far_first(c) for c in rc]
    jn = far_first(jc[..., :-1])
    jf = far_first(jc[..., 1:])
    dlam = far_first(dlam)
    cell_ok = far_first(cell_ok)
    I = jc.new_zeros((4, 1, dlam.shape[0]))
    for lo in range(0, ncell + pad, BLK):
        blk = slice(lo, lo + BLK)
        acc = tuple(c[..., blk] for c in ac)
        rcc = tuple(c[..., blk] for c in rc)
        d = dlam[..., blk]
        O = _calc_O(acc, rcc, d)
        p = _cell_emission(O, acc, rcc, jn[..., blk], jf[..., blk], d)
        O, p = _mask_cells(O, p, cell_ok[..., blk])
        Ob, pb = O[..., 0], p[..., 0]
        for jj in range(1, BLK):
            Ob, pb = _compose((O[..., jj], p[..., jj]), (Ob, pb))
        I = _mm(Ob, I) + pb
    return I[:, 0].transpose(0, 1)


def observed_stokes(lam, j, K, method="formal", mask=None, max_tau=MAX_TAU):
    """Observer-side Stokes vector (npix, 4) of the formal solution.

    lam (npix, npts) affine parameter increasing along the trace; j
    (npix, npts, 4); K (npix, npts, 7); mask (npix, npts) validity.
    Midpoint opacity and linear-in-j emission per cell (2nd order);
    integration stops at the cell holding tau = max_tau."""
    if method not in ("formal", 2):
        raise NotImplementedError(f"integrator {method!r} is not ported")
    j, K = passivity_clamp(j, K)
    a = K[..., 0:4].movedim(-1, 0)
    rho = K[..., 4:7].movedim(-1, 0)
    jc = j.movedim(-1, 0)[:, None]                       # (4,1,npix,npts)
    dlam = lam[..., 1:] - lam[..., :-1]                  # (npix, ncell)
    _, cell_ok = _cell_tau_mask(lam, K, mask, max_tau)
    ac = tuple(0.5 * (c[..., :-1] + c[..., 1:]) for c in a)
    rc = tuple(0.5 * (c[..., :-1] + c[..., 1:]) for c in rho)
    return _march(ac, rc, jc, dlam, cell_ok)
