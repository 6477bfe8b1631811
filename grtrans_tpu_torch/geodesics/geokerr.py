"""Semi-analytic Kerr null geodesics, batched over (pixel, point).

Port of the float64 `trace`, `trace_polar` and `camera_delay` of
grtrans_tpu/geodesics/geokerr.py (a
redesign of the reference geokerr, Dexter & Agol 2009): rays are sampled
evenly in Mino time; u(lam) and mu(lam) come from one Biermann-Weierstrass
inversion each (ops/weierstrass.py); t, phi and the affine parameter are
per-segment Gauss-Legendre integrals with Hermite-interpolated nodes,
summed with a two-level blocked prefix sum.

The spin `a` and the observer's mu0 are Python floats; per-pixel
constants are (npix,) tensors that broadcast against (npix, npts).
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from grtrans_tpu_torch.geometry import kerr
from grtrans_tpu_torch.ops import polyroots
from grtrans_tpu_torch.ops import weierstrass as wss
from grtrans_tpu_torch.ops.intcast import to_int32
from grtrans_tpu_torch.ops.quadrature import gl_tensors

NQ_LAM = 48     # nodes for the one-off lam(u) integrals
NQ_SEG = 8      # nodes per segment for the cumulative t/phi/affine integrals
HOR_EPS = 1e-6  # stop this far (in u) inside of the horizon u_+
_TINY_U = 1e-37  # absolute backstop under the relative U floor
_PHASE_WIN = 4   # segments kept in lam space at each end of the window
_CUM_BLK = 16    # block width of the two-level prefix sum


class GeodesicBundle(NamedTuple):
    """Per-(pixel, point) geodesic data, arrays (npix, npts, ...)."""
    x: torch.Tensor       # (npix, npts, 4) BL coordinates (t, r, theta, phi)
    k: torch.Tensor       # (npix, npts, 4) wavevector (forward in time)
    lam: torch.Tensor     # (npix, npts) affine parameter along the trace
    mino: torch.Tensor    # (npix, npts) Mino time along the trace
    tpm: torch.Tensor     # (npix, npts) polar turning-point count
    tpr: torch.Tensor     # (npix, npts) radial turning-point count
    valid: torch.Tensor   # (npix, npts) sample validity mask
    status: torch.Tensor  # (npix,) 1 = ok, 0 = ray failed


def _bc(c, ndim):
    """Broadcast a (npix,)-shaped constant against an (npix, ...) array."""
    return c.reshape(c.shape + (1,) * (ndim - c.dim()))


# radial potential U(u) = 1 + (a^2-l^2-q2) u^2 + 2((a-l)^2+q2) u^3 - a^2 q2 u^4

def _u_coeffs(a, l, q2):
    return (torch.ones_like(l), torch.zeros_like(l), a * a - l * l - q2,
            2.0 * ((a - l) ** 2 + q2), -a * a * q2)


def _u_eval(cU, u):
    c0, c1, c2, c3, c4 = (_bc(c, u.dim()) for c in cU)
    return (((c4 * u + c3) * u + c2) * u + c1) * u + c0


def _radial_setup(a, l, q2, u0, uf):
    """Radial turning point u_turn and its Mino time lam_turn (+inf for
    rays that reach uf first)."""
    cU = _u_coeffs(a, l, q2)
    zr, zi = polyroots.quartic_roots(*cU)
    real = polyroots.real_roots_mask(zr, zi)
    # smallest real root above u0 (the motion starts at u0 toward larger u)
    cand = torch.where(real & (zr > u0[..., None] * (1 + 1e-12)), zr,
                       math.inf)
    u_turn = cand.amin(-1)
    turn = u_turn < uf

    # lam_turn = int_{u0}^{u_turn} du/sqrt(U) via u = u_turn - s^2
    x, w = gl_tensors(NQ_LAM, l)
    top = torch.where(turn, u_turn, u0 + 1.0)
    s0 = (top - u0).clamp_min(0.0).sqrt()
    s = s0[..., None] * x
    uu = top[..., None] - s * s
    h = _u_eval(cU, uu) / (s * s).clamp_min(1e-37)  # U/(u_t - u), finite
    f = 2.0 / h.clamp_min(1e-37).sqrt()
    lam_turn = (f * w).sum(-1) * s0
    lam_turn = torch.where(turn, lam_turn, math.inf)
    return cU, u_turn, lam_turn, turn


def _lam_of_u(cU, u0, u1):
    """int_{u0}^{u1} du/sqrt(U), U > 0 on the open interval."""
    x, w = gl_tensors(NQ_LAM, u0)
    uu = u0[..., None] + (u1 - u0)[..., None] * x
    f = 1.0 / _u_eval(cU, uu).clamp_min(1e-37).sqrt()
    return (f * w).sum(-1) * (u1 - u0)


# polar potential M(mu) = q2 + (a^2-l^2-q2) mu^2 - a^2 mu^4

def _m_coeffs(a, l, q2):
    return (q2, torch.zeros_like(l), a * a - l * l - q2, torch.zeros_like(l),
            -a * a * torch.ones_like(l))


def _polar_setup(a, l, q2, mu0, sm):
    """Polar landmarks: quarter period Q, first turning time lam_t1, first
    equator crossing lam_eq, period P and half period, for ordinary
    (q2 > 0) and vortical (q2 < 0) rays, with turning-point-regularizing
    angle substitutions so every integrand is smooth."""
    c2 = a * a - l * l - q2
    a2 = a * a
    if a2 < 1e-24:
        # a == 0: quadratic potential, single root q2/(l^2+q2)
        mplus = (q2 / (l * l + q2).clamp_min(1e-37)).clamp(0.0, 1.0)
        mminus = torch.full_like(l, -math.inf)
        a2mp = torch.zeros_like(l)
        a2mm = c2
    else:
        # stable biquadratic roots of a^2 m^2 - c2 m - q2 = 0 (m = mu^2)
        disc = (c2 * c2 + 4.0 * a2 * q2).clamp_min(0.0).sqrt()
        tmp = 0.5 * (c2 + torch.where(c2 >= 0, disc, -disc))
        r1 = tmp / a2
        tnz = tmp.abs() > 0
        r2 = torch.where(tnz, -q2 / torch.where(tnz, tmp, 1.0), 0.0)
        mplus = torch.maximum(r1, r2).clamp(0.0, 1.0)
        mminus = torch.minimum(r1, r2)
        a2mp = a2 * mplus
        a2mm = c2 - a2mp                     # = a^2 m-
    x, w = gl_tensors(NQ_LAM, l)

    # ordinary branch: mu = sqrt(m+) sin psi, dlam = dpsi / sqrt(D)
    Dconst = -a2mm

    def D_ord(psi):
        return (_bc(a2mp, psi.dim()) * psi.sin() ** 2
                + _bc(Dconst, psi.dim())).clamp_min(1e-37)

    psi_half = math.pi / 2.0
    psis = psi_half * x
    Q = (1.0 / D_ord(psis[None, :] * torch.ones_like(a2mp)[:, None]).sqrt()
         * w).sum(-1) * psi_half
    sqmp = mplus.clamp_min(1e-37).sqrt()
    psi0 = torch.arcsin((mu0 / sqmp).clamp(-1.0, 1.0))
    Ipsi0 = (1.0 / D_ord(psi0[..., None] * x).sqrt() * w).sum(-1) * psi0

    lam_t1_ord = Q - sm * Ipsi0
    toward_eq = sm * mu0 < 0.0
    lam_eq_ord = torch.where(toward_eq, Ipsi0.abs(), 2.0 * Q - Ipsi0.abs())
    P_ord = 4.0 * Q
    half_ord = 2.0 * Q

    # vortical branch (q2 < 0): |mu| in [sqrt(m-), sqrt(m+)]
    mm_v = mminus.clamp(1e-37, 1.0)
    dm_v = (mplus - mm_v).clamp_min(0.0)

    def D_vort(psi):
        return (a2 * (_bc(mm_v, psi.dim())
                      + _bc(dm_v, psi.dim()) * psi.sin() ** 2)
                ).clamp_min(1e-37)

    Lv = (1.0 / D_vort(psis[None, :] * torch.ones_like(a2mp)[:, None]).sqrt()
          * w).sum(-1) * psi_half
    arg = ((mu0 * mu0 - mm_v) / dm_v.clamp_min(1e-37)).clamp(0.0, 1.0).sqrt()
    psi0v = torch.arcsin(arg)
    Iv = (1.0 / D_vort(psi0v[..., None] * x).sqrt() * w).sum(-1) * psi0v
    outward = sm * torch.sign(mu0) > 0.0   # heading to the outer root
    lam_t1_v = torch.where(outward, Lv - Iv, Iv)

    vort = q2 < 0.0
    lam_t1 = torch.where(vort, lam_t1_v, lam_t1_ord)
    lam_eq = torch.where(vort, math.inf, lam_eq_ord)
    P = torch.where(vort, 2.0 * Lv, P_ord)
    half = torch.where(vort, Lv, half_ord)
    # q2 == 0: asymptotic approach to the equator, no oscillation
    asym = q2 == 0.0
    lam_t1 = torch.where(asym, math.inf, lam_t1)
    lam_eq = torch.where(asym, math.inf, lam_eq)
    P = torch.where(asym, math.inf, P)
    half = torch.where(asym, math.inf, half)
    return lam_t1, lam_eq, P, half


class _RaySetup(NamedTuple):
    cU: tuple
    cM: tuple
    g2u: torch.Tensor
    g3u: torch.Tensor
    g2m: torch.Tensor
    g3m: torch.Tensor
    u_turn: torch.Tensor
    lam_rturn: torch.Tensor
    turn: torch.Tensor
    lam_t1: torch.Tensor
    lam_eq: torch.Tensor
    P: torch.Tensor
    half: torch.Tensor
    sm: torch.Tensor
    u0: torch.Tensor
    mu0: torch.Tensor


def _setup(a, mu0, l, q2, sm, u0):
    uf = 1.0 / kerr.horizon(a) * (1.0 - HOR_EPS)
    u0v = torch.full_like(l, u0)
    mu0v = torch.full_like(l, mu0)
    cU, u_turn, lam_rturn, turn = _radial_setup(a, l, q2, u0v, uf)
    cM = _m_coeffs(a, l, q2)
    g2u, g3u = wss.quartic_invariants(cU[4], cU[3], cU[2], cU[1], cU[0])
    g2m, g3m = wss.quartic_invariants(cM[4], cM[3], cM[2], cM[1], cM[0])
    lam_t1, lam_eq, P, half = _polar_setup(a, l, q2, mu0v, sm)
    return _RaySetup(cU=cU, cM=cM, g2u=g2u, g3u=g3u, g2m=g2m, g3m=g3m,
                     u_turn=u_turn, lam_rturn=lam_rturn, turn=turn,
                     lam_t1=lam_t1, lam_eq=lam_eq, P=P, half=half,
                     sm=sm, u0=u0v, mu0=mu0v), uf


def _eval_u(st, lam):
    """u(lam).  The radial motion is symmetric about its turning point,
    so lam is reflected into the first half, away from wp's period pole."""
    c0, c1, c2, c3, c4 = st.cU
    nd = lam.dim()
    lt = _bc(st.lam_rturn, nd)
    lam_eff = torch.where(torch.isfinite(lt) & (lam > lt), 2.0 * lt - lam,
                          lam)
    return wss.invert_quartic(_bc(c4, nd), _bc(c3, nd), _bc(c2, nd),
                              _bc(c1, nd), _bc(c0, nd), _bc(st.u0, nd),
                              1.0, lam_eff, g2=_bc(st.g2u, nd),
                              g3=_bc(st.g3u, nd))


def _eval_mu(st, lam):
    """mu(lam), with lam reduced modulo the polar period."""
    c0, c1, c2, c3, c4 = st.cM
    nd = lam.dim()
    P = _bc(st.P, nd)
    lam_red = torch.where(torch.isfinite(P), lam - P * torch.floor(lam / P),
                          lam)
    return wss.invert_quartic(_bc(c4, nd), _bc(c3, nd), _bc(c2, nd),
                              _bc(c1, nd), _bc(c0, nd), _bc(st.mu0, nd),
                              _bc(st.sm, nd), lam_red, g2=_bc(st.g2m, nd),
                              g3=_bc(st.g3m, nd))


def _phase_integrands_radial(a, l, u):
    """Radial parts of d(t, phi, affine)/d lam_Mino as functions of u."""
    r = 1.0 / u
    d = r * r - 2.0 * r + a * a
    P = r * r + a * a - a * l
    return (r * r + a * a) * P / d, a * P / d, r * r


def _phase_integrands_polar(a, l, mu):
    """Polar parts of the phase integrands; 1 - mu^2 floored at 3 eps."""
    dt_m = a * (l - a * (1.0 - mu * mu))
    one_m = (1.0 - mu * mu).clamp_min(3.0 * torch.finfo(mu.dtype).eps)
    return dt_m, -a + l / one_m, a * a * mu * mu


def _hermite_nodes_ep(y0, y1, d0, d1, h, x):
    """Cubic Hermite values at nodes x of segments with endpoint values
    y0, y1 and derivatives d0, d1 (each (..., nseg))."""
    y0, y1, d0, d1, h = (v[..., None] for v in (y0, y1, d0, d1, h))
    t2 = x * x
    t3 = t2 * x
    return ((2 * t3 - 3 * t2 + 1) * y0 + (t3 - 2 * t2 + x) * h * d0
            + (-2 * t3 + 3 * t2) * y1 + (t3 - t2) * h * d1)


def _signs_and_counts(st, lam):
    """Traced-direction signs of du/dlam, dmu/dlam and turning counts."""
    nd = lam.dim()
    tpr = (lam > _bc(st.lam_rturn, nd)).to(torch.int32)
    lam_t1 = _bc(st.lam_t1, nd)
    n_after = torch.floor((lam - lam_t1) / _bc(st.half, nd)) + 1.0
    tpm = to_int32(torch.where(lam >= lam_t1, n_after, 0.0))
    su = 1.0 - 2.0 * (tpr % 2).to(lam.dtype)
    smu = _bc(st.sm, nd) * (1.0 - 2.0 * (tpm % 2).to(lam.dtype))
    return su, smu, tpr, tpm


def _blocked_cumsum(s):
    """Prefix sum along the last axis as within-block sums of _CUM_BLK
    segments plus exclusive block offsets (the two-level sum of
    grtrans_tpu, kept for identical rounding structure)."""
    n = s.shape[-1]
    if n < 2 * _CUM_BLK:
        return s.cumsum(-1)
    pad = (-n) % _CUM_BLK
    if pad:
        s = torch.cat([s, s.new_zeros(s.shape[:-1] + (pad,))], dim=-1)
    nb = s.shape[-1] // _CUM_BLK
    within = s.reshape(s.shape[:-1] + (nb, _CUM_BLK)).cumsum(-1)
    bsum = within[..., -1]
    off = bsum.cumsum(-1) - bsum
    return (off[..., None] + within).reshape(s.shape)[..., :n]


def _cumulative_phases(st, a, l, lam_grid, u_grid=None, mu_grid=None,
                       node_interp=False):
    """Cumulative (t, phi, affine) along lam_grid, per-segment GL.

    The polar parts are integrated in Mino time.  The radial parts behave
    like r^2 ~ 1/lam^2 near the observer, so they are integrated in ln r,
    except on segments next to the radial turning point, which keep the
    lam-space rule.

    node_interp=True (dense grids: trace()): u and mu at the nodes come
    from cubic Hermite interpolation of the grid samples (du/dlam =
    +-sqrt(U), dmu/dlam = +-sqrt(M) are closed-form).  On trace()'s
    uniform grid the segments next to the turn sit at static indices (the
    turn is the grid midpoint; a grazing plunge turns just past the end),
    so the lam-space rule is evaluated only on a window there.  Sparse
    grids (trace_polar, camera_delay) keep node_interp=False: exact
    Weierstrass evaluation at every node, both rules on every segment."""
    x, w = gl_tensors(NQ_SEG, lam_grid)
    a_ = lam_grid[..., :-1]
    b_ = lam_grid[..., 1:]
    dseg = b_ - a_
    nd = lam_grid.dim()
    if u_grid is None:
        u_grid = _eval_u(st, lam_grid)
    if node_interp:
        if mu_grid is None:
            mu_grid = _eval_mu(st, lam_grid)
        su_g, smu_g, _, _ = _signs_and_counts(st, lam_grid)
        du_g = su_g * _u_eval(st.cU, u_grid).clamp_min(0.0).sqrt()
        cM = st.cM
        Mv = ((_bc(cM[4], nd) * mu_grid ** 2 + _bc(cM[2], nd))
              * mu_grid ** 2 + _bc(cM[0], nd))
        dmu_g = smu_g * Mv.clamp_min(0.0).sqrt()
        mun = _hermite_nodes_ep(mu_grid[..., :-1], mu_grid[..., 1:],
                                dmu_g[..., :-1], dmu_g[..., 1:], dseg,
                                x).clamp(-1.0, 1.0)
    else:
        nodes = a_[..., None] + dseg[..., None] * x      # (npix, nseg, nq)
        un = _eval_u(st, nodes)
        mun = _eval_mu(st, nodes)
    l_ = _bc(l, nd + 1)

    # polar parts: lam space everywhere
    dt_m, dph_m, daff_m = _phase_integrands_polar(a, l_, mun)
    seg_t = (dt_m * w).sum(-1) * dseg
    seg_p = (dph_m * w).sum(-1) * dseg
    seg_a = (daff_m * w).sum(-1) * dseg

    # radial parts, lam-space rule (windowed on long grids)
    nseg = dseg.shape[-1]
    windowed = node_interp and nseg >= 4 * _PHASE_WIN
    if windowed:
        mid = nseg // 2
        widx = np.unique(np.clip(np.concatenate([
            np.arange(0, _PHASE_WIN), np.arange(mid - _PHASE_WIN,
                                                mid + _PHASE_WIN),
            np.arange(nseg - _PHASE_WIN, nseg)]), 0, nseg - 1))
        wi = torch.as_tensor(widx, device=lam_grid.device)
        un = _hermite_nodes_ep(u_grid[..., wi], u_grid[..., wi + 1],
                               du_g[..., wi], du_g[..., wi + 1],
                               dseg[..., wi], x)
        dsl = dseg[..., wi]
    else:
        if node_interp:
            un = _hermite_nodes_ep(u_grid[..., :-1], u_grid[..., 1:],
                                   du_g[..., :-1], du_g[..., 1:], dseg, x)
        dsl = dseg
    dt_r, dph_r, daff_r = _phase_integrands_radial(a, l_, un)
    lam_t = (dt_r * w).sum(-1) * dsl
    lam_p = (dph_r * w).sum(-1) * dsl
    lam_a = (daff_r * w).sum(-1) * dsl

    # radial parts, ln r rule: f(r) = T(r)/(r^2 sqrt(U)) -> f_inf with a
    # 1/r tail, so the f_inf part is integrated exactly and the rest in
    # ln r.  The segment log-width comes from the u difference (exact for
    # close values), not from a difference of logs.
    u_lo = torch.minimum(u_grid[..., :-1], u_grid[..., 1:])
    u_hi = torch.maximum(u_grid[..., :-1], u_grid[..., 1:])
    u_lo_s = u_lo.clamp_min(1e-12)
    r_lo = 1.0 / u_hi.clamp_min(1e-12)
    r_hi = 1.0 / u_lo_s
    dlnr = torch.log1p((u_hi - u_lo) / u_lo_s)
    rn = r_lo[..., None] * torch.exp(dlnr[..., None] * x)
    urn = 1.0 / rn
    Uraw = _u_eval(st.cU, urn)
    # relative floor: U near a root is a cancelling sum of O(1) terms
    c0, c1, c2, c3, c4 = (_bc(c, urn.dim()) for c in st.cU)
    uscale = ((((c4.abs() * urn + c3.abs()) * urn + c2.abs()) * urn
               + c1.abs()) * urn + c0.abs())
    eps_u = torch.finfo(u_grid.dtype).eps
    Un = torch.maximum(Uraw, 16.0 * eps_u * uscale + _TINY_U)
    fac = 1.0 / (rn * rn * Un.sqrt())
    dt_rr, dph_rr, daff_rr = _phase_integrands_radial(a, l_, urn)
    dr = r_hi - r_lo
    r_t = dr + ((dt_rr * fac - 1.0) * rn * w).sum(-1) * dlnr
    r_p = (dph_rr * fac * rn * w).sum(-1) * dlnr
    r_a = dr + ((daff_rr * fac - 1.0) * rn * w).sum(-1) * dlnr

    # keep the lam-space rule on segments that abut the turning point
    lt = _bc(st.lam_rturn, a_.dim())
    near_turn = (b_ > lt - dseg) & (a_ < lt + dseg)
    rad = []
    for r_x, lam_x in ((r_t, lam_t), (r_p, lam_p), (r_a, lam_a)):
        if windowed:
            r_x = r_x.clone()
            r_x[..., wi] = torch.where(near_turn[..., wi], lam_x,
                                       r_x[..., wi])
        else:
            r_x = torch.where(near_turn, lam_x, r_x)
        rad.append(r_x)
    s3 = torch.stack([seg_t + rad[0], seg_p + rad[1], seg_a + rad[2]])
    cum3 = _blocked_cumsum(s3)
    cum3 = torch.cat([torch.zeros_like(cum3[..., :1]), cum3], dim=-1)
    return cum3[0], cum3[1], cum3[2]


def trace(a, mu0, alpha, beta, l, q2, sm, u0, npts, uout=None, phi0=0.0):
    """Trace rays from the camera: npts samples even in Mino time, from
    u = uout (default: the observer's u0) to the horizon, or back out to
    uout after a radial turning point (reference standard=1 sampling).

    alpha, beta, l, q2, sm are (npix,) float64 tensors; a, mu0, u0, uout
    and phi0 are floats.  Returns a GeodesicBundle on their device."""
    st, uf = _setup(a, mu0, l, q2, sm, u0)

    lam_start = torch.zeros_like(l)
    if uout is not None:
        uo = torch.minimum(torch.full_like(l, uout), st.u_turn * (1 - 1e-9))
        lam_start = _lam_of_u(st.cU, st.u0, torch.maximum(uo, st.u0))
    lam_plunge = _lam_of_u(st.cU, st.u0, torch.full_like(l, uf))
    lam_end = torch.where(st.turn, 2.0 * st.lam_rturn - lam_start,
                          lam_plunge)

    # i / (npts - 1), correctly rounded, with the last node exactly 1
    frac = (torch.arange(npts, dtype=l.dtype, device=l.device)
            / max(npts - 1, 1))
    lam = lam_start[:, None] + (lam_end - lam_start)[:, None] * frac[None, :]

    u = _eval_u(st, lam)
    mu = _eval_mu(st, lam).clamp(-1.0, 1.0)
    su, smu, tpr, tpm = _signs_and_counts(st, lam)
    dt_c, dph_c, aff_c = _cumulative_phases(st, a, l, lam, u, mu,
                                            node_interp=True)

    r = 1.0 / u.clamp_min(1e-12)
    th = torch.arccos(mu)
    t = -dt_c
    phi = math.pi * phi0 - dph_c
    if abs(mu0) == 1.0:
        # pole-on viewing: rotate by the pixel azimuth (geodesics.f90:339)
        phi = phi + math.copysign(1.0, mu0) * torch.atan2(beta, alpha)[:, None]
    k = kerr.calc_nullp(q2[:, None], l[:, None], a, r, mu, su, smu)

    x = torch.stack([t, r, th, phi], dim=-1)
    valid = (u > 0.0) & (u < uf * (1 + 10 * HOR_EPS)) & torch.isfinite(u)
    status = torch.isfinite(u).all(-1).to(torch.int32)
    return GeodesicBundle(x=x, k=k, lam=aff_c, mino=lam, tpm=tpm, tpr=tpr,
                          valid=valid, status=status)


def camera_delay(a, mu0, alpha, beta, l, q2, sm, u0, uout):
    """Per-ray coordinate-time delay from the camera (u0) to the trace
    start (uout), which trace(uout=...) leaves out of its t coordinate
    (the slow-light t0 pre-pass; reference geodesics.f90:113-128,
    pgrtrans.f90:177-191).  Returns (npix,)."""
    st, _ = _setup(a, mu0, l, q2, sm, u0)
    uo = torch.minimum(torch.full_like(l, uout), st.u_turn * (1 - 1e-9))
    lam_start = _lam_of_u(st.cU, st.u0, torch.maximum(uo, st.u0))
    # _cumulative_phases keeps the lam-space rule on a segment that comes
    # within its own width of the turning point; over [0, lam_start] that
    # rule would take the r^2 ~ 1 / lam^2 rise at the camera.  So a ray
    # whose trace starts past half its turning time is cut at lam_turn / 2:
    # the ln r rule from the camera, then a segment near the turn (the
    # second segment has zero width for every other ray)
    lam_mid = torch.minimum(lam_start, 0.5 * st.lam_rturn)
    grid = torch.stack([torch.zeros_like(lam_start), lam_mid, lam_start],
                       dim=-1)
    dt_c, _, _ = _cumulative_phases(st, a, l, grid)
    return dt_c[..., -1]


def trace_polar(a, mu0, alpha, beta, l, q2, sm, u0, npts=1, phi0=0.0,
                crossing=1):
    """Trace to the `crossing`-th crossing of the equatorial plane
    (reference standard=2, thin-disk imaging).  npts=1 returns the
    crossing point alone; npts>1 samples evenly in Mino time from just
    after the observer to the crossing.  Rays that never cross are
    invalid and have status 0."""
    st, uf = _setup(a, mu0, l, q2, sm, u0)
    lam_eq = st.lam_eq + (crossing - 1) * st.half
    hit = torch.isfinite(lam_eq)
    lam_eq_safe = torch.where(hit, lam_eq, 1.0)

    # i / npts for i = 1..npts: the observer's point is left out
    frac = torch.arange(1, npts + 1, dtype=l.dtype, device=l.device) / npts
    lam = lam_eq_safe[:, None] * frac[None, :]

    u = _eval_u(st, lam)
    mu = _eval_mu(st, lam).clamp(-1.0, 1.0)
    # exactly the equator at the last point
    mu = torch.cat([mu[..., :-1],
                    torch.where(hit, 0.0, mu[..., -1])[..., None]], dim=-1)
    su, smu, tpr, tpm = _signs_and_counts(st, lam)

    grid = torch.cat([torch.zeros_like(lam[..., :1]), lam], dim=-1)
    dt_c, dph_c, aff_c = (c[..., 1:]
                          for c in _cumulative_phases(st, a, l, grid))

    r = 1.0 / u.clamp_min(1e-12)
    th = torch.arccos(mu)
    t = -dt_c
    phi = math.pi * phi0 - dph_c
    if abs(mu0) == 1.0:
        phi = phi + math.copysign(1.0, mu0) * torch.atan2(beta, alpha)[:, None]
    k = kerr.calc_nullp(q2[:, None], l[:, None], a, r, mu, su, smu)
    x = torch.stack([t, r, th, phi], dim=-1)
    valid = hit[:, None] & (u > 0.0) & (u < uf) & torch.isfinite(u)
    status = valid[..., -1].to(torch.int32)
    return GeodesicBundle(x=x, k=k, lam=aff_c, mino=lam, tpm=tpm, tpr=tpr,
                          valid=valid, status=status)
