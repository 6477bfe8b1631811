"""Kerr spacetime in Boyer-Lindquist coordinates: metrics, the LNRF
frame and null wavevectors.  Elementwise maps over tensors; the spin `a`
is a Python float.  Port of the parts of grtrans_tpu/geometry/kerr.py on
the render path (reference kerr.f90: krolikc :109, calcg :181, calc_nullp
:255, metrics :337-400, LNRF frame :402-474, calc_polar_psi :954, BL <-> KS shifts :131-162,
calc_polvec :998, calc_kappapw :1047, plunging flow :1120-1190)."""

import math

import torch

from grtrans_tpu_torch.geometry import fourvector as fv


def safe_sqrt(x):
    """sqrt clamped at zero (0 where x <= 0)."""
    pos = x > 0.0
    return torch.where(pos, torch.where(pos, x, 1.0).sqrt(), 0.0)


def horizon(a):
    """Outer horizon radius r_+ = 1 + sqrt(1-a^2)."""
    return 1.0 + math.sqrt(1.0 - a * a)


def delta(r, a):
    """Delta = r^2 - 2r + a^2, expanded (grtrans_tpu's public form)."""
    return r * r - 2.0 * r + a * a


def _delta(r, a):
    """Delta = r^2 - 2r + a^2 in the factored form (r - r+)(r - r-),
    which stays exact near the horizon."""
    h = math.sqrt(max(1.0 - a * a, 0.0))
    return (r - (1.0 + h)) * (r - (1.0 - h))


def metric_cov(r, th, a):
    """Covariant BL metric, packed (..., 10), in the dtype of r
    (kerr.f90:381-400)."""
    r, th = torch.broadcast_tensors(r, th)
    cth = th.cos()
    sth = th.sin()
    d = _delta(r, a)
    rho2 = r * r + a * a * cth * cth
    sigma = (r * r + a * a) ** 2 - a * a * d * sth * sth
    z = torch.zeros_like(r)
    g = [-(d - a * a * sth * sth) / rho2,            # tt
         z, z,
         -2.0 * a * r * sth * sth / rho2,            # tph
         rho2 / d,                                    # rr
         z, z,
         rho2,                                        # thth
         z,
         sigma / rho2 * sth * sth]                    # phph
    return torch.stack(g, dim=-1)


def metric_con(r, th, a):
    """Contravariant BL metric, packed (..., 10) (kerr.f90:337-358)."""
    r, th = torch.broadcast_tensors(r, th)
    cth = th.cos()
    sth = th.sin()
    d = _delta(r, a)
    rho2 = r * r + a * a * cth * cth
    z = torch.zeros_like(r)
    g = [-((r * r + a * a) ** 2 - a * a * d * sth * sth) / rho2 / d,  # tt
         z, z,
         -2.0 * a * r / rho2 / d,                     # tph
         d / rho2,                                     # rr
         z, z,
         1.0 / rho2,                                   # thth
         z,
         (d - a * a * sth * sth) / (d * rho2 * sth * sth)]  # phph
    return torch.stack(g, dim=-1)


def ks_metric_cov(r, th, a):
    """Covariant Kerr-Schild spherical metric, packed (..., 10), float64
    (kerr.f90:315-335)."""
    r, th = torch.broadcast_tensors(r.to(torch.float64),
                                    th.to(torch.float64))
    cth, sth = th.cos(), th.sin()
    rho2 = r * r + a * a * cth * cth
    psi4 = 2.0 * r / rho2
    z = torch.zeros_like(r)
    g = [-(1.0 - psi4),                                  # tt
         psi4,                                           # tr
         z,
         -a * sth * sth * psi4,                          # tph
         1.0 + psi4,                                     # rr
         z,
         -a * sth * sth * (1.0 + psi4),                  # rph
         rho2,                                           # thth
         z,
         sth * sth * (rho2 + a * a * (1.0 + psi4) * sth * sth)]  # phph
    return torch.stack(g, dim=-1)


def bl2ks_time(r, t, a):
    """BL -> KS time shift (kerr.f90:147-154)."""
    sq = math.sqrt(1.0 - a * a)
    return (t + torch.log(r * r - 2.0 * r + a * a)
            + 1.0 / (2.0 * sq) * torch.log((r - 1.0 - sq) / (r - 1.0 + sq)))


def bl2ks_phi(r, ph, a):
    """BL -> KS azimuth shift (kerr.f90:156-162)."""
    sq = math.sqrt(1.0 - a * a)
    return ph + a / (2.0 * sq) * torch.log((r - 1.0 - sq) / (r - 1.0 + sq))


def uks2ubl(uks, r, a):
    """KS spherical four-vector -> BL (Font+1999; kerr.f90:131-144)."""
    d = r * r - 2.0 * r + a * a
    ut = uks[..., 0] - 2.0 * r / d * uks[..., 1]
    uph = uks[..., 3] - a / d * uks[..., 1]
    return torch.stack([ut, uks[..., 1], uks[..., 2], uph], dim=-1)


def calc_rms(a):
    """ISCO radius (prograde for a > 0), a Python float (kerr.f90:101-107)."""
    z1 = 1.0 + (1.0 - a * a) ** (1.0 / 3.0) * ((1.0 + a) ** (1.0 / 3.0)
                                               + (1.0 - a) ** (1.0 / 3.0))
    z2 = math.sqrt(3.0 * a * a + z1 * z1)
    sign = (a > 0) - (a < 0)
    return 3.0 + z2 - sign * math.sqrt((3.0 - z1) * (3.0 + z1 + 2.0 * z2))


def calc_rms_constants(a):
    """(E_ms, L_ms, r_ms) of the marginally stable orbit, Python floats
    (kerr.f90:1129-1138)."""
    rms = calc_rms(a)
    v = 1.0 / math.sqrt(rms)
    den = math.sqrt(1.0 - 3.0 * v * v + 2.0 * a * v ** 3)
    ems = (1.0 - 2.0 * v * v + a * v ** 3) / den
    lms = rms * v * (1.0 - 2.0 * a * v ** 3 + a * a * v ** 4) / den
    return ems, lms, rms


def krolikc(r, a):
    """Page-Thorne / Krolik flux correction factor of the thin disk
    (kerr.f90:109-129).  The roots y1..y3 depend on the spin alone and
    stay Python floats."""
    yms = math.sqrt(calc_rms(a))
    y = r.sqrt()
    y1 = 2.0 * math.cos((math.acos(a) - math.pi) / 3.0)
    y2 = 2.0 * math.cos((math.acos(a) + math.pi) / 3.0)
    y3 = -2.0 * math.cos(math.acos(a) / 3.0)
    arg1 = 3.0 * a / (2.0 * y)
    arg2 = 3.0 * (y1 - a) ** 2 / (y * y1 * (y1 - y2) * (y1 - y3))
    arg3 = 3.0 * (y2 - a) ** 2 / (y * y2 * (y2 - y1) * (y2 - y3))
    arg4 = 3.0 * (y3 - a) ** 2 / (y * y3 * (y3 - y1) * (y3 - y2))
    return (1.0 - yms / y - arg1 * torch.log(y / yms)
            - arg2 * torch.log((y - y1) / (yms - y1))
            - arg3 * torch.log((y - y2) / (yms - y2))
            - arg4 * torch.log((y - y3) / (yms - y3)))


def _lnrf_factors(r, mu, a):
    d = r * r - 2.0 * r + a * a
    ar = (r * r + a * a) ** 2 - a * a * d * (1.0 - mu * mu)
    rho = r * r + a * a * mu * mu
    enu = (d * rho / ar).sqrt()
    emu1 = (rho / d).sqrt()
    emu2 = rho.sqrt()
    epsi = (1.0 - mu * mu).sqrt() * (ar / rho).sqrt()
    om = 2.0 * a * r / ar
    return d, ar, rho, enu, emu1, emu2, epsi, om


def lnrf_frame(vr, vt, omega, r, a, th):
    """Coordinate 3-velocity (vr, vth, Omega = dphi/dt) -> LNRF physical
    velocity (kerr.f90:402-425); zero where Delta <= 0."""
    d, ar, rho, enu, emu1, emu2, epsi, om = _lnrf_factors(r, th.cos(), a)
    vrl = emu1 / enu * vr
    vtl = emu2 / enu * vt
    vpl = epsi / enu * (omega - om)
    ok = d > 0.0
    return (torch.where(ok, vrl, 0.0), torch.where(ok, vtl, 0.0),
            torch.where(ok, vpl, 0.0))


def lnrf_frame_inv(vrl, vtl, vpl, r, a, th):
    """LNRF physical velocity -> coordinate (vr, vth, Omega)
    (kerr.f90:451-474); zero where Delta <= 0."""
    d, ar, rho, enu, emu1, emu2, epsi, om = _lnrf_factors(r, th.cos(), a)
    vr = enu / emu1 * vrl
    vt = enu / emu2 * vtl
    omega = enu / epsi * vpl + om
    ok = d > 0.0
    return (torch.where(ok, vr, 0.0), torch.where(ok, vt, 0.0),
            torch.where(ok, omega, 0.0))


def calcg(u, mu, q2, l, a, tpm, tpr, su, sm, vrl, vtl, vpl):
    """Redshift g of a photon with constants (q2, l) that meets gas of
    LNRF velocity (vrl, vtl, vpl) (kerr.f90:181-218).  tpm, tpr are
    integer tensors of turning-point counts."""
    r = 1.0 / u
    d, ar, rho, enu, emu1, emu2, epsi, om = _lnrf_factors(r, mu, a)
    sr = (1.0 - 2.0 * (tpr % 2).to(u.dtype)) * su
    st = -(1.0 - 2.0 * (tpm % 2).to(u.dtype)) * sm
    omega = torch.where(epsi != 0.0, enu / epsi * vpl + om, 0.0)
    gam = 1.0 / (1.0 - (vrl ** 2 + vtl ** 2 + vpl ** 2)).sqrt()
    rr = (-a * a * q2 * u ** 4 + 2.0 * u ** 3 * (q2 + (a - l) ** 2)
          + u * u * (a * a - q2 - l * l) + 1.0)
    tt = (q2 + mu * mu * (a * a - l * l - q2) - a * a * mu ** 4) \
        / (1.0 - mu * mu)
    tt = safe_sqrt(tt)
    rr = safe_sqrt(rr) * r * r
    return enu / gam / (1.0 - l * omega - emu1 * enu * vrl / rho * sr * rr
                        - emu2 * enu * vtl / rho * st * tt)


def calc_nullp(q2, l, a, r, mu, su, smu):
    """Photon wavevector k^mu (contravariant BL, forward in time) from the
    constants of motion (kerr.f90:255-290).  su/smu are the traced signs
    of du/dlam and dmu/dlam at the point.

    1 - mu^2 is floored at 3 eps of mu's dtype: a pole-grazing sample
    clipped to mu = +-1 would otherwise give 0/0 in k^theta; exact
    pole-crossers have l = 0, so k^phi's l/(1-mu^2) term vanishes too."""
    u = 1.0 / r
    rho2 = r * r + a * a * mu * mu
    d = r * r - 2.0 * r + a * a
    mu2 = mu * mu
    u2 = u * u
    # x**4 as (x*x)*(x*x), the product XLA forms for integer_pow(x, 4)
    Mf = q2 + (a * a - q2 - l * l) * mu * mu - a * a * (mu2 * mu2)
    eps3 = 3.0 * torch.finfo(mu.dtype).eps
    one_m = (1.0 - mu * mu).clamp_min(eps3)
    kmu = smu * safe_sqrt(Mf) / one_m.sqrt() / rho2
    Uf = (1.0 + (a * a - q2 - l * l) * u * u
          + 2.0 * ((a - l) ** 2 + q2) * u ** 3 - a * a * q2 * (u2 * u2))
    kr = su * r * r * safe_sqrt(Uf) / rho2
    kt = (-a * (a * (1.0 - mu * mu) - l)
          + (r * r + a * a) / d * (r * r + a * a - a * l)) / rho2
    kph = (-a + l / one_m + a / d * (r * r + a * a - a * l)) / rho2
    return torch.stack(torch.broadcast_tensors(kt, kr, kmu, kph), dim=-1)


def calc_u0(g_cov, vr, vth, vph):
    """u^t from the BL coordinate 3-velocity (kerr.f90:1120-1127); 1.0
    where the 3-velocity is spacelike (callers mask those points)."""
    den = (g_cov[..., 0] + g_cov[..., 4] * vr ** 2
           + g_cov[..., 7] * vth ** 2 + g_cov[..., 9] * vph ** 2
           + 2.0 * g_cov[..., 3] * vph)
    ok = den < 0.0
    return torch.where(ok, (-1.0 / torch.where(ok, den, -1.0)).sqrt(), 1.0)


def calc_plunging_vel(a, r):
    """Equatorial plunging four-velocity inside the ISCO (Hughes 2000/01;
    kerr.f90:1140-1166)."""
    ems, lms, _ = calc_rms_constants(a)
    gcon = metric_con(r, torch.full_like(r, math.pi / 2.0), a)
    p_t = -gcon[..., 0] * ems + gcon[..., 3] * lms
    den = -gcon[..., 4] * (1.0 + gcon[..., 0] * ems * ems
                           - 2.0 * gcon[..., 3] * ems * lms
                           + gcon[..., 9] * lms * lms)
    p_r = -safe_sqrt(den)
    p_ph = -gcon[..., 3] * ems + gcon[..., 9] * lms
    return torch.stack([p_t, p_r, torch.zeros_like(p_t), p_ph], dim=-1)


def rms_vel(a, th, r):
    """Plunging-region four-velocity off the equatorial plane: the
    equatorial plunging LNRF velocity re-expressed at polar angle th
    (kerr.f90:1168-1190)."""
    fueq = calc_plunging_vel(a, r)
    theq = torch.full_like(r, math.pi / 2.0)
    vrl, vtl, vpl = lnrf_frame(fueq[..., 1] / fueq[..., 0],
                               fueq[..., 2] / fueq[..., 0],
                               fueq[..., 3] / fueq[..., 0], r, a, theq)
    vr, vt, om = lnrf_frame_inv(vrl, vtl, vpl, r, a, th)
    u0 = calc_u0(metric_cov(r, th, a), vr, vt, om)
    return torch.stack([u0, u0 * vr, u0 * vt, u0 * om], dim=-1)


def calc_polvec(r, mu, p, a, psi):
    """Thin-disk polarization basis vector (f^0 = 0 convention, Agol 1997)
    rotated by the angle psi (a number) in the disk frame
    (kerr.f90:998-1045).  Divides by the local photon energy ptt and by
    sqrt(Delta): NaN or inf inside the horizon and where ptt = 0, which
    callers mask."""
    d = r ** 2 - 2.0 * r + a ** 2
    ar = (r * r + a * a) ** 2 - a * a * d * (1.0 - mu * mu)
    om = 2.0 * a * r / ar
    rho = r ** 2 + a ** 2 * mu ** 2
    ptt = r * (d / ar).sqrt() * p[..., 0]
    prt = r / d.sqrt() * p[..., 1]
    ptht = r * p[..., 2]
    ppht = ar.sqrt() / r * (p[..., 3] - om * p[..., 0])
    vel = 1.0 / (r ** 1.5 + a)
    epsi = (1.0 - mu * mu).sqrt() * (ar / rho).sqrt()
    enu = (d * rho / ar).sqrt()
    vel = epsi / enu * (vel - om)
    frl = d.sqrt() / r * (vel * (ptt - prt ** 2 / ptt) - ppht)
    fthl = -vel * prt * ptht / ptt / r
    fphl = r * prt / ar.sqrt() * (1.0 - vel * ppht / ptt)
    frp = d.sqrt() * ptht * prt / r * (-1.0 + vel * ppht / ptt)
    fthp = 1.0 / r * (prt ** 2 + (1.0 + vel ** 2) * ppht ** 2
                      - 2.0 * vel * ppht * ptt + vel * ptht ** 2 * ppht / ptt)
    fphp = r * ptht / ar.sqrt() * (-(1.0 + vel ** 2) * ppht + vel * ptt
                                   + vel * ppht ** 2 / ptt)
    cpsi, spsi = math.cos(psi), math.sin(psi)
    fr = cpsi * frl + spsi * frp
    fth = cpsi * fthl + spsi * fthp
    fph = cpsi * fphl + spsi * fphp
    f = torch.stack([torch.zeros_like(fr), fr, fth, fph], dim=-1)
    norm = fv.dot(metric_cov(r, torch.arccos(mu), a), f, f)
    return f / norm.sqrt()[..., None]


def calc_kappapw(a, r, mu, p, f):
    """Complex Walker-Penrose constant (re, im) of a vector f
    perpendicular to p (kerr.f90:1047-1064)."""
    alpha = (p[..., 0] * f[..., 1] - p[..., 1] * f[..., 0]) \
        + a * (1.0 - mu ** 2) * (p[..., 1] * f[..., 3] - p[..., 3] * f[..., 1])
    beta = (r ** 2 + a ** 2) * (1.0 - mu ** 2).sqrt() \
        * (p[..., 3] * f[..., 2] - p[..., 2] * f[..., 3]) \
        - a * (1.0 - mu ** 2).sqrt() * (p[..., 0] * f[..., 2]
                                        - p[..., 2] * f[..., 0])
    # kappa = (alpha - i beta)(r - i a mu)
    re = alpha * r - beta * a * mu
    im = -(alpha * a * mu + beta * r)
    return re, im


def calc_polar_psi(r, muf, q2, a, alpha, beta, rshift, mus, p):
    """Doubled thin-disk polarization angle (c2psi, s2psi) and the
    emission cosine for electron-scattering polarization
    (kerr.f90:954-996).  mus, the observer's cosine, is a number."""
    f = calc_polvec(r, muf, p, a, 0.0)
    kre, kim = calc_kappapw(a, r, muf, p, f)
    kappa2 = kre
    kappa1 = -kim
    gammac = -alpha - a * (1.0 - mus ** 2)
    den = beta * kappa2 - gammac * kappa1
    num = -beta * kappa1 - gammac * kappa2
    polarpsi = torch.atan2(den, num)
    s2psi = torch.sin(2.0 * polarpsi)
    c2psi = torch.cos(2.0 * polarpsi)
    cosne = rshift * safe_sqrt(q2) / r
    return c2psi, s2psi, cosne
