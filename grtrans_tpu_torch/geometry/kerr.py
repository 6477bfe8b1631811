"""Kerr spacetime in Boyer-Lindquist coordinates: metrics, the LNRF
frame and null wavevectors.  Elementwise maps over tensors; the spin `a`
is a Python float.  Port of the parts of grtrans_tpu/geometry/kerr.py on
the render path (reference kerr.f90:255-474)."""

import math

import torch


def safe_sqrt(x):
    """sqrt clamped at zero (0 where x <= 0)."""
    pos = x > 0.0
    return torch.where(pos, torch.where(pos, x, 1.0).sqrt(), 0.0)


def horizon(a):
    """Outer horizon radius r_+ = 1 + sqrt(1-a^2)."""
    return 1.0 + math.sqrt(1.0 - a * a)


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
