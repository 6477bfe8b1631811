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
