"""Thermal polarized synchrotron emission, absorption and Faraday
coefficients.  Port of grtrans_tpu/emis/polsynch.py (reference
polsynchemis.f90: polsynchth :700-863, synchemis :865-904, sympolemisth
:915-1012, bnu :1014-1032).

Every function returns the 11-coefficient layout

    [j_I, j_Q, j_U, j_V, a_I, a_Q, a_U, a_V, rho_Q, rho_U, rho_V]

and is elementwise over broadcast tensors.  torch.where evaluates both
sides, so the guards that keep the unused side finite are kept as they
are in the original."""

import math

import torch

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch.ops import bessel

NE = 11
THETAE_MIN = 1e-10
NUC_MIN = 1.0


def bnu(T, nu):
    """Planck function with a Rayleigh-Jeans low-frequency branch
    (polsynchemis.f90:1014-1032)."""
    x = pc.h * nu / (pc.k * T)
    rj = 2.0 * nu * nu * pc.k * T / pc.c2
    planck = 2.0 * pc.h * nu ** 3 / pc.c2 / torch.expm1(x.clamp_min(1e-6))
    return torch.where(x < 1e-6, rj, planck).clamp_min(2.2e-16)


def _iix(x):
    """Mahadevan+1996 thermal I(x) fit (polsynchemis.f90:854-861)."""
    x3 = x ** (1.0 / 3.0)
    return 2.5651 * (1.0 + 1.92 / x3 + 0.9977 / x3 ** 2) \
        * torch.exp(-1.8899 * x3)


def _iqx(x):
    """Huang+2009 I_Q(x) fit (polsynchemis.f90:831-840)."""
    x3 = x ** (1.0 / 3.0)
    return 2.5651 * (1.0 + 0.93193 / x3 + 0.499873 / x3 ** 2) \
        * torch.exp(-1.8899 * x3)


def _ivx(x):
    """Huang+2009 I_V(x) fit (polsynchemis.f90:842-852)."""
    x3 = x ** (1.0 / 3.0)
    return (1.81384 / x + 3.42319 / x3 ** 2 + 0.0292545 / x.sqrt()
            + 2.03773 / x3) * torch.exp(-1.8899 * x3)


def _jffunc(x):
    """Shcherbakov 2008 F(X) with the Jones & Hardee low-frequency term
    (polsynchemis.f90:802-812)."""
    extra = (0.011 * torch.exp(-x / 47.2)
             - 2.0 ** (-1.0 / 3.0) / 3.0 ** (23.0 / 6.0) * math.pi * 1e4
             * (x + 1e-16) ** (-8.0 / 3.0)) \
        * (0.5 + 0.5 * torch.tanh((torch.log(x + 1e-37) - math.log(120.0))
                                  / 0.1))
    return (2.011 * torch.exp(-x ** 1.035 / 4.7)
            - torch.cos(x / 2.0) * torch.exp(-x ** 1.2 / 2.73)
            - 0.011 * torch.exp(-x / 47.2) + extra)


def _shgmfunc(x):
    """Modified Shcherbakov G(X) fit (polsynchemis.f90:814-821)."""
    return 0.43793091 * torch.log(1.0 + 0.00185777 * x ** 1.50316886)


def _stack(*coefs):
    return torch.stack(torch.broadcast_tensors(*coefs), dim=-1)


def polsynchth(nu, n, b, T, theta):
    """Thermal polarized synchrotron coefficients (Huang+2009 emission,
    Kirchhoff absorption, Shcherbakov 2008 Faraday fits;
    polsynchemis.f90:700-863).

    nu [Hz], n [cm^-3], b [G], T [K], theta = B-k pitch angle [rad]
    (tensors).  Returns (..., 11)."""
    thetae = pc.k * T / (pc.m * pc.c2) + THETAE_MIN
    sth = torch.sin(theta)
    nuc = 3.0 * pc.e * b * sth / (4.0 * math.pi * pc.m * pc.c) \
        * thetae ** 2 + NUC_MIN
    xm = nu / nuc
    pref = pc.e ** 2 / pc.c / math.sqrt(3.0) / 2.0 * n / thetae ** 2 * nu
    ji = pref * _iix(xm)
    jq = pref * _iqx(xm)
    jv = (4.0 * pc.e ** 2 / pc.c / 3.0 / math.sqrt(3.0) / torch.tan(theta)
          * n / 2.0 / thetae ** 3 * nu * _ivx(xm))
    ju = torch.zeros_like(ji)
    bb_ = bnu(T, nu)
    ai, aq, au, av = ji / bb_, jq / bb_, ju / bb_, jv / bb_

    # Faraday rotation / conversion (Shcherbakov 2008 fits)
    wp2 = 4.0 * math.pi * n * pc.e ** 2 / pc.m
    omega0 = pc.e * b / (pc.m * pc.c)
    xarg = thetae * torch.sqrt(math.sqrt(2.0) * sth
                               * (1e3 * omega0 / (2.0 * math.pi * nu)))
    # clamp 1/thetae: for cold points K_n underflows and the ratios become
    # 0/0; the thetae <= 1e-2 branch replaces them anyway
    it = (1.0 / thetae).clamp_max(150.0)
    k2 = bessel.besselk2(it)
    krat = bessel.besselk1(it) / k2
    k0rat = bessel.besselk0(it) / k2
    gstep = 0.5 + 0.5 * torch.tanh((thetae - 1.0) / 0.05)
    rel = thetae > 1e-2
    # dimensionless ratios first, as the original forms them
    otn = omega0 / (2.0 * math.pi * nu)
    wptn = wp2 / (2.0 * math.pi * nu) ** 2
    eps11m22 = _jffunc(xarg) * wptn * otn ** 2 \
        * torch.where(rel, krat + 6.0 * thetae, 1.0 + 6.0 * thetae) \
        * sth ** 2
    eps12 = wptn * otn * torch.cos(theta) \
        * torch.where(rel, k0rat - gstep * _shgmfunc(xarg) / k2, 1.0)
    rhov = 2.0 * math.pi * nu / pc.c * eps12
    rhoq = 2.0 * math.pi * nu / 2.0 / pc.c * eps11m22
    rhou = torch.zeros_like(rhoq)
    return _stack(ji, jq, ju, jv, ai, aq, au, av, rhoq, rhou, rhov)


def synchemis(nu, n, b, T):
    """Angle-averaged thermal synchrotron (Mahadevan+1996), unpolarized
    (polsynchemis.f90:865-904)."""
    thetae = pc.k * T / (pc.m * pc.c2) + THETAE_MIN
    nucrit = 3.0 * pc.e * b / (4.0 * math.pi * pc.m * pc.c) * thetae ** 2 \
        + NUC_MIN
    xm = nu / nucrit
    x6 = xm ** (1.0 / 6.0)
    ipx = 4.0505 / x6 * (1.0 + 0.40 / x6 ** 1.5 + 0.5316 / x6 ** 3) \
        * torch.exp(-1.8899 * x6 ** 2)
    jn = 4.43e-30 / 2.0 * nu * n * ipx / thetae ** 2
    an = torch.where(jn.abs() > 0.0, jn / bnu(T, nu), 0.0)
    z = torch.zeros_like(jn)
    return _stack(jn, z, z, z, an, z, z, z, z, z, z)


def synchemisnoabs(nu, n, b, T):
    """synchemis with absorption zeroed (polsynchemis.f90:906-913)."""
    e = synchemis(nu, n, b, T)
    return torch.cat([e[..., :4], torch.zeros_like(e[..., 4:])], dim=-1)


def sympolemisth(nu, n, b, T, theta):
    """Pandya+2016 fits to thermal polarized synchrotron
    (polsynchemis.f90:915-1012); Faraday coefficients as in polsynchth."""
    thetae = pc.k * T / (pc.m * pc.c2) + THETAE_MIN
    sth = torch.sin(theta)
    nuc = pc.e * b / (pc.m * pc.c * 2.0 * math.pi) + NUC_MIN
    x = nu / (2.0 / 9.0 * nuc * thetae ** 2 * sth)
    sx = x.sqrt()
    x16 = x ** (1.0 / 6.0)
    te2425 = thetae ** (24.0 / 25.0)
    jis = math.sqrt(2.0) * math.pi / 27.0 * sth \
        * (sx + 2.0 ** (11.0 / 12.0) * x16) ** 2
    jqs = -math.sqrt(2.0) * math.pi / 27.0 * sth \
        * (sx + (7.0 * te2425 + 35.0) / (10.0 * te2425 + 75.0)
           * 2.0 ** (11.0 / 12.0) * x16) ** 2
    jvs = -(37.0 - 87.0 * torch.sin(theta - 28.0 / 25.0)) / 100.0 \
        / (thetae + 1.0) \
        * (1.0 + (thetae ** 0.6 / 25.0 + 0.7) * x ** (9.0 / 25.0)) \
        ** (5.0 / 3.0)
    fac = n * pc.e ** 2 / pc.c * nuc * torch.exp(-(x ** (1.0 / 3.0)))
    ji = fac * jis
    jq = -fac * jqs
    jv = -fac * jvs
    bb_ = bnu(T, nu)
    ai, aq, av = ji / bb_, jq / bb_, jv / bb_
    wp2 = 4.0 * math.pi * n * pc.e ** 2 / pc.m
    omega0 = pc.e * b / (pc.m * pc.c)
    xarg = thetae * torch.sqrt(math.sqrt(2.0) * sth
                               * (1e3 * omega0 / (2.0 * math.pi * nu)))
    it = (1.0 / thetae).clamp_max(150.0)
    k2 = bessel.besselk2(it)
    gstep = 0.5 + 0.5 * torch.tanh((thetae - 1.0) / 0.05)
    rel = thetae > 1e-2
    eps11m22 = _jffunc(xarg) * wp2 * omega0 ** 2 \
        / (2.0 * math.pi * nu) ** 4 \
        * torch.where(rel, bessel.besselk1(it) / k2 + 6.0 * thetae,
                      1.0 + 6.0 * thetae) * sth ** 2
    eps12 = wp2 * omega0 / (2.0 * math.pi * nu) ** 3 * torch.cos(theta) \
        * torch.where(rel, (bessel.besselk0(it) - gstep * _shgmfunc(xarg))
                      / k2, 1.0)
    rhov = 2.0 * math.pi * nu / pc.c * eps12
    rhoq = 2.0 * math.pi * nu / 2.0 / pc.c * eps11m22
    z = torch.zeros_like(ji)
    return _stack(ji, jq, z, jv, ai, aq, z, av, rhoq, z, rhov)
