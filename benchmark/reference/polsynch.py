"""Thermal polarized synchrotron emission, absorption and Faraday
coefficients (reference polsynchemis.f90: polsynchth :700-863, bnu
:1014-1032).

Every function returns the 11-coefficient layout

    [j_I, j_Q, j_U, j_V, a_I, a_Q, a_U, a_V, rho_Q, rho_U, rho_V]

and is elementwise over broadcast tensors.  torch.where evaluates both
sides, so the guards that keep the unused side finite are kept.
"""

import math

import torch

from . import constants as pc
from . import bessel

NE = 11
THETAE_MIN = 1e-10
NUC_MIN = 1.0


def bnu(T, nu):
    """Planck function with a Rayleigh-Jeans low-frequency branch
    (polsynchemis.f90:1014-1032)."""
    # T = 0 (a sample off the grid) gives the floor; it takes T = 1 as its
    # operand so that no infinite derivative reaches the backward pass
    cold = T == 0
    T = torch.where(cold, 1.0, T)
    x = pc.h * nu / (pc.k * T)
    if nu.dtype == torch.float32:
        # nu / c first: nu^3 leaves float32's range above 7e12 Hz
        nuc = nu / pc.c
        rj = 2.0 * nuc * nuc * pc.k * T
        planck = 2.0 * pc.h / pc.c * nuc * nu * nu \
            / torch.expm1(x.clamp_min(1e-6))
    else:
        rj = 2.0 * nu * nu * pc.k * T / pc.c2
        planck = 2.0 * pc.h * nu ** 3 / pc.c2 \
            / torch.expm1(x.clamp_min(1e-6))
    return torch.where(cold, 2.2e-16,
                       torch.where(x < 1e-6, rj, planck).clamp_min(2.2e-16))


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


def _xarg(thetae, sth, omega0, nu):
    """The Shcherbakov fits' argument thetae sqrt(sqrt 2 sin(theta) 1e3
    omega0 / (2 pi nu)); where the root's argument is 0 (B = 0) it is 0
    with a finite (zero) derivative."""
    arg = math.sqrt(2.0) * sth * (1e3 * omega0 / (2.0 * math.pi * nu))
    zero = arg == 0.0
    return thetae * torch.where(zero, 0.0,
                                torch.where(zero, 1.0, arg).sqrt())


def _stack(*coefs):
    return torch.stack(torch.broadcast_tensors(*coefs), dim=-1)


def polsynchth(nu, n, b, T, theta):
    """Thermal polarized synchrotron coefficients (Huang+2009 emission,
    Kirchhoff absorption, Shcherbakov 2008 Faraday fits;
    polsynchemis.f90:700-863).

    nu [Hz], n [cm^-3], b [G], T [K], theta = B-k pitch angle [rad]
    (tensors).  Returns (..., 11)."""
    thetae = pc.k * T / (pc.m * pc.c2) + THETAE_MIN
    # |sin|: float32's pi lies above pi, and its sine is -8.7e-8
    sth = torch.sin(theta).abs()
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
    xarg = _xarg(thetae, sth, omega0, nu)
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


