"""Thermal bremsstrahlung (free-free) emissivities (reference emis.f90
brememisHEROIC :188-243, brememisGRay :244-293)."""

import math

import torch

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch.emis.framework import from_columns
from grtrans_tpu_torch.emis.polsynch import bnu


def brememis_heroic(nu, ne, T):
    """HEROIC-style e-i + e-e free-free absorption, emission by Kirchhoff
    (emis.f90:188-243)."""
    eps = 1e-32
    temp = T
    rho = ne * 1.67219e-24
    sqrtt = temp.sqrt()
    thetae = pc.k * temp / (pc.m * pc.c2)
    sqth = thetae.sqrt()
    tempfactor = 1.0 / (sqrtt + (1e5 / temp) ** 10) + eps
    arg = pc.h * nu / (pc.k * temp)
    fei = torch.where(
        thetae < 1.0, 1.016 * sqth * (1.0 + 1.781 * thetae ** 1.34),
        1.432 * thetae * (torch.log(1.123 * thetae + 0.48) + 1.5))
    fee = torch.where(
        thetae < 1.0,
        thetae * sqth * (1.0 + 1.1 * thetae
                         + thetae * thetae * (1.0 - 1.25 * sqth)),
        1.328 * thetae * (torch.log(1.123 * thetae) + 1.28))
    one_m_e = torch.where(arg < 1e-8, arg,
                          -torch.expm1(-arg.clamp_max(100.0)))
    anu = (1.10e61 / sqrtt) * rho * rho * fei * one_m_e * tempfactor \
        / nu ** 3 \
        + (1.14e51 / sqrtt / temp) * rho * rho * fee * one_m_e \
        * tempfactor / nu ** 2
    anu = torch.where(arg > 100.0, 0.0, anu)
    return from_columns({0: anu * bnu(temp, nu), 4: anu})


def brememis_gray(nu, ne, T):
    """GRay-formula free-free with a piecewise Gaunt factor
    (emis.f90:244-293)."""
    eps = 1e-32
    temin = 100.0
    Ry = 2.178741e-11
    x = pc.k * (T + temin) / Ry
    y = pc.h * nu / (pc.k * (T + temin))
    sx = x.sqrt()
    sy = y.sqrt()
    con1 = math.sqrt(3.0 / math.pi)
    con2 = math.log(4.0 / 1.7810724179)
    con4 = math.log(4.0 / (1.78109724179 ** 2.5))
    g_xy1 = torch.where(y > 1.0, con1 / sy,
                        con1 * (con2 - torch.log(y + eps)))
    gaunt = torch.where(
        x > 1.0, g_xy1,
        torch.where(x * y > 1.0, con2 / (sx * sy),
                    torch.where(y > sx, 1.0,
                                con1 * (con4 + torch.log(sx / (y + eps))))))
    gaunt = gaunt.clamp_min(eps)
    jnu = 6.38e-38 * ne * ne * gaunt \
        / ((T + temin).sqrt() * torch.exp(y.clamp_max(500.0)) + eps) \
        / (4.0 * math.pi)
    anu = torch.where(jnu.abs() > 0.0, jnu / bnu(T, nu), 0.0)
    return from_columns({0: jnu, 4: anu})
