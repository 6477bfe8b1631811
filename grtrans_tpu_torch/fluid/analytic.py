"""Analytic fluid models: THINDISK, POWERLAW, SARIAF, TOY.  Port of
grtrans_tpu/fluid/analytic.py (reference fluid_model_thindisk.f90,
fluid_model_powerlaw.f90, fluid_model_sariaf.f90, fluid_model_toy.f90 and
their get_*_fluidvars / convert_fluidvars_* in fluid.f90).

A model carries only numbers; `device` names where its samples live, and
`vals` refuses a bundle that lies elsewhere."""

import math
from dataclasses import dataclass, field
from typing import Any

import torch

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch.fluid import base
from grtrans_tpu_torch.fluid.base import EmisInputs, FluidVars
from grtrans_tpu_torch.geometry import kerr


def _u_from_3vel(g, vr, vth, omega):
    u0 = kerr.calc_u0(g, vr, vth, omega)
    return torch.stack([u0, vr * u0, vth * u0, omega * u0], dim=-1)


def _check_device(model, x):
    want = torch.device(model.device)
    if x.device.type != want.type or (
            want.index is not None and x.device.index != want.index):
        raise ValueError(f"{type(model).__name__} was made for "
                         f"{model.device}, the rays lie on {x.device}")


def keplerian_omega(r, th, a):
    """Angular velocity of the disk flow: Keplerian outside the ISCO, the
    plunging geodesic's inside, never below the frame dragging rate
    (fluid_model_thindisk.f90:66-80)."""
    rms = kerr.calc_rms(a)
    d = r * r - 2.0 * r + a * a
    lc = (rms * rms - 2.0 * a * math.sqrt(rms) + a * a) \
        / (rms ** 1.5 - 2.0 * math.sqrt(rms) + a)
    hc = (2.0 * r - a * lc) / d
    ar = (r * r + a * a) ** 2 - a * a * d * th.sin() ** 2
    om = 2.0 * a * r / ar
    return torch.where(r > rms,
                       torch.maximum(1.0 / (r ** 1.5 + a), om),
                       torch.maximum((lc + a * hc)
                                     / (r * r + 2.0 * r * (1.0 + hc)), om))


@base.register("THINDISK")
@dataclass
class ThinDisk:
    """Novikov-Thorne thin disk: T(r) from the Page-Thorne flux through
    krolikc, Keplerian rotation outside the ISCO
    (fluid_model_thindisk.f90:51-86, fluid.f90:586-620)."""
    a: float = 0.998
    mbh: float = 10.0
    mdot: float = 0.1      # in Eddington units
    rin: float = 0.0
    rout: float = 1e5
    npow: int = 3
    device: Any = field(kw_only=True)

    def vals(self, x, k, a):
        _check_device(self, x)
        r = x[..., 1]
        th = x[..., 2]
        rin = max(kerr.calc_rms(a), self.rin)
        b = 1.0 - 3.0 / r + 2.0 * a / r ** 1.5
        kc = kerr.krolikc(r, a)
        lbh = pc.lbh(self.mbh)
        mdotedd = pc.ledd(self.mbh) / pc.c2
        T0 = (3.0 / 8.0 / math.pi * pc.G * self.mbh * pc.msun * self.mdot
              * mdotedd / lbh ** 3 / pc.sigb) ** 0.25
        T = torch.where((r > rin) & (r < self.rout),
                        T0 * (kc / b / r ** 3).clamp_min(0.0) ** 0.25,
                        T0 / 1e5)
        g = kerr.metric_cov(r, th, a)
        z = torch.zeros_like(r)
        u = _u_from_3vel(g, z, z, keplerian_omega(r, th, a))
        # polarization normal: the disk-frame basis vector at psi = pi/2
        # (fluid.f90:612-613)
        bvec = kerr.calc_polvec(r, th.cos(), k, a, math.pi / 2.0)
        return FluidVars(rho=T, p=z, bmag=z, u=u, b=bvec, rho2=z)

    def convert(self, fv, sp):
        """tcgs = T, ncgs = 1 (fluid.f90:1190-1196)."""
        one = torch.ones_like(fv.rho)
        return EmisInputs(ncgs=one, tcgs=fv.rho, bcgs=one,
                          ncgsnth=torch.zeros_like(fv.rho))


@base.register("POWERLAW")
@dataclass
class PowerLaw:
    """Power-law n, T, B with r / theta windows and a toroidal field
    (fluid_model_powerlaw.f90, fluid.f90:1472-1557, :1597-1611)."""
    pnth: float = 0.0
    n0: float = 3e7
    t0: float = 6e10
    nnth0: float = 8e4
    beta: float = 10.0
    pn: float = 0.0
    pt: float = 0.0
    rin: float = 0.0
    rout: float = 1e8
    thin: float = -10.0
    thout: float = 10.0
    phiin: float = 0.0
    phiout: float = 1e4
    device: Any = field(kw_only=True)

    def vals(self, x, k, a):
        _check_device(self, x)
        r = x[..., 1]
        th = x[..., 2]
        mu = th.cos()
        rs = r / 2.0
        neth = self.n0 * rs ** (-self.pn)
        nenth = self.nnth0 * rs ** (-self.pnth)
        te = self.t0 * rs ** (-self.pt)
        omega = self.phiin / r
        win = (r <= self.rout) & (r >= self.rin) & (mu >= self.thin) \
            & (mu <= self.thout)
        neth = torch.where(win, neth, 0.0)
        nenth = torch.where(win, nenth, 0.0)
        bmag = torch.sqrt(8.0 * math.pi * neth * pc.mp * pc.c2
                          / 10.0 / 12.0 / self.beta)
        g = kerr.metric_cov(r, th, a)
        z = torch.zeros_like(r)
        u = _u_from_3vel(g, z, z, omega)
        bvec = base.toroidal_b(g, u, bmag)
        return FluidVars(rho=neth, p=te, bmag=bmag, u=u, b=bvec, rho2=nenth)

    def convert(self, fv, sp):
        trat = base.monika_e(fv.rho, fv.rho, fv.bmag, 1.0 / sp.mu - 1.0,
                             sp.gmin * (1.0 / sp.mu - 1.0))
        return EmisInputs(ncgs=fv.rho, tcgs=fv.p / (1.0 + trat),
                          bcgs=fv.bmag, ncgsnth=fv.rho2)


@base.register("SARIAF")
@dataclass
class Sariaf:
    """Semi-analytic RIAF (Broderick+2009 / Broderick & Loeb 2006):
    power-law n, T with a Gaussian vertical profile, equipartition-scaled
    B, Keplerian rotation outside the ISCO and plunging inside
    (fluid_model_sariaf.f90:70-134, fluid.f90:1329-1421, :1560-1585)."""
    n0: float = 4e7
    t0: float = 1.6e11
    nnth0: float = 8e4
    pnth: float = 2.9
    beta: float = 10.0
    bl06: int = 0
    device: Any = field(kw_only=True)

    def vals(self, x, k, a):
        _check_device(self, x)
        r = x[..., 1]
        th = x[..., 2]
        mu = th.cos()
        z = r * mu
        a2 = (r * r - z * z).clamp_min(1e-37).sqrt()
        rs = r / 2.0
        gauss = torch.exp(-0.5 * (z / a2) ** 2)
        if self.bl06 != 1:
            neth = self.n0 * rs ** (-1.1) * gauss
            nenth = self.nnth0 * rs ** (-self.pnth) * gauss
            te = self.t0 * rs ** (-0.84)
        else:
            neth = self.n0 * a2 ** (-1.1) * gauss
            nenth = self.nnth0 * a2 ** (-self.pnth) * gauss
            te = self.t0 * r ** (-0.84)
        bmag = torch.sqrt(8.0 * math.pi * neth * pc.mp * pc.c2
                          / rs / 12.0 / self.beta)
        omega = 1.0 / (r ** 1.5 + a)
        g = kerr.metric_cov(r, th, a)
        zz = torch.zeros_like(r)
        u_out = _u_from_3vel(g, zz, zz, omega)
        u_in = kerr.rms_vel(a, th, r)
        u = torch.where((r < kerr.calc_rms(a))[..., None], u_in, u_out)
        bvec = base.toroidal_b(g, u, bmag)
        return FluidVars(rho=neth, p=te, bmag=bmag, u=u, b=bvec, rho2=nenth)

    def convert(self, fv, sp):
        return EmisInputs(ncgs=fv.rho, tcgs=fv.p, bcgs=fv.bmag,
                          ncgsnth=fv.rho2)


@base.register("TOY")
@dataclass
class Toy:
    """Falling / rotating toy cloud (code-comparison paper eqs 1-2;
    fluid_model_toy.f90:37-55, fluid.f90:1423-1470)."""
    n0: float = 1.0
    h: float = 0.0
    l0: float = 1.0
    device: Any = field(kw_only=True)

    def vals(self, x, k, a):
        _check_device(self, x)
        r = x[..., 1]
        th = x[..., 2]
        mu = th.cos()
        q = 0.5
        rcyl = r * (1.0 - mu * mu).clamp_min(0.0).sqrt()
        l = self.l0 / (1.0 + rcyl) * rcyl ** (1.0 + q)
        zc = self.h * mu
        dist = (r / 10.0) ** 2 + zc ** 2
        n = torch.where(dist < 20.0, self.n0 * torch.exp(-dist / 2.0), 0.0)
        gcon = kerr.metric_con(r, th, a)
        g = kerr.metric_cov(r, th, a)
        ubar = torch.sqrt(-1.0 / (gcon[..., 0] + l * l * gcon[..., 9]
                                  - 2.0 * l * gcon[..., 3]))
        ut = gcon[..., 3] * l * ubar + gcon[..., 0] * (-ubar)
        uph = gcon[..., 3] * (-ubar) + gcon[..., 9] * l * ubar
        z = torch.zeros_like(r)
        u = torch.stack([ut, z, z, uph], dim=-1)
        bmag = torch.ones_like(r)
        bvec = base.toroidal_b(g, u, bmag)
        return FluidVars(rho=n, p=z, bmag=bmag, u=u, b=bvec, rho2=z)

    def convert(self, fv, sp):
        z = torch.zeros_like(fv.rho)
        return EmisInputs(ncgs=fv.rho, tcgs=z, bcgs=fv.bmag, ncgsnth=z)
