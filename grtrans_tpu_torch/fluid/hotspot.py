"""Time-dependent orbiting hotspots: HOTSPOT (Broderick & Loeb 2006
covariant Gaussian spot) and SCHNITTMAN (Schnittman & Bertschinger 2004
cartesian Gaussian spot).  Port of grtrans_tpu/fluid/hotspot.py
(reference fluid_model_hotspot.f90 :62-170 with its toroidal, poloidal
and vertical field options and the plunging interior,
fluid_model_hotspot_schnittman.f90 :58-93, the coordinate shifts of
fluid.f90:1261-1275 (phi -> -pi/2 - phi, t -> -t) and
convert_fluidvars_hotspot / schnittman, fluid.f90:1174-1186).

Both are `timedep`: `vals(x, k, a, time=t)` samples the spot at frame
time t [M]."""

import math
from dataclasses import dataclass, field
from typing import Any

import torch

from grtrans_tpu_torch.fluid import base
from grtrans_tpu_torch.fluid.analytic import _check_device, keplerian_omega
from grtrans_tpu_torch.fluid.base import EmisInputs, FluidVars
from grtrans_tpu_torch.geometry import fourvector as fvec
from grtrans_tpu_torch.geometry import kerr


def _keplerian_interior_u(r, th, a, omega, g):
    """Four-velocity of both spots: rigid rotation at the spot's omega
    where that is timelike, else the disk flow, Keplerian outside the
    ISCO and plunging inside (fluid_model_hotspot.f90:121-135)."""
    omt = keplerian_omega(r, th, a)
    den_spot = g[..., 0] + 2.0 * g[..., 3] * omega + g[..., 9] * omega ** 2
    ok = den_spot < 0.0
    ut_spot = torch.where(
        ok, (-1.0 / torch.where(ok, den_spot, -1.0)).sqrt(), 1.0)
    z = torch.zeros_like(r)
    ut_kep = kerr.calc_u0(g, z, z, omt)
    ut = torch.where(ok, ut_spot, ut_kep)
    uph = torch.where(ok, omega * ut_spot, omt * ut_kep)
    return torch.stack([ut, z, z, uph], dim=-1)


def _toroidal_spot_b(g, u, bmag):
    """BL06 toroidal field (fluid_model_hotspot.f90:141-149)."""
    gtt, gtp, gpp = g[..., 0], g[..., 3], g[..., 9]
    ut, uph = u[..., 0], u[..., 3]
    gfac = 1.0 / (
        (gpp * gtt - gtp * gtp)
        * (gpp * uph * uph + ut * (2.0 * gtp * uph + gtt * ut))
    ).clamp_min(1e-37).sqrt()
    b0 = bmag * gfac * (gpp * uph + gtp * ut).abs()
    b3 = -bmag * torch.sign(gpp * uph + gtp * ut) * (ut * gtt + gtp * uph) \
        * gfac
    z = torch.zeros_like(b0)
    return torch.stack([b0, z, z, b3], dim=-1)


@base.register("HOTSPOT")
@dataclass
class HotSpot:
    rspot: float = 1.5
    r0spot: float = 6.0
    n0spot: float = 1e4
    bl06: int = 1        # field: |1| toroidal, 0 poloidal, |2| vertical
    tspot: float = 0.0   # advanced between frames
    device: Any = field(kw_only=True)

    timedep = True

    def advance(self, dt):
        self.tspot = self.tspot - dt
        return self

    def vals(self, x, k, a, time=0.0):
        _check_device(self, x)
        tspot = self.tspot - time
        # the reference shifts the coordinates before it samples
        # (fluid.f90:1268-1269)
        t = -x[..., 0]
        r = x[..., 1]
        th = x[..., 2]
        phi = -math.pi / 2.0 - x[..., 3]
        g = kerr.metric_cov(r, th, a)
        omega = 1.0 / (self.r0spot ** 1.5 + a)
        # rotate to the spot's frame at phi = 0
        # (fluid_model_hotspot.f90:95-98)
        dphi = phi - (tspot + t) * omega
        dphi = torch.atan2(dphi.sin(), dphi.cos())
        # covariant distance to the spot's center (BL06): the spatial
        # separation plus a time-dilation term along the spot's velocity
        xs_r, xs_th = self.r0spot, math.pi / 2.0
        like = dict(dtype=r.dtype, device=r.device)
        gs = kerr.metric_cov(torch.tensor(xs_r, **like),
                             torch.tensor(xs_th, **like), a)
        den_s = gs[..., 0] + 2.0 * gs[..., 3] * omega + gs[..., 9] * omega ** 2
        us_t = (-1.0 / den_s).sqrt()
        uspot = torch.stack([us_t, 0.0 * us_t, 0.0 * us_t, omega * us_t],
                            dim=-1)
        z = torch.zeros_like(r)
        dx = torch.stack([z, xs_r - r, xs_th - th, 0.0 - dphi], dim=-1)
        dnorm = fvec.dot(gs, dx, dx) + fvec.dot(gs, dx, uspot) ** 2
        # beyond 4 sigma the spot is cut: n = 0 and a unit field there
        arg = dnorm / 2.0 / self.rspot ** 2
        far = arg >= 8.0
        n = torch.where(far, 0.0,
                        self.n0spot * torch.exp(-torch.where(far, 0.0, arg)))
        u = _keplerian_interior_u(r, th, a, omega, g)
        bmag = torch.sqrt(0.1 * 8.0 * math.pi * n * 100.0 * 1.67e-24 / 2.0
                          * 9e20 / r)
        bmag = torch.where(far, 1.0, bmag)
        if abs(self.bl06) == 1:
            b = _toroidal_spot_b(g, u, bmag)
        elif self.bl06 == 0:
            b = torch.stack([z, z, bmag / g[..., 7].sqrt(), z], dim=-1)
        elif abs(self.bl06) == 2:
            b = torch.stack([z, -bmag / g[..., 4].sqrt() * th.cos(),
                             bmag / g[..., 7].sqrt() * th.sin(), z], dim=-1)
        else:
            b = kerr.calc_polvec(r, th.cos(), k, a, math.pi / 2.0)
        bm = kerr.safe_sqrt(fvec.dot(g, b, b))
        return FluidVars(rho=n, p=z, bmag=bm, u=u, b=b, rho2=n)

    def convert(self, fv, sp):
        """ncgs = n, bcgs = bmag, ncgsnth = n (fluid.f90:1174-1180)."""
        return EmisInputs(ncgs=fv.rho, tcgs=torch.zeros_like(fv.rho),
                          bcgs=fv.bmag, ncgsnth=fv.rho)


@base.register("SCHNITTMAN")
@dataclass
class SchnittmanHotspot:
    rspot: float = 1.5
    r0spot: float = 6.0
    n0spot: float = 1e4
    tspot: float = 0.0
    device: Any = field(kw_only=True)

    timedep = True

    def advance(self, dt):
        self.tspot = self.tspot + dt
        return self

    def vals(self, x, k, a, time=0.0):
        _check_device(self, x)
        tspot = self.tspot + time
        t = -x[..., 0]
        r = x[..., 1]
        th = x[..., 2]
        phi = -math.pi / 2.0 - x[..., 3]
        omega = 1.0 / (self.r0spot ** 1.5 + a)
        xs = r * th.sin() * phi.cos()
        ys = r * th.sin() * phi.sin()
        zs = r * th.cos()
        phispot = omega * (t + tspot)
        d2 = (xs - self.r0spot * phispot.cos()) ** 2 \
            + (ys - self.r0spot * phispot.sin()) ** 2 + zs ** 2
        n = torch.where(d2 < 16.0 * self.rspot ** 2,
                        torch.exp(-d2 / 2.0 / self.rspot ** 2), 0.0)
        g = kerr.metric_cov(r, th, a)
        u = _keplerian_interior_u(r, th, a, omega, g)
        b = _toroidal_spot_b(g, u, torch.ones_like(r))
        bm = kerr.safe_sqrt(fvec.dot(g, b, b))
        z = torch.zeros_like(r)
        return FluidVars(rho=n, p=z, bmag=bm, u=u, b=b, rho2=n)

    def convert(self, fv, sp):
        """ncgs = n, bcgs = 1 (fluid.f90:1182-1186)."""
        return EmisInputs(ncgs=fv.rho, tcgs=torch.zeros_like(fv.rho),
                          bcgs=torch.ones_like(fv.rho), ncgsnth=fv.rho)
