"""THICKDISK: McKinney "thickdisk" fieldline-file GRMHD model (jetcoords6
/ defcoord=1401 simulations).

Port of grtrans_tpu/fluid/thickdisk.py (reference
fluid_model_thickdisk.f90 + fluid.f90 convert_fluidvars_thickdisk
:925-940):

 * Fieldline dumps are binary: one ASCII header line (30 numbers: tcur,
   nx1, nx2, nx3, startx1-3, dx1-3, _, gam, asim, r0, rin, rout, h, dt,
   defcoord, ..., dlen last; read_thickdisk_data_header :579-627) followed
   by float32 data of dlen values per zone, x1 fastest
   (read_thickdisk_fieldline_file :815-975): 1-based cols rho@1, internal
   energy@2, u^t@5, transport velocity v^i = u^i/u^t @6-8, B^i(MKS)@9-11.
 * Coordinates: r = exp(x1 + (x1-xbr)^10 for x1 > xbr) with xbr = ln 500
   (rout > 1e3) or ln 1e5 (calcrmks :79-93); theta(x2, r) is the
   hard-coded jetcoords6 blend calcthmks6 (:143-175); phi = 2 pi x3.
 * MKS -> KS uses central-difference dtheta/dr and dtheta/dx2 and
   dr/dx1 (umks2uks :110-141), then KS -> BL; b^t is recovered from b.u.
 * "jonfix" floor repair (:950-967): where b^2/rho exceeds a radius-
   interpolated threshold, rho = p = 1e-18.
 * Sampling (thickdisk_vals :344-569): trilinear with the theta fraction
   measured in physical theta at the sample's own radius, periodic phi,
   nearest neighbour in r inside the innermost zone; r -> x1 and
   theta -> x2 by 60 bisections each.  One quad_gather_rows launch of 4
   phi-pair-packed rows a sample.
 * Units: scale_sim_units with mdot_code = 0.0013, Moscibrodzka R(beta)
   with rlow = 1/mu - 1, rhigh = gmin (1/mu - 1), T_e = T / (1 + R), plus
   nonthermale_b2 (no sigma cut on this path in the reference).
"""

import math

import numpy as np
import torch
from torch import nn

from grtrans_tpu_torch.fluid import base
from grtrans_tpu_torch.fluid.base import EmisInputs, FluidVars
from grtrans_tpu_torch.fluid.grmhd3d import (FIELDS, phi_pair_pack,
                                             trilinear_rows)
from grtrans_tpu_torch.fluid.harm import f64, four_vectors, lnrf_storage
from grtrans_tpu_torch.geometry import fourvector as fv
from grtrans_tpu_torch.geometry import kerr
from grtrans_tpu_torch.ops.intcast import to_int32, trunc_clip


def calcrmks(x1, xbr, npow2=10.0):
    """x1 -> r (calcrmks :79-93; no R0 offset, npow2 = 10)."""
    xi = torch.where(x1 > xbr, x1 + (x1 - xbr).clamp_min(0.0) ** npow2, x1)
    return xi.exp()


def bisect(func, target, lo, hi, iters):
    """Invert the increasing map func on [lo, hi] by `iters` bisections,
    batched over the tensor target."""
    lo = torch.full_like(target, lo)
    hi = torch.full_like(target, hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        big = func(mid) > target
        hi = torch.where(big, mid, hi)
        lo = torch.where(big, lo, mid)
    return 0.5 * (lo + hi)


def x1_of_r(r, xbr, lo=-2.0, hi=12.0, iters=60):
    return bisect(lambda x1: calcrmks(x1, xbr), r, lo, hi, iters)


def calcthmks6(x2, r):
    """jetcoords6 theta(x2 in [0, 1], r) (calcthmks6 :143-175; parameters
    of defcoord=1401)."""
    pi = math.pi
    r1jet, r0jet, rsjet, qjet = 2.8, 15.0, 40.0, 1.3
    rs, r0 = 40.0, 20.0
    r0jet3, rsjet3, h0 = 20.0, 0.0, 0.3
    njet = 1.0
    ntheta, htheta = 5.0, 0.15
    rsjet2, r0jet2 = 5.0, 2.0
    myh1 = h0 + ((r - rsjet3) / r0jet3) ** njet
    th2 = 0.5 * pi * (1.0 + torch.arctan(myh1 * (x2 - 0.5))
                      / torch.arctan(myh1 * 0.5))
    myh2 = 2.0 - qjet * (r / r1jet) ** (
        -njet * (0.5 + 1.0 / pi * torch.arctan(r / r0jet - rsjet / r0jet)))
    th0 = pi * x2 + 0.5 * (1.0 - myh2) * torch.sin(2.0 * pi * x2)
    switch0 = 0.5 + 1.0 / pi * torch.arctan((r - rs) / r0)
    switch2 = 0.5 - 1.0 / pi * torch.arctan((r - rs) / r0)
    theta1 = th0 * switch2 + th2 * switch0
    theta2 = pi * 0.5 * (htheta * (2 * x2 - 1)
                         + (1 - htheta) * (2 * x2 - 1) ** ntheta + 1.0)
    arctan2 = 0.5 + 1.0 / pi * torch.arctan((r - rsjet2) / r0jet2)
    return theta2 + arctan2 * (theta1 - theta2)


def x2_of_th(th, r, thfunc=calcthmks6, iters=60):
    """Invert theta(x2, r) by bisection on x2 in [0, 1] (transformbl2mks
    :329-342)."""
    return bisect(lambda x2: thfunc(x2, r), th, 0.0, 1.0, iters)


def umks2ubl(um, x1, x2, xbr, asim, thfunc=calcthmks6):
    """MKS -> KS (numerical theta derivatives, umks2uks :110-141) -> BL;
    phi scales by 2 pi."""
    r = calcrmks(x1, xbr)
    dx1 = 1e-4 * x1.abs().clamp_min(1e-2)
    dx2 = 1e-6 * x2.abs().clamp_min(1e-2)
    dr = 1e-4 * r
    drdx1 = (calcrmks(x1 + 0.5 * dx1, xbr)
             - calcrmks(x1 - 0.5 * dx1, xbr)) / dx1
    dthdr = (thfunc(x2, r + 0.5 * dr) - thfunc(x2, r - 0.5 * dr)) / dr
    dthdx2 = (thfunc(x2 + 0.5 * dx2, r) - thfunc(x2 - 0.5 * dx2, r)) / dx2
    ur = drdx1 * um[..., 1]
    uks = torch.stack([um[..., 0], ur, um[..., 2] * dthdx2 + ur * dthdr,
                       um[..., 3] * 2.0 * math.pi], dim=-1)
    return kerr.uks2ubl(uks, r, asim)


def read_thickdisk_fieldline(dfile, hfile=None):
    """Binary fieldline dump -> dict (read_thickdisk_fieldline_file
    :815-975, binary branch)."""
    with open(dfile, "rb") as f:
        raw = f.read()
    nl = raw.index(b"\n")
    if hfile:
        with open(hfile) as f:
            hdr_line = f.readline()
    else:
        hdr_line = raw[:nl].decode()
    hv = [float(v) for v in hdr_line.split()]
    h = dict(tcur=hv[0], nx1=int(hv[1]), nx2=int(hv[2]), nx3=int(hv[3]),
             startx1=hv[4], startx2=hv[5], startx3=hv[6], dx1=hv[7],
             dx2=hv[8], dx3=hv[9], gam=hv[11], asim=hv[12], r0=hv[13],
             rin=hv[14], rout=hv[15], h=hv[16], dt=hv[17],
             defcoord=hv[18], dlen=int(hv[-1]))
    n = h["nx1"] * h["nx2"] * h["nx3"]
    dlen = h["dlen"]
    data = np.frombuffer(raw[nl + 1:nl + 1 + 4 * dlen * n],
                         np.float32).reshape(n, dlen).astype(np.float64)
    # 1-based rhopos=1, ppos=2, vpos=5, bpos=9 -> 0-based below
    u0 = data[:, 4]
    u_mks = np.stack([u0, data[:, 5] * u0, data[:, 6] * u0,
                      data[:, 7] * u0], axis=-1)
    b_mks = np.stack([np.zeros(n), data[:, 8], data[:, 9], data[:, 10]],
                     axis=-1)
    return dict(h=h, rho=data[:, 0], uint=data[:, 1], u=u_mks, b=b_mks)


@base.register("THICKDISK")
class ThickDisk(nn.Module):
    """fargs: dfile (and hfile), or dump= the dict of
    `read_thickdisk_fieldline`; jonfix (1: repair the floors); mdot_code;
    nt, see base.one_snapshot."""

    thfunc = staticmethod(calcthmks6)

    def __init__(self, dfile="", hfile=None, jonfix=1, dump=None,
                 mdot_code=0.0013, nt=1, *, device):
        super().__init__()
        base.one_snapshot(nt)
        d = dump if dump is not None else \
            read_thickdisk_fieldline(dfile, hfile)
        h = d["h"]
        self.mdot_code = mdot_code
        self.asim = float(h["asim"])
        self.gam = float(h["gam"])
        nx1, nx2, nx3 = int(h["nx1"]), int(h["nx2"]), int(h["nx3"])
        self.xbr = float(np.log(500.0) if h["rout"] > 1e3 else np.log(1e5))
        # cell-centred uniform MKS grids (x1 fastest in the flat arrays,
        # thickdisk_vals :384-390)
        uniqx1 = f64(h["startx1"] + h["dx1"] * (0.5 + np.arange(nx1)))
        uniqx2 = f64(h["startx2"] + h["dx2"] * (0.5 + np.arange(nx2)))
        uniqx3 = f64(h["startx3"] + h["dx3"] * (0.5 + np.arange(nx3)))
        X2, X1 = np.meshgrid(uniqx2.numpy(), uniqx1.numpy(), indexing="ij")
        x1f = f64(np.tile(X1.ravel(), nx3))
        x2f = f64(np.tile(X2.ravel(), nx3))
        r = calcrmks(x1f, self.xbr)
        th = self.thfunc(x2f, r)
        rho = f64(d["rho"])
        p = f64(d["uint"]) * (self.gam - 1.0)
        u_bl = umks2ubl(f64(d["u"]), x1f, x2f, self.xbr, self.asim,
                        self.thfunc)
        # b^t from b.u in BL, then the standard recovery (the reference does
        # this in KS, :930-940; the contraction is frame-invariant)
        g_cov = kerr.metric_cov(r, th, self.asim)
        bsp = umks2ubl(f64(d["b"]), x1f, x2f, self.xbr, self.asim,
                       self.thfunc)
        b0 = fv.dot(g_cov, bsp, u_bl)
        b_bl = torch.stack(
            [b0] + [(bsp[..., i] + b0 * u_bl[..., i]) / u_bl[..., 0]
                    for i in (1, 2, 3)], dim=-1)
        if jonfix == 1:
            bsq = fv.dot(g_cov, b_bl, b_bl)
            rinterp = ((r - 9.0) / (0.0 - 9.0)).clamp(0.0, 1.0)
            cond = rinterp * 30.0 + (1 - rinterp) * 10.0
            sig = bsq / rho.clamp_min(1e-37)
            bad = (sig > 30.0) | (sig >= cond)
            rho = torch.where(bad, 1e-18, rho)
            p = torch.where(bad, 1e-18, p)
        cols = dict(lnrf_storage(u_bl, b_bl, r, th, self.asim), rho=rho, p=p)
        self._set_grid(device, cols, uniqx1, uniqx2, uniqx3)

    def _set_grid(self, device, cols, uniqx1, uniqx2, uniqx3):
        """Place the coordinate arrays and the phi-pair-packed table of the
        (nx3, nx2, nx1) fields (x1 fastest) on `device`.  Shared with MB09
        (same layout)."""
        self.nx1, self.nx2, self.nx3 = nx1, nx2, nx3 = (
            uniqx1.shape[0], uniqx2.shape[0], uniqx3.shape[0])
        st = torch.stack([cols[k].reshape(nx3, nx2, nx1) for k in FIELDS],
                         dim=-1)
        for name, t in (("uniqx1", uniqx1), ("uniqx2", uniqx2),
                        ("uniqx3", uniqx3),
                        ("uniqr", calcrmks(uniqx1, self.xbr)),
                        ("fpair", phi_pair_pack(st, 0))):
            self.register_buffer(name, t.contiguous().to(device))

    def vals(self, x, k, a):
        nx1, nx2, nx3 = self.nx1, self.nx2, self.nx3
        r = x[..., 1]
        th = x[..., 2]
        zphi = torch.remainder(kerr.bl2ks_phi(r, x[..., 3], a), 2.0 * math.pi)
        zphi = torch.where(zphi < 0.0, zphi + 2.0 * math.pi, zphi)
        x1 = x1_of_r(r, self.xbr)
        x2 = x2_of_th(th, r, self.thfunc)
        u1a, u1b = self.uniqx1[0], self.uniqx1[-1]
        u2a, u2b = self.uniqx2[0], self.uniqx2[-1]
        u3a = self.uniqx3[0]
        lx1 = trunc_clip((x1 - u1a) / (u1b - u1a) * (nx1 - 1), nx1 - 2)
        lx2 = trunc_clip((x2 - u2a) / (u2b - u2a) * (nx2 - 1), nx2 - 2)
        dph = 2.0 * math.pi * (self.uniqx3[1] - self.uniqx3[0]) \
            if nx3 > 1 else 2.0 * math.pi
        ph0 = 2.0 * math.pi * u3a
        lx3raw = to_int32(torch.floor((zphi - ph0) / dph))
        lx3 = torch.remainder(lx3raw, nx3)
        pd = ((zphi - (ph0 + lx3raw * dph)) / dph).clamp(0.0, 1.0)

        i1, i2 = lx1.long(), lx2.long()
        r_lo = self.uniqr[i1]
        rd = (r - r_lo) / (self.uniqr[i1 + 1] - r_lo)
        thl = self.thfunc(self.uniqx2[i2], r)
        thu = self.thfunc(self.uniqx2[i2 + 1], r)
        td = ((th - thl) / (thu - thl)).abs().clamp(0.0, 1.0)
        rd = torch.where(r_lo <= kerr.horizon(a), 1.0, rd.clamp(0.0, 1.0))
        outside = x1 <= u1a

        base_ = (lx3 * nx2 + lx2) * nx1 + lx1
        vals = trilinear_rows(
            self.fpair, [base_, base_ + nx1, base_ + 1, base_ + nx1 + 1],
            [(1 - rd) * (1 - td), (1 - rd) * td, rd * (1 - td), rd * td],
            pd, len(FIELDS))
        col = dict(zip(FIELDS, vals.unbind(-1)))
        rho = torch.where(outside, 0.0, col["rho"])
        p = torch.where(outside, 1e-18, col["p"])
        u, b, bmag = four_vectors(col, outside, r, th, a)
        return FluidVars(rho=rho, p=p, bmag=bmag, u=u, b=b, rho2=rho)

    def convert(self, fv_, sp):
        """convert_fluidvars_thickdisk (fluid.f90:925-940)."""
        ncgs, bcgs, tempcgs, rhocgs = base.scale_sim_units(
            sp.mbh, sp.mdot, self.mdot_code, fv_.rho, fv_.p, fv_.bmag)
        trat = base.monika_e(fv_.rho, fv_.p, fv_.bmag, 1.0 / sp.mu - 1.0,
                             sp.gmin * (1.0 / sp.mu - 1.0))
        tempcgs = tempcgs / (1.0 + trat)
        ncgsnth = base.nonthermale_b2(
            sp.jetalpha, max(sp.gmin, 1.0), sp.p1,
            fv_.bmag ** 2 / fv_.rho.clamp_min(1e-37), bcgs)
        return EmisInputs(ncgs=ncgs, tcgs=tempcgs, bcgs=bcgs,
                          ncgsnth=ncgsnth)
