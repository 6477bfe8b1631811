"""Illinois iharm / ebhlight 3-D GRMHD snapshot model.

Port of grtrans_tpu/fluid/iharm.py (reference fluid_model_iharm.f90): raw
float32 stream dumps of 13 + eHEAT values per zone (read_iharm_data_file
:508-592: cols 1-3 = x1, x2, x3, 4 = rho, 5 = internal energy u, 6-9 =
u^mu MKS, 10-13 = b^mu MKS, 14 = electron entropy kel), ASCII header
(read_iharm_data_header :427-469: tcur nx1 nx2 nx3 a hslope gam mks_smooth
poly_xt poly_alpha startx1 metric eHEAT ...), the MKS(h) theta map
calcthmksh (:82-87) or the "funky" MMKS map calcthmmks (:108-119),
MKS/MMKS -> KS -> BL transforms (:560-650 + ummks2uks), trilinear sampling
shared with HARM3D, and the Illinois electron-temperature conversion
(fluid.f90:995-1026: T_e = 2 m_p u / (3 k rho (2 + R)) with Moscibrodzka
R(beta), or Ressler entropy electrons for gmin = -1).
"""

import math

import numpy as np
import torch

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch.fluid import base, grmhd3d
from grtrans_tpu_torch.fluid.base import EmisInputs
from grtrans_tpu_torch.fluid.harm import f64, lnrf_storage, x2_of_theta
from grtrans_tpu_torch.geometry import kerr


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def calcth_mksh(x2, h):
    """theta(x2) for standard MKS (calcthmksh, :82-87)."""
    xp = _xp(x2)
    return math.pi * x2 + (1.0 - h) / 2.0 * xp.sin(2.0 * math.pi * x2)


def calcth_mmks(x2, x1, h, mks_smooth, poly_xt, poly_alpha, startx1):
    """theta(x1, x2) for FMKS/MMKS (calcthmmks, :108-119); numpy arrays or
    tensors."""
    xp = _xp(x2)
    A, B, C = mks_smooth, poly_xt, poly_alpha
    D = math.pi / (2.0 + 2.0 / (B ** C * (1.0 + C)))
    thetag = math.pi * x2 + (1.0 - h) / 2.0 * xp.sin(2.0 * math.pi * x2)
    s = 2.0 * x2 - 1.0
    thetaj = D * s * (1.0 + (s / B) ** C / (1.0 + C)) + math.pi / 2.0
    return thetag + xp.exp(-A * (x1 - startx1)) * (thetaj - thetag)


def _mmks_derivs(x2, x1, h, A, B, C, startx1):
    """(dtheta/dx1, dtheta/dx2) of the MMKS map, analytic."""
    xp = _xp(x2)
    D = math.pi / (2.0 + 2.0 / (B ** C * (1.0 + C)))
    s = 2.0 * x2 - 1.0
    thetag = math.pi * x2 + (1.0 - h) / 2.0 * xp.sin(2.0 * math.pi * x2)
    thetaj = D * s * (1.0 + (s / B) ** C / (1.0 + C)) + math.pi / 2.0
    dthg = math.pi * (1.0 + (1.0 - h) * xp.cos(2.0 * math.pi * x2))
    dthj = 2.0 * D * (1.0 + (s / B) ** C)
    e = xp.exp(-A * (x1 - startx1))
    return -A * e * (thetaj - thetag), dthg + e * (dthj - dthg)


def read_iharm(dfile, hfile=None):
    """Header + raw float32 dump -> the dict Iharm takes as dump=."""
    with open(hfile or dfile + ".head") as f:
        hv = np.array(f.read().split(), dtype=float)
    hd = dict(tcur=hv[0], nx1=int(hv[1]), nx2=int(hv[2]), nx3=int(hv[3]),
              a=hv[4], hslope=hv[5], gam=hv[6], mks_smooth=hv[7],
              poly_xt=hv[8], poly_alpha=hv[9], startx1=hv[10],
              metric=int(hv[11]), eheat=int(hv[12]) if len(hv) > 12 else 0)
    dlen = 13 + hd["eheat"]
    n = hd["nx1"] * hd["nx2"] * hd["nx3"]
    data = np.fromfile(dfile, np.float32, count=dlen * n).reshape(n, dlen)
    data = data.astype(np.float64)
    hd.update(x1=data[:, 0], x2=data[:, 1], x3=data[:, 2], rho=data[:, 3],
              p=data[:, 4], u=data[:, 5:9], b=data[:, 9:13],
              kela=data[:, 13] if hd["eheat"] else None)
    return hd


@base.register("IHARM")
class Iharm(grmhd3d.Grmhd3D):
    """fargs: dfile (and hfile, default dfile + ".head"), or dump= the dict
    of `read_iharm`.  The dump's metric flag picks MKS(h) or MMKS; gmin >=
    1 is Moscibrodzka's R_high, gmin = -1 Ressler's entropy electrons.
    nt: see base.one_snapshot."""

    interp_td_in_x2 = True

    def __init__(self, dfile="iharm_dump", hfile=None, dump=None, nt=1, *,
                 device):
        super().__init__()
        base.one_snapshot(nt)
        d = dump if dump is not None else read_iharm(dfile, hfile)
        self.asim = float(d["a"])
        self.h = float(d["hslope"])
        self.gam = float(d["gam"])
        self.is_mmks = int(d.get("metric", 0)) == 1
        x1, x2, x3 = f64(d["x1"]), f64(d["x2"]), f64(d["x3"])
        self.mmks = (self.h, float(d.get("mks_smooth", 0.5)),
                     float(d.get("poly_xt", 0.82)),
                     float(d.get("poly_alpha", 14.0)),
                     float(d.get("startx1", x1.min().item())))
        nx1, nx2, nx3 = int(d["nx1"]), int(d["nx2"]), int(d["nx3"])
        shape = (nx1, nx2, nx3)
        r = x1.exp()
        # theta along one x1 column for the lookup grid; the exact MMKS
        # inversion happens per point in x123_of_blks
        if self.is_mmks:
            th = calcth_mmks(x2, x1, *self.mmks)
            uniqth = th.reshape(shape)[-1, :, 0]
            d1, d2 = _mmks_derivs(x2, x1, *self.mmks)
        else:
            th = calcth_mksh(x2, self.h)
            uniqth = th.reshape(shape)[0, :, 0]
            d1 = 0.0
            d2 = math.pi * (1.0 + (1.0 - self.h)
                            * torch.cos(2.0 * math.pi * x2))
        uniqx1 = x1.reshape(shape)[:, 0, 0]
        self._set_grid(device, uniqx1=uniqx1,
                       uniqx2=x2.reshape(shape)[0, :, 0],
                       uniqx3=x3.reshape(shape)[0, 0, :],
                       uniqr=uniqx1.exp(), uniqth=uniqth)

        def to_bl(v):
            """MKS/MMKS four-vector -> KS -> BL (:560-650, ummks2uks)."""
            uks = torch.stack([v[..., 0], r * v[..., 1],
                               v[..., 1] * d1 + v[..., 2] * d2, v[..., 3]],
                              dim=-1)
            return kerr.uks2ubl(uks, r, self.asim)

        arrs = dict(lnrf_storage(to_bl(f64(d["u"])), to_bl(f64(d["b"])), r,
                                 th, self.asim),
                    rho=f64(d["rho"]), p=f64(d["p"]).clamp_min(1e-18))
        self._store({k: v.reshape(shape) for k, v in arrs.items()})
        if d.get("kela") is not None:
            self.extra3 = {"kela": f64(d["kela"]).reshape(shape).to(device)}

    def x123_of_blks(self, r, th, ph):
        x1 = r.log()
        if not self.is_mmks:
            return x1, x2_of_theta(th, self.h), ph
        # Newton inversion of theta(x1, x2) in x2 (findx2mmks)
        x2 = th / math.pi
        for _ in range(30):
            f = calcth_mmks(x2, x1, *self.mmks) - th
            _, df = _mmks_derivs(x2, x1, *self.mmks)
            x2 = (x2 - f / df.clamp_min(1e-10)).clamp(0.0, 1.0)
        return x1, x2, ph

    def convert(self, fv_, sp):
        """Illinois conversion (convert_fluidvars_iharm,
        fluid.f90:995-1026); p holds the internal energy u."""
        mdot_code = pc.G * sp.mbh * pc.msun / pc.c ** 3
        ncgs, bcgs, tempcgs, rhocgs = base.scale_sim_units(
            sp.mbh, sp.mdot, mdot_code, fv_.rho, fv_.p, fv_.bmag)
        if sp.gmin >= 1.0:
            trat = base.monika_e(fv_.rho, fv_.p * (self.gam - 1.0), fv_.bmag,
                                 1.0 / sp.mu - 1.0,
                                 sp.gmin * (1.0 / sp.mu - 1.0))
            tempcgs = 2.0 * tempcgs / 3.0 / (2.0 + trat)
        elif sp.gmin == -1.0 and fv_.kela is not None:
            tempcgs = base.ressler_e(fv_.rho, fv_.kela)
        ncgsnth = base.nonthermale_b2(
            sp.jetalpha, sp.gmin, sp.p1,
            fv_.bmag ** 2 / fv_.rho.clamp_min(1e-37), bcgs)
        rhocgs, ncgs, tempcgs = base.sigma_cut(bcgs, rhocgs, tempcgs, ncgs,
                                               sp.sigcut)
        return EmisInputs(ncgs=ncgs, tcgs=tempcgs, bcgs=bcgs,
                          ncgsnth=ncgsnth)
