"""MB09: McKinney & Blandford 2009 fieldline-format GRMHD model.

Port of grtrans_tpu/fluid/mb09.py (reference fluid_model_mb09.f90 +
fluid.f90 convert_fluidvars_mb09 :942-957):

 * Grid file: Fortran sequential-unformatted records [nx1, nx2, nx3
   (int32)], [x1], [x2], [x3] (float64, x1 fastest; read_mb09_grid_file
   :754-767).
 * Data files: records [nx (int32) = 9 n], [data (float32)] of 9
   consecutive n-blocks: rho, p, coordinate velocities v^r, v^th, v^ph
   (dx^i/dt) and the BL four-field b^t, b^r, b^th, b^ph (read_mb09_data
   :769-799).  u^t is recovered from the metric normalization (:795-798).
 * Coordinates: r = exp(x1 + (x1-xbr)^10 for x1 > xbr) with xbr = 25
   (initialize_mb09_model :718); theta(x2, r) is the McKinney-Gammie
   defcoord=9 map calcthmks (:133-153); phi = 2 pi x3.
 * Sampling: THICKDISK's trilinear pattern (mb09_vals :424-...).
 * Units: scale_sim_units with mdot_code = 0.0013, Moscibrodzka R(beta)
   electron temperature, ncgsnth = ncgs.
"""

import math

import numpy as np
import torch

from grtrans_tpu_torch.fluid import base
from grtrans_tpu_torch.fluid.base import EmisInputs
from grtrans_tpu_torch.fluid.harm import f64
from grtrans_tpu_torch.fluid.thickdisk import ThickDisk, calcrmks
from grtrans_tpu_torch.geometry import kerr

XBR_MB09 = 25.0


def calcthmks9(x2, r):
    """McKinney-Gammie defcoord=9 theta map (calcthmks :133-153)."""
    pi = math.pi
    rj, nj, r0j, rsj, q = 2.8, 0.3, 20.0, 80.0, 1.3
    g = -nj * (0.5 + 1.0 / pi * torch.arctan((r - rsj) / r0j))
    h = 2.0 - q * (r / rj) ** g
    lower = pi * x2 + 0.5 * (1.0 - h) * torch.sin(2.0 * pi * x2)
    upper = pi * x2 - 0.5 * (1.0 - h) * torch.sin(2.0 * pi * (1.0 - x2))
    return torch.where(x2 < 0.5, lower, upper)


def _read_record(buf, off, dtype, count):
    """One Fortran sequential record: 4-byte length framing."""
    n1 = int(np.frombuffer(buf, np.int32, 1, off)[0])
    data = np.frombuffer(buf, dtype, count, off + 4)
    n2 = int(np.frombuffer(buf, np.int32, 1, off + 4 + data.nbytes)[0])
    if not n1 == n2 == data.nbytes:
        raise ValueError(f"record framing {n1}, {n2} around {data.nbytes} "
                         "bytes")
    return data, off + 8 + data.nbytes


def read_mb09_grid(gfile):
    with open(gfile, "rb") as f:
        buf = f.read()
    dims, off = _read_record(buf, 0, np.int32, 3)
    nx1, nx2, nx3 = (int(v) for v in dims)
    n = nx1 * nx2 * nx3
    x1, off = _read_record(buf, off, np.float64, n)
    x2, off = _read_record(buf, off, np.float64, n)
    x3, off = _read_record(buf, off, np.float64, n)
    return dict(nx1=nx1, nx2=nx2, nx3=nx3, x1=x1, x2=x2, x3=x3)


def read_mb09_data(dfile, n):
    with open(dfile, "rb") as f:
        buf = f.read()
    nx, off = _read_record(buf, 0, np.int32, 1)
    if int(nx[0]) != 9 * n:
        raise ValueError(f"{dfile}: {int(nx[0])} values for {n} zones")
    data, off = _read_record(buf, off, np.float32, 9 * n)
    d = data.astype(np.float64).reshape(9, n)
    return dict(rho=d[0], p=d[1], vr=d[2], vth=d[3], vph=d[4],
                b=np.stack([d[5], d[6], d[7], d[8]], axis=-1))


@base.register("MB09")
class MB09(ThickDisk):
    """The trilinear sampler of ThickDisk with MB09's theta map, file
    format and units.  fargs: gfile and dfile, or dump=dict(grid=..., data=...
    [, a=...]) of `read_mb09_grid` / `read_mb09_data`; asim_in, the spin
    (the files do not carry it); nt, see base.one_snapshot.  hfile, jonfix
    and mdot_code are THICKDISK's, taken as in grtrans_tpu and refused
    unless at their defaults (base.not_read)."""

    thfunc = staticmethod(calcthmks9)

    def __init__(self, dfile="", gfile="", dump=None, asim_in=0.9, nt=1,
                 hfile=None, jonfix=1, mdot_code=0.0013, *, device):
        super(ThickDisk, self).__init__()
        base.one_snapshot(nt)
        base.not_read("MB09", hfile=(hfile, None), jonfix=(jonfix, 1),
                      mdot_code=(mdot_code, 0.0013))
        if dump is not None:
            g, d = dump["grid"], dump["data"]
            self.asim = float(dump.get("a", asim_in))
        else:
            g = read_mb09_grid(gfile)
            d = read_mb09_data(dfile, g["nx1"] * g["nx2"] * g["nx3"])
            self.asim = float(asim_in)
        self.xbr = XBR_MB09
        nx1, nx2 = int(g["nx1"]), int(g["nx2"])
        x1f, x2f = f64(g["x1"]), f64(g["x2"])
        # x1 fastest (read_mb09_grid_file layout)
        uniqx1 = x1f[:nx1]
        uniqx2 = x2f[:nx1 * (nx2 - 1) + 1:nx1]
        uniqx3 = f64(g["x3"])[::nx1 * nx2]
        r = calcrmks(x1f, self.xbr)
        th = calcthmks9(x2f, r)
        g_cov = kerr.metric_cov(r, th, self.asim)
        vr, vth, vph = f64(d["vr"]), f64(d["vth"]), f64(d["vph"])
        # u^t from normalization (read_mb09_data :795-798)
        ui2 = (g_cov[..., 0] + 2.0 * g_cov[..., 3] * vph
               + g_cov[..., 4] * vr ** 2 + g_cov[..., 7] * vth ** 2
               + g_cov[..., 9] * vph ** 2)
        u0 = 1.0 / (-ui2).clamp_min(1e-37).sqrt()
        vrl, vtl, vpl = kerr.lnrf_frame(vr, vth, vph, r, self.asim, th)
        b_bl = f64(d["b"])
        cols = dict(rho=f64(d["rho"]), p=f64(d["p"]), u0=u0, vrl=vrl,
                    vtl=vtl, vpl=vpl, b0=b_bl[..., 0], br=b_bl[..., 1],
                    bth=b_bl[..., 2], bph=b_bl[..., 3])
        self._set_grid(device, cols, uniqx1, uniqx2, uniqx3)

    def convert(self, fv_, sp):
        """convert_fluidvars_mb09 (fluid.f90:942-957)."""
        ncgs, bcgs, tempcgs, rhocgs = base.scale_sim_units(
            sp.mbh, sp.mdot, 0.0013, fv_.rho, fv_.p, fv_.bmag)
        trat = base.monika_e(fv_.rho, fv_.p, fv_.bmag, 1.0 / sp.mu - 1.0,
                             sp.gmin * (1.0 / sp.mu - 1.0))
        tempcgs = tempcgs / (1.0 + trat)
        return EmisInputs(ncgs=ncgs, tcgs=tempcgs, bcgs=bcgs, ncgsnth=ncgs)
