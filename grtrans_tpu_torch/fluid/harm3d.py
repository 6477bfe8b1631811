"""HARM3D (Chris White format) 3-D GRMHD snapshot model.

Port of grtrans_tpu/fluid/harm3d.py (reference fluid_model_harm3d.f90):
binary stream dumps with an ASCII header line followed by float32 data of
35 values per zone (read_harm3d_data :516-585: grid cols 4-9 = x1, x2, x3,
r, th, ph, rho col 10, p col 11, u^mu MKS cols 19-22, b^mu MKS cols
27-30), a separate 15-number formatted header file
(read_harm3d_data_header :337-368), theta = pi x2 coordinates (:612),
MKS -> KS -> BL transforms at load time, trilinear sampling (grmhd3d.py)
and HARM-style unit conversion (fluid.f90 convert_fluidvars_harm3d).
"""

import math

import numpy as np

from grtrans_tpu_torch.fluid import base, grmhd3d
from grtrans_tpu_torch.fluid.harm import (f64, harm_convert, lnrf_storage,
                                          umks2uks_bl)


def read_harm3d_dump(dfile, nx1, nx2, nx3, dlen=35):
    """Parse one Chris White binary dump (read_harm3d_data :536-566)."""
    with open(dfile, "rb") as f:
        raw = f.read()
    nl = raw.index(b"\n") + 1
    n = nx1 * nx2 * nx3
    data = np.frombuffer(raw[nl:nl + 4 * dlen * n],
                         np.float32).reshape(n, dlen).astype(np.float64)
    return dict(x1=data[:, 3], x2=data[:, 4], x3=data[:, 5],
                r=data[:, 6], th=data[:, 7], ph=data[:, 8],
                rho=data[:, 9], p=data[:, 10],
                u=data[:, 18:22], b=data[:, 26:30])


def read_harm3d_header(hfile, nhead=15):
    """15-number formatted header (read_harm3d_data_header :337-368)."""
    with open(hfile) as f:
        vals = np.array(f.read().split(), dtype=float)[:nhead]
    out = dict(tcur=vals[0], nx1=int(vals[1]), nx2=int(vals[2]),
               nx3=int(vals[3]), startx1=vals[4], startx2=vals[5],
               startx3=vals[6], dx1=vals[7], dx2=vals[8], dx3=vals[9])
    if nhead == 15:
        out["a"], out["gam"] = vals[10], vals[11]
    else:
        out["a"], out["gam"] = vals[12], vals[13]
    out["h"] = vals[nhead - 2]
    return out


def read_harm3d(dfile, hfile=None):
    """Header + dump -> the dict Harm3D takes as dump=."""
    hd = read_harm3d_header(hfile or dfile + ".head")
    d = read_harm3d_dump(dfile, hd["nx1"], hd["nx2"], hd["nx3"])
    d.update(nx1=hd["nx1"], nx2=hd["nx2"], nx3=hd["nx3"], a=hd["a"],
             gam=hd["gam"], h=hd.get("h", 1.0), tcur=hd["tcur"])
    return d


@base.register("HARM3D")
class Harm3D(grmhd3d.Grmhd3D):
    """fargs: dfile (and hfile, default dfile + ".head"), or dump= the dict
    of `read_harm3d`; mdot_code; nt, see base.one_snapshot.  The theta
    map's h comes from the dump (h = 1 is theta = pi x2, Chris White); the
    keyword h is taken, as in grtrans_tpu, and refused unless 1.0
    (base.not_read)."""

    def __init__(self, dfile="dump040.bin", hfile=None, dump=None,
                 mdot_code=0.003, nt=1, h=1.0, *, device):
        super().__init__()
        base.one_snapshot(nt)
        base.not_read("HARM3D", h=(h, 1.0))
        d = dump if dump is not None else read_harm3d(dfile, hfile)
        self.mdot_code = mdot_code
        self.h = float(d.get("h", 1.0))
        self.asim = float(d["a"])
        nx1, nx2, nx3 = int(d["nx1"]), int(d["nx2"]), int(d["nx3"])
        shape = (nx1, nx2, nx3)          # phi fastest (harm3d_vals:135-139)
        uniqx1 = f64(d["x1"]).reshape(shape)[:, 0, 0]
        uniqx2 = f64(d["x2"]).reshape(shape)[0, :, 0]
        uniqx3 = f64(d["x3"]).reshape(shape)[0, 0, :]
        x2n = uniqx2.numpy()
        uniqth = math.pi * x2n if self.h == 1.0 else (
            math.pi * x2n + 0.5 * (1.0 - self.h) * np.sin(2.0 * math.pi * x2n))
        self._set_grid(device, uniqx1=uniqx1, uniqx2=uniqx2, uniqx3=uniqx3,
                       uniqr=uniqx1.exp(), uniqth=f64(uniqth))
        r, th, x2 = f64(d["r"]), f64(d["th"]), f64(d["x2"])
        u_bl = umks2uks_bl(f64(d["u"]), r, x2, self.h, self.asim)
        b_bl = umks2uks_bl(f64(d["b"]), r, x2, self.h, self.asim)
        arrs = dict(lnrf_storage(u_bl, b_bl, r, th, self.asim),
                    rho=f64(d["rho"]), p=f64(d["p"]).clamp_min(1e-18))
        self._store({k: v.reshape(shape) for k, v in arrs.items()})

    def convert(self, fv_, sp):
        """Same chain as HARM 2-D (fluid.f90 convert_fluidvars_harm3d)."""
        return harm_convert(fv_, sp, self.mdot_code)
