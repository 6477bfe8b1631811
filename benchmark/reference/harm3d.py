"""HARM3D 3-D GRMHD snapshot model on a dump dict (the layout of a Chris
White dump: x1, x2, x3, r, th, ph, rho, p, MKS u^mu and b^mu per zone,
phi fastest; theta = pi x2), with MKS -> KS -> BL transforms at load
time, trilinear sampling (grmhd3d.py) and HARM-style unit conversion
(fluid.f90 convert_fluidvars_harm3d).
"""

import math

import numpy as np

from . import grmhd3d
from .harm import f64, harm_convert, lnrf_storage, umks2uks_bl


class Harm3D(grmhd3d.Grmhd3D):
    """The snapshot of the dump dict `dump` on `device`; mdot_code, the
    code-unit accretion rate.  The theta map's h comes from the dump."""

    def __init__(self, dump, mdot_code=0.003, *, device):
        super().__init__()
        d = dump
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
