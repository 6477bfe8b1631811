"""HARM 2-D GRMHD snapshot fluid model.

Port of grtrans_tpu/fluid/harm.py (reference fluid_model_harm.f90): ASCII
dump reader (:300-410, 34-column rows, header of 26), MKS(h) coordinates
x1 = ln r, theta = pi x2 + (1-h)/2 sin(2 pi x2) with a fixed-count Newton
inversion, MKS -> KS -> BL four-vector transforms (:74-100 + kerr.uks2ubl),
bilinear sampling with nearest neighbour inside the innermost zone
(:100-265), and scale_sim_units + Moscibrodzka electron temperatures
(fluid.f90:957-973).

A dump is a dict of numpy arrays (as `read_harm_dump` returns it); every
array is taken to float64 on the host, the one-off coordinate algebra runs
there, and the corner-packed table is placed on the device once.  One
sample is one quad_gather row (4 corners x 10 fields).
"""

import math

import numpy as np
import torch
from torch import nn

from grtrans_tpu_torch import obs
from grtrans_tpu_torch.fluid import base
from grtrans_tpu_torch.fluid.base import EmisInputs, FluidVars
from grtrans_tpu_torch.geometry import fourvector as fv
from grtrans_tpu_torch.geometry import kerr
from grtrans_tpu_torch.ops.intcast import trunc_clip
from grtrans_tpu_torch.ops.quad_gather import bilinear_packed, pack_corners_2d

FIELDS = ("rho", "p", "u0", "vrl", "vtl", "vpl", "b0", "br", "bth", "bph")


def f64(x):
    """numpy array or number -> float64 CPU tensor."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def theta_of_x2(x2, h):
    """MKS(h) polar coordinate map on numpy arrays
    (fluid_model_harm.f90:52-56)."""
    return np.pi * x2 + 0.5 * (1.0 - h) * np.sin(2.0 * np.pi * x2)


def x2_of_theta(th, h, iters=30):
    """Invert theta(x2) by `iters` Newton steps (the map is monotonic);
    batched over the tensor th."""
    x2 = th / math.pi
    for _ in range(iters):
        f = math.pi * x2 + 0.5 * (1.0 - h) * torch.sin(2.0 * math.pi * x2) \
            - th
        df = math.pi * (1.0 + (1.0 - h) * torch.cos(2.0 * math.pi * x2))
        x2 = x2 - f / df.clamp_min(1e-10)
    return x2.clamp(0.0, 1.0)


def umks2uks_bl(um, r, x2, h, a):
    """MKS four-vector -> KS -> BL (fluid_model_harm.f90:74-100 +
    kerr.uks2ubl)."""
    dthdx2 = math.pi * (1.0 + (1.0 - h) * torch.cos(2.0 * math.pi * x2))
    uks = torch.stack([um[..., 0], r * um[..., 1], um[..., 2] * dthdx2,
                       um[..., 3]], dim=-1)
    return kerr.uks2ubl(uks, r, a)


def lnrf_storage(u_bl, b_bl, r, th, a):
    """BL four-vectors -> the stored columns (u0, LNRF velocities, b^mu):
    velocities are kept as LNRF components so that interpolation stays
    subluminal."""
    vrl, vtl, vpl = kerr.lnrf_frame(u_bl[..., 1] / u_bl[..., 0],
                                    u_bl[..., 2] / u_bl[..., 0],
                                    u_bl[..., 3] / u_bl[..., 0], r, a, th)
    return {"u0": u_bl[..., 0], "vrl": vrl, "vtl": vtl, "vpl": vpl,
            "b0": b_bl[..., 0], "br": b_bl[..., 1], "bth": b_bl[..., 2],
            "bph": b_bl[..., 3]}


def four_vectors(col, outside, r, th, a):
    """Sampled columns -> (u, b, bmag) in BL: outside-grid defaults
    (u = (1, 0, 0, 0), b = (0, 0, 0, 1)), LNRF -> BL, |b|."""
    u0 = torch.where(outside, 1.0, col["u0"])
    vrl = torch.where(outside, 0.0, col["vrl"])
    vtl = torch.where(outside, 0.0, col["vtl"])
    vpl = torch.where(outside, 0.0, col["vpl"])
    b = torch.stack([col["b0"], col["br"], col["bth"], col["bph"]], dim=-1)
    with obs.sync("harm.four_vectors"):
        unit = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=b.dtype,
                            device=b.device)
    b = torch.where(outside[..., None], unit, b)
    bmag = kerr.safe_sqrt(fv.dot(kerr.metric_cov(r, th, a), b, b))
    vr, vth, om = kerr.lnrf_frame_inv(vrl, vtl, vpl, r, a, th)
    u = torch.stack([u0, u0 * vr, u0 * vth, u0 * om], dim=-1)
    return u, b, bmag


def read_harm_dump(dfile, hfile=None, nhead=26):
    """Read a HARM ASCII dump (and optional separate header file).

    Column map (read_harm_data_file, :317-320): 0:x1 1:x2 2:r 3:th,
    4:rho, 5:p, 13-16: u^mu (MKS), 21-24: b^mu (MKS), 33: gdet."""
    with open(hfile or dfile) as f:
        header = np.array(f.readline().split(), dtype=float)
    nx1 = int(header[1])
    nx2 = int(header[2])
    h = header[nhead - 2] if len(header) >= nhead else 0.3
    data = np.loadtxt(dfile, skiprows=1)
    if data.shape[0] != nx1 * nx2:
        raise ValueError(f"{dfile}: {data.shape[0]} rows for a {nx1} x "
                         f"{nx2} grid")
    return dict(tcur=header[0], nx1=nx1, nx2=nx2, a=header[9],
                gam=header[10], h=h,
                x1=data[:, 0], x2=data[:, 1], r=data[:, 2], th=data[:, 3],
                rho=data[:, 4], p=data[:, 5],
                u=data[:, 13:17], b=data[:, 21:25], gdet=data[:, 33])


def harm_convert(fv_, sp, mdot_code):
    """scale_sim_units + Moscibrodzka R(beta) electron temperature
    (convert_fluidvars_harm, fluid.f90:957-973)."""
    ncgs, bcgs, tempcgs, rhocgs = base.scale_sim_units(
        sp.mbh, sp.mdot, mdot_code, fv_.rho, fv_.p, fv_.bmag)
    trat = base.monika_e(fv_.rho, fv_.p, fv_.bmag, sp.mu, sp.mu / sp.gmin)
    tempcgs = tempcgs * trat
    rhocgs, ncgs, tempcgs = base.sigma_cut(bcgs, rhocgs, tempcgs, ncgs,
                                           sp.sigcut)
    return EmisInputs(ncgs=ncgs, tcgs=tempcgs, bcgs=bcgs, ncgsnth=ncgs)


@base.register("HARM")
class Harm(nn.Module):
    """fargs: dfile (and hfile) of an ASCII dump, or dump= the dict of
    `read_harm_dump`; mdot_code, the code-unit accretion rate
    (fluid.f90:964); nt, see base.one_snapshot."""

    @obs.model_setup
    def __init__(self, dfile="dump040", hfile=None, dump=None,
                 mdot_code=0.003, nt=1, *, device):
        super().__init__()
        base.one_snapshot(nt)
        d = dump if dump is not None else read_harm_dump(dfile, hfile)
        self.mdot_code = mdot_code
        self.h = float(d["h"])
        self.asim = float(d["a"])
        self.nx1, self.nx2 = nx1, nx2 = int(d["nx1"]), int(d["nx2"])
        # theta is the fastest-changing index in the flat arrays
        uniqx1 = f64(d["x1"]).reshape(nx1, nx2)[:, 0]
        uniqx2 = f64(d["x2"]).reshape(nx1, nx2)[0, :]
        uniqth = f64(theta_of_x2(uniqx2.numpy(), self.h))
        r, th, x2 = f64(d["r"]), f64(d["th"]), f64(d["x2"])
        # u, b to BL at load time (read_harm_data_file:384-390)
        u_bl = umks2uks_bl(f64(d["u"]), r, x2, self.h, self.asim)
        b_bl = umks2uks_bl(f64(d["b"]), r, x2, self.h, self.asim)
        cols = dict(lnrf_storage(u_bl, b_bl, r, th, self.asim),
                    rho=f64(d["rho"]), p=f64(d["p"]))
        grid = torch.stack([cols[k] for k in FIELDS], dim=-1)
        quad = pack_corners_2d(grid.reshape(nx1, nx2, len(FIELDS)).numpy())
        for name, t in (("uniqx1", uniqx1), ("uniqx2", uniqx2),
                        ("uniqr", uniqx1.exp()), ("uniqth", uniqth),
                        ("fquad", torch.from_numpy(quad)),
                        # sampled by float32 points (prec="mixed")
                        ("fquad32", torch.from_numpy(quad).float())):
            self.register_buffer(name, t.contiguous().to(device))

    def vals(self, x, k, a):
        nx1, nx2 = self.nx1, self.nx2
        r = x[..., 1]
        th = x[..., 2]
        x1 = r.log()
        x2 = x2_of_theta(th, self.h)
        u1a, u1b = self.uniqx1[0], self.uniqx1[-1]
        u2a, u2b = self.uniqx2[0], self.uniqx2[-1]
        lx1 = trunc_clip((x1 - u1a) / (u1b - u1a) * (nx1 - 1), nx1 - 2)
        lx2 = trunc_clip((x2 - u2a) / (u2b - u2a) * (nx2 - 1), nx2 - 2)
        i1, i2 = lx1.long(), lx2.long()
        rd = (r - self.uniqr[i1]) / (self.uniqr[i1 + 1] - self.uniqr[i1])
        td = (th - self.uniqth[i2]) / (self.uniqth[i2 + 1] - self.uniqth[i2])
        # nearest neighbour inside the innermost zone outside the horizon
        # (fluid_model_harm.f90:163-165)
        rd = torch.where(self.uniqr[i1] <= kerr.horizon(a), 1.0,
                         rd.clamp(0.0, 1.0))
        td = td.clamp(0.0, 1.0)
        outside = ~(x1 > u1a)

        table = self.fquad32 if r.dtype == torch.float32 else self.fquad
        vals = bilinear_packed(table, nx2, len(FIELDS), lx1, lx2,
                               rd.to(r.dtype), td.to(r.dtype))
        col = dict(zip(FIELDS, vals.unbind(-1)))
        rho = torch.where(outside, 0.0, col["rho"])
        p = torch.where(outside, 1.0, col["p"])
        u, b, bmag = four_vectors(col, outside, r, th, a)
        return FluidVars(rho=rho, p=p, bmag=bmag, u=u, b=b, rho2=rho)

    def convert(self, fv_, sp):
        return harm_convert(fv_, sp, self.mdot_code)
