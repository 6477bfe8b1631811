"""HARMPI 3-D GRMHD snapshot fluid model (Sasha Tchekhovskoy's harmpi).

Port of grtrans_tpu/fluid/harmpi.py (reference fluid_model_harmpi.f90 +
fluid.f90 convert_fluidvars_harmpi :1028-1072):

 * Dumps are binary stream files: one ASCII header line, then float32
   data of `dlen` values per zone (read_harmpi_data_file :1120-1313).
   Full dumps (SDUMP = 0, the supported kind): grid x1, x2, x3, r, th, ph
   at 1-based cols 4-9, rho@10, internal energy u@11 (to pressure with
   gam - 1, load_harmpi_data :1393), electron entropies kel4a-d @18-21
   when eHEAT / eCOND, u^mu(MKS) @ vpos = 19 + DOKTOT, b^mu(MKS) @ vpos+8.
 * The header is one whitespace-separated line whose length selects the
   variant (read_harmpi_data_header :900-1081): 46 fields = public harmpi,
   >= 60 = private with cylindrified-coordinate parameters.
 * Coordinates: r = R0 + exp(x1 + cpow2 (x1-xbr)^npow2 for x1 > xbr)
   (calcrmks :442-457); theta is MKS-with-hslope on x2 in [-1, 1) (BL = 1,
   harmpi_vals :641) or the "jetcoords" BL = 3 map calcthmksbl3 (:399-423)
   built from the smooth-transition functions Ftr / Ftrgen / Fangle / mins /
   maxs (:132-219), optionally cylindrified near the axis
   (calcth_cylindrified :329-367).  r -> x1 and th -> x2 are fixed-count
   bisections (60 each; the MKS map a 40-step Newton).
 * MKS -> KS uses exact dr/dx1 and central-difference dth/dx1, dth/dx2
   (umks2uksbl3 :535-573; umksh2uks :575-605), then KS -> BL.
 * Sampling: nearest neighbour, the cell's upper corner (harmpi_vals
   :736-737 hard-codes rd = td = pd = 1), with 1e-3 damping of p and rho
   inside the innermost zone: one quad_gather_rows row a sample.  The
   float -> index casts are not clipped before the + 1, as in grtrans_tpu.
 * Units (convert_fluidvars_harmpi): scale_sim_units with mdot_code =
   G M / c^3, electron temperature by the gmin flag: gmin >= 1
   Moscibrodzka R(beta), T_e = T / (1 + R); gmin in [0, 1) Werner+2018
   delta_e scaled by mu; gmin = -1..-4 ressler_e on kel4a..d; plus
   nonthermale_b2 and the sigma cut.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch.fluid import base
from grtrans_tpu_torch.fluid.base import EmisInputs, FluidVars
from grtrans_tpu_torch.fluid.harm import f64, four_vectors, lnrf_storage
from grtrans_tpu_torch.fluid.thickdisk import bisect
from grtrans_tpu_torch.geometry import kerr
from grtrans_tpu_torch.ops.intcast import to_int32
from grtrans_tpu_torch.ops.quad_gather import quad_gather_rows

SMALL = 1e-20
KEL = ("kela", "kelb", "kelc", "keld")


def ftr(x):
    """C^inf step from 0 (x <= 0) to 1 (x >= 1) (Ftr :132-139)."""
    pi = math.pi
    xc = x.clamp(0.0, 1.0)
    mid = (64 + torch.cos(5 * pi * xc) + 70 * torch.sin(pi * (2 * xc - 1) / 2)
           + 5 * torch.sin(3 * pi * (2 * xc - 1) / 2)) / 128.0
    return torch.where(x <= 0.0, 0.0, torch.where(x >= 1.0, 1.0, mid))


def ftrgen(x, xa, xb, ya, yb):
    return ya + (yb - ya) * ftr((x - xa) / (xb - xa))


def fangle(x):
    """Smoothed max(x, 0) (Fangle :152-167)."""
    pi = math.pi
    xc = x.clamp(-1.0, 1.0)
    mid = (1 + xc + (-140 * torch.sin(pi * (1 + xc) / 2)
                     + (10.0 / 3.0) * torch.sin(3 * pi * (1 + xc) / 2)
                     + 0.4 * torch.sin(5 * pi * (1 + xc) / 2))
           / (64.0 * pi)) / 2.0
    return torch.where(x < -1.0, 0.0, torch.where(x > 1.0, x, mid))


def limlin(x, x0, dx, y0):
    return y0 - dx * fangle(-(x - x0) / dx)


def mins(f1, f2, df):
    return limlin(f1, f2, df, f2)


def maxs(f1, f2, df):
    return -mins(-f1, -f2, df)


def minmaxs(f1, f2, df, direction):
    return torch.where(direction > 0.0, maxs(f1, f2, df), mins(f1, f2, df))


def thetaofx2(x2, ror0nu):
    """Jet / disk theta-compression map on x2 in [-1, 1] (:318-327)."""
    pi = math.pi
    th1 = torch.arctan(torch.tan((x2 + 1) * pi / 2) / ror0nu)
    th2 = pi + torch.arctan(torch.tan((x2 - 1) * pi / 2) / ror0nu)
    th3 = pi / 2 + torch.arctan(torch.tan(x2 * pi / 2) * ror0nu)
    return torch.where(x2 < -0.5, th1, torch.where(x2 > 0.5, th2, th3))


@dataclass
class BL3Params:
    """Cylindrified jetcoords parameters (read_bl3_vars :369-397 defaults;
    overridden from private-format headers)."""
    R0: float = 0.0
    rbr: float = 400.0
    npow2: float = 4.0
    cpow2: float = 1.0
    hslope: float = 0.3
    startx1: float = 0.0
    fracdisk: float = 0.25
    fracjet: float = 0.40
    disknu1: float = -2.0
    disknu2: float = 0.75
    jetnu1: float = -2.0
    jetnu2: float = 0.75
    rsjet: float = 0.0
    r0grid: float = 1.6
    r0jet: float = 3.2
    rjetend: float = 1e3
    r0disk: float = 3.2
    rdiskend: float = 8.0
    x10: float = 5.0
    x20: float = -1.0 + 1.0 / 256.0

    @property
    def xbr(self):
        return math.log(self.rbr - self.R0)


def _xi(x1, p):
    return torch.where(
        x1 > p.xbr, x1 + p.cpow2 * (x1 - p.xbr).clamp_min(0.0) ** p.npow2, x1)


def calcrmks(x1, p):
    """x1 -> r (calcrmks :442-457)."""
    return p.R0 + _xi(x1, p).exp()


def drdx1_mks(x1, p):
    dxi = torch.where(x1 > p.xbr, 1.0 + p.npow2 * p.cpow2
                      * (x1 - p.xbr).clamp_min(0.0) ** (p.npow2 - 1.0), 1.0)
    return _xi(x1, p).exp() * dxi


def x1_of_r(r, p, lo=-2.0, hi=12.0, iters=60):
    """Invert calcrmks by bisection (transformbl2mksbl3 :519)."""
    return bisect(lambda x1: calcrmks(x1, p), r, lo, hi, iters)


def calcthmksbl3(x2, r, p):
    """BL = 3 theta(x2, r) (calcthmksbl3 :399-423)."""
    fac = ftrgen(x2.abs(), p.fracdisk, 1 - p.fracjet, 0.0, 1.0)
    r1disk = mins(r / p.r0disk, 1.0, 0.5) * (p.r0disk / p.r0grid)
    r2disk = r / (r1disk * p.r0grid)
    dr = p.rdiskend / p.r0disk
    r2disk = mins(r2disk, dr, 0.5 * dr)
    r1jet = mins(r / p.r0jet, 1.0, 0.5) * (p.r0jet / p.r0grid)
    r2jet = r / (r1jet * p.r0grid)
    dr = p.rjetend / p.r0jet
    r2jet = mins(r2jet, dr, 0.5 * dr)
    ror0nudisk = r1disk ** (0.5 * p.disknu1) * r2disk ** (0.5 * p.disknu2)
    ror0nujet = r1jet ** (0.5 * p.jetnu1) * r2jet ** (0.5 * p.jetnu2)
    thetadisk = thetaofx2(x2, ror0nudisk)
    thetajet = thetaofx2(x2, ror0nujet)
    return fac * thetajet + (1 - fac) * thetadisk


def to1stquadrant(x2in):
    """Map x2 to [-1, 0], tracking the mirroring (:221-240)."""
    ntimes = torch.floor((x2in + 2.0) / 4.0)
    x2 = x2in - 4.0 * ntimes
    pos = x2 > 0.0
    x2 = torch.where(pos, -x2, x2)
    low = x2 < -1.0
    x2 = torch.where(low, -2.0 - x2, x2)
    return x2, pos ^ low


def _sinth1in(r0, r, x2, p):
    return r0 * torch.sin(calcthmksbl3(x2, torch.full_like(x2, r0), p)) / r


def _th2in(r0, r, x20, x2, p):
    z = torch.zeros_like(r)
    thetac = calcthmksbl3(x20 + z, r, p)
    thetamid = calcthmksbl3(z, r, p)
    theta = calcthmksbl3(x2, r, p)
    th0v = calcthmksbl3(torch.full_like(r, x20), torch.full_like(r, r0), p)
    th0 = torch.arcsin((r0 * torch.sin(th0v) / r).clamp(-1.0, 1.0))
    return (theta - thetac) / (thetamid - thetac) * (thetamid - th0) + th0


def _func2(r0, r, x20, x2, p):
    mone = torch.full_like(x2, -1.0)
    sth1in = _sinth1in(r0, r, x2, p)
    sth2in = torch.sin(_th2in(r0, r, x20, x2, p))
    sth1ax = _sinth1in(r0, r, mone, p)
    sth2ax = torch.sin(_th2in(r0, r, x20, mone, p))
    return minmaxs(sth1in, sth2in, (sth2ax - sth1ax).abs() + SMALL, r - r0)


def calcth_cylindrified(x2in, rin, p):
    """Cylindrify theta near the axis (calcth_cylindrified :329-367)."""
    thorig = calcthmksbl3(x2in, rin, p)
    x2m, mirrored = to1stquadrant(x2in)
    thmirror = calcthmksbl3(x2m, rin, p)
    one = torch.ones((), dtype=rin.dtype, device=rin.device)
    r0 = calcrmks(p.x10 * one, p).item()
    x1tr = math.log(0.5 * (math.exp(p.x10) + math.exp(p.startx1)))
    rtr = calcrmks(x1tr * one, p).item()
    rtrv = torch.full_like(rin, rtr)
    f1 = torch.sin(calcthmksbl3(x2m, rin, p))
    f2 = _func2(r0, rin, p.x20, x2m, p)
    dftr = _func2(r0, rtrv, p.x20, x2m, p) \
        - torch.sin(calcthmksbl3(x2m, rtrv, p))
    sinth = maxs(rin * f1, rin * f2, rtr * dftr.abs() + SMALL) / rin
    th = torch.arcsin(sinth.clamp(-1.0, 1.0))
    return torch.where(mirrored, thorig - (th - thmirror),
                       thorig + (th - thmirror))


def x2_of_th_bl3(th, r, p, iters=60):
    """Invert calcthmksbl3 in x2 by bisection (findx2mksbl3 :425-440; not
    the cylindrified map, matching transformbl2mksbl3 :526)."""
    return bisect(lambda x2: calcthmksbl3(x2, r, p), th, -1.0, 1.0, iters)


def theta_mksh(x2, hslope):
    """BL = 1: x2 in [-1, 1) -> theta (harmpi_vals :641)."""
    return math.pi / 2 * (1 + x2) \
        + 0.5 * (1 - hslope) * torch.sin(math.pi * (1 + x2))


def x2_of_th_mksh(th, hslope, iters=40):
    x2 = th / math.pi * 2.0 - 1.0
    for _ in range(iters):
        f = theta_mksh(x2, hslope) - th
        df = math.pi / 2 * (1 + (1 - hslope) * torch.cos(math.pi * (1 + x2)))
        x2 = (x2 - f / df.clamp_min(1e-10)).clamp(-1.0, 1.0)
    return x2


def parse_harmpi_header(line):
    """Parse the whitespace header with the reference's length cascade
    (read_harmpi_data_header :900-1081)."""
    vals = [float(v) for v in line.split()]
    nhead = len(vals)
    keys = ["tcur", "N1", "N2", "N3", "nx1", "nx2", "nx3", "N1G", "N2G",
            "N3G", "startx1", "startx2", "startx3", "dx1", "dx2", "dx3",
            "tf", "nstep", "asim", "gam", "cour", "DTd", "DTl", "DTi",
            "DTr", "DTr01", "dump_cnt", "image_cnt", "rdump_cnt",
            "rdump01_cnt", "dt", "lim", "failed", "Rin", "Rout",
            "hslope", "R0"]
    h = dict(zip(keys, vals))
    n = len(keys)
    h.update(eHEAT=-1, eCOND=-1, DOKTOT=0, BL=1.0, SDUMP=0,
             DOCYLINDRIFYCOORDS=0.0, rbr=400.0, npow2=4.0, cpow2=1.0)

    def take(names, n):
        for k in names:
            if n < nhead:
                h[k] = vals[n]
                n += 1
        return n

    if 45 <= nhead <= 46:
        for k in ("NPR", "DOKTOT", "fractheta", "fracphi", "rbr", "npow2",
                  "cpow2", "BL"):
            h[k] = vals[n]
            n += 1
    else:
        n = take(("NPR", "DOKTOT", "eHEAT", "eCOND", "DONUCLEAR", "DOFLR"), n)
        cyl_keys = ("DOCYLINDRIFYCOORDS", "fractheta", "fracphi", "rbr",
                    "npow2", "cpow2", "global_x10", "global_x20",
                    "global_fracdisk", "global_fracjet", "global_r0disk",
                    "global_rdiskend", "global_r0jet", "global_rjetend",
                    "global_jetnu2", "global_rsjet", "global_r0grid")
        if n + len(cyl_keys) <= nhead:
            n = take(cyl_keys, n)
        n = take(("BL", "EVOLVEVPOT", "global_jetnu1", "global_disknu1",
                  "global_disknu2"), n)
        if n + 2 <= nhead:
            n = take(("myNp", "NPTOT"), n)
        n = take(("SDUMP",), n)
    h["nhead"] = nhead
    # dlen for full dumps (:1066-1080)
    eon = h.get("eHEAT", -1) == 1 or h.get("eCOND", -1) == 1
    h["dlen"] = int(58 - 19 + h.get("NPR", 0)) if eon else 42
    return h


def bl3_params_from_header(h):
    p = BL3Params(R0=h["R0"], rbr=h.get("rbr", 400.0),
                  npow2=h.get("npow2", 4.0), cpow2=h.get("cpow2", 1.0),
                  hslope=h["hslope"], startx1=h["startx1"])
    rin = math.exp(h["startx1"]) + h["R0"]
    defaults = dict(fracdisk=0.25, fracjet=0.40, disknu1=-2.0, disknu2=0.75,
                    jetnu1=-2.0, jetnu2=0.75, rsjet=0.0, r0grid=rin,
                    r0jet=2 * rin, rjetend=1e3, r0disk=2 * rin,
                    rdiskend=5 * rin, x10=5.0, x20=-1.0 + 1.0 / 256.0)
    for k, v in defaults.items():
        setattr(p, k, h.get("global_" + k, v))
    return p


def read_harmpi_dump(dfile, hfile=None):
    """One full harmpi dump -> dict (read_harmpi_data_file :1120-1313,
    SDUMP = 0 layout)."""
    with open(dfile, "rb") as f:
        raw = f.read()
    nl = raw.index(b"\n")
    if hfile:
        with open(hfile) as f:
            h = parse_harmpi_header(f.read().strip())
    else:
        h = parse_harmpi_header(raw[:nl].decode())
    n = int(h["nx1"]) * int(h["nx2"]) * int(h["nx3"])
    dlen = h["dlen"]
    data = np.frombuffer(raw[nl + 1:nl + 1 + 4 * dlen * n],
                         np.float32).reshape(n, dlen).astype(np.float64)
    vpos = 18 + int(max(h.get("DOKTOT", 0), 0))
    out = dict(h=h, x1=data[:, 3], x2=data[:, 4], x3=data[:, 5],
               r=data[:, 6], th=data[:, 7], ph=data[:, 8],
               rho=data[:, 9], uint=data[:, 10],
               u=data[:, vpos:vpos + 4], b=data[:, vpos + 8:vpos + 12])
    if h.get("eHEAT", -1) == 1 or h.get("eCOND", -1) == 1:
        for i, k in enumerate(KEL):
            out[k] = data[:, 17 + i]
    return out


@base.register("HARMPI")
class HarmPI(nn.Module):
    """fargs: dfile (and hfile), or dump= the dict of `read_harmpi_dump`;
    mdot_code (default G M / c^3 at convert); nt, see base.one_snapshot.
    The electron model is picked by gmin, see the module docstring."""

    def __init__(self, dfile="", hfile=None, dump=None, mdot_code=None,
                 nt=1, *, device):
        super().__init__()
        base.one_snapshot(nt)
        d = dump if dump is not None else read_harmpi_dump(dfile, hfile)
        h = d["h"] if isinstance(d.get("h"), dict) else d
        self.mdot_code = mdot_code
        self.asim = float(h["asim"])
        self.gam = float(h["gam"])
        self.BL = int(h.get("BL", 1))
        self.hslope = float(h["hslope"])
        self.nx1, self.nx2, self.nx3 = shape = (
            int(h["nx1"]), int(h["nx2"]), int(h["nx3"]))
        self.p3 = bl3_params_from_header(dict(h)) if self.BL == 3 \
            else BL3Params(R0=h.get("R0", 0.0), hslope=self.hslope)
        self.cyl = bool(h.get("DOCYLINDRIFYCOORDS", 0))
        # x3 fastest, then x2, then x1 (harmpi_vals :638-640)
        uniqx1 = f64(d["x1"]).reshape(shape)[:, 0, 0]
        r, th = f64(d["r"]), f64(d["th"])
        x1f, x2f = f64(d["x1"]), f64(d["x2"])
        u_bl = self._umks2ubl(f64(d["u"]), x1f, x2f, r)
        b_bl = self._umks2ubl(f64(d["b"]), x1f, x2f, r)
        # internal energy -> pressure (load_harmpi_data :1393)
        cols = dict(lnrf_storage(u_bl, b_bl, r, th, self.asim),
                    rho=f64(d["rho"]), p=f64(d["uint"]) * (self.gam - 1.0))
        self.has_kel = "kela" in d
        self.PFIELDS = ("rho", "p", "u0", "vrl", "vtl", "vpl", "b0", "br",
                        "bth", "bph") + (KEL if self.has_kel else ())
        for k in KEL if self.has_kel else ():
            cols[k] = f64(d[k])
        fstack = torch.stack([cols[k] for k in self.PFIELDS], dim=-1)
        for name, t in (("uniqx1", uniqx1),
                        ("uniqx2", f64(d["x2"]).reshape(shape)[0, :, 0]),
                        ("uniqx3", f64(d["x3"]).reshape(shape)[0, 0, :]),
                        ("uniqr", calcrmks(uniqx1, self.p3)),
                        ("fstack", fstack)):
            self.register_buffer(name, t.contiguous().to(device))

    def _theta_of_x2(self, x2, r):
        if self.BL == 3:
            if self.cyl:
                return calcth_cylindrified(x2, r, self.p3)
            return calcthmksbl3(x2, r, self.p3)
        return theta_mksh(x2, self.hslope)

    def _umks2ubl(self, um, x1, x2, r):
        """MKS -> KS (exact dr/dx1 + central-difference theta derivatives,
        umks2uksbl3 :535-573) -> BL."""
        if self.BL == 3:
            dx1 = 1e-4 * x1.abs().clamp_min(1.0)
            dx2 = 1e-6 * x2.abs().clamp_min(1.0)
            drdx1 = drdx1_mks(x1, self.p3)
            dthdx1 = (self._theta_of_x2(x2, calcrmks(x1 + 0.5 * dx1, self.p3))
                      - self._theta_of_x2(x2, calcrmks(x1 - 0.5 * dx1,
                                                       self.p3))) / dx1
            dthdx2 = (self._theta_of_x2(x2 + 0.5 * dx2, r)
                      - self._theta_of_x2(x2 - 0.5 * dx2, r)) / dx2
            uks = torch.stack([um[..., 0], drdx1 * um[..., 1],
                               dthdx1 * um[..., 1] + dthdx2 * um[..., 2],
                               um[..., 3]], dim=-1)
        else:
            dthdx2 = math.pi / 2 * (1 + (1 - self.hslope)
                                    * torch.cos(math.pi * (1 + x2)))
            uks = torch.stack([um[..., 0], r * um[..., 1],
                               dthdx2 * um[..., 2], um[..., 3]], dim=-1)
        return kerr.uks2ubl(uks, r, self.asim)

    def vals(self, x, k, a):
        nx1, nx2, nx3 = self.nx1, self.nx2, self.nx3
        r = x[..., 1]
        th = x[..., 2]
        zphi = torch.remainder(kerr.bl2ks_phi(r, x[..., 3], a), 2.0 * math.pi)
        zphi = torch.where(zphi < 0.0, zphi + 2.0 * math.pi, zphi)
        if self.BL == 3:
            x1 = x1_of_r(r, self.p3)
            x2 = x2_of_th_bl3(th, r, self.p3)
        else:
            x1 = (r - self.p3.R0).clamp_min(1e-12).log()
            x2 = x2_of_th_mksh(th, self.hslope)
        u1a, u1b = self.uniqx1[0], self.uniqx1[-1]
        u2a, u2b = self.uniqx2[0], self.uniqx2[-1]
        u3a, u3b = self.uniqx3[0], self.uniqx3[-1]
        # nearest-neighbour upper-corner lookup (harmpi_vals :736-737:
        # rd = td = pd = 1 selects the upper corner)
        lx1 = to_int32(torch.floor((x1 - u1a) / (u1b - u1a) * (nx1 - 1)))
        lx2 = to_int32(torch.floor((x2 - u2a) / (u2b - u2a) * (nx2 - 1)))
        lx3 = to_int32(torch.floor((zphi - u3a) / (u3b - u3a) * (nx3 - 1)))
        # int32 throughout, as XLA computes it: a cast saturated at the top
        # wraps at the + 1 and clips to 0
        ix1 = (lx1 + 1).clamp(0, nx1 - 1)
        ix2 = (lx2 + 1).clamp(0, nx2 - 1)
        ix3 = torch.remainder(lx3 + 1, nx3)
        inner = self.uniqr[lx1.clamp(0, nx1 - 1).long()] <= kerr.horizon(a)
        damp = torch.ones_like(r).masked_fill(inner, 1e-3)
        outside = x1 <= u1a

        # one row of the stacked table a sample
        idx = ((ix1 * nx2 + ix2) * nx3 + ix3).reshape(-1, 1)
        nf = len(self.PFIELDS)
        vals = quad_gather_rows(self.fstack, idx.contiguous(),
                                torch.ones((idx.shape[0], 1, 1), dtype=r.dtype,
                                           device=r.device), 1, nf)
        col = dict(zip(self.PFIELDS, vals.reshape(r.shape + (nf,)).unbind(-1)))
        rho = torch.where(outside, 0.0, col["rho"]) * damp
        p = torch.where(outside, 1e-18, col["p"]) * damp
        u, b, bmag = four_vectors(col, outside, r, th, a)
        kel = {kk: torch.where(outside, 0.0, col[kk]) for kk in KEL} \
            if self.has_kel else {}
        return FluidVars(rho=rho, p=p, bmag=bmag, u=u, b=b, rho2=rho,
                         kela=kel.get("kela"), extra=kel or None)

    def convert(self, fv_, sp):
        """convert_fluidvars_harmpi (fluid.f90:1028-1072)."""
        mdot_code = self.mdot_code if self.mdot_code is not None \
            else pc.G * sp.mbh * pc.msun / pc.c ** 3
        ncgs, bcgs, tempcgs, rhocgs = base.scale_sim_units(
            sp.mbh, sp.mdot, mdot_code, fv_.rho, fv_.p, fv_.bmag)
        if sp.gmin >= 1.0:
            trat = base.monika_e(fv_.rho, fv_.p, fv_.bmag, 1.0 / sp.mu - 1.0,
                                 sp.gmin * (1.0 / sp.mu - 1.0))
            tempcgs = tempcgs / (1.0 + trat)
        elif sp.gmin < 0.0:
            which = {-1.0: "kela", -2.0: "kelb", -3.0: "kelc"}.get(sp.gmin,
                                                                   "keld")
            kel = (fv_.extra or {}).get(which)
            if kel is None:
                raise ValueError("gmin < 0 requires electron-entropy fields "
                                 "(eHEAT / eCOND dumps)")
            tempcgs = base.ressler_e(fv_.rho, kel)
        else:
            tempcgs = sp.mu * base.werner_e(fv_.rho, fv_.bmag) * tempcgs
        ncgsnth = base.nonthermale_b2(
            sp.jetalpha, max(sp.gmin, 1.0), sp.p1,
            fv_.bmag ** 2 / fv_.rho.clamp_min(1e-37), bcgs)
        rhocgs, ncgs, tempcgs = base.sigma_cut(bcgs, rhocgs, tempcgs, ncgs,
                                               sp.sigcut)
        return EmisInputs(ncgs=ncgs, tcgs=tempcgs, bcgs=bcgs,
                          ncgsnth=ncgsnth)
