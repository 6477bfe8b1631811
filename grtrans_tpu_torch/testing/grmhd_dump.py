"""Seeded synthetic GRMHD snapshots for every snapshot model of the port,
as the numpy dump dicts the models take (`dump=`) and as files in each
code's native layout.

The flow is the same on every grid: Keplerian rotation outside the ISCO
and the plunging geodesic flow inside it, a toroidal field of strength
1 / r, and a torus of density exp(-((r - 6) / 6)^2) with an m = 2 azimuthal
mode and seeded log-normal turbulence; the pressure is a tenth of the
density.  The BL four-vectors are carried to each code's own coordinate
basis (BL -> KS -> MKS) with the derivatives its loader applies in the
other direction, so a loaded model gives back u.u = -1 at the nodes.

    python -m grtrans_tpu_torch.testing.grmhd_dump harm3d out.bin --seed 1
"""

import argparse
import math

import numpy as np
import torch

from grtrans_tpu_torch.fluid import harmpi, iharm, koral, mb09, thickdisk
from grtrans_tpu_torch.fluid.base import toroidal_b
from grtrans_tpu_torch.fluid.harm import theta_of_x2
from grtrans_tpu_torch.geometry import kerr

A = 0.9375
GAM = 13.0 / 9.0


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def bl_flow(r, th, ph, a=A, seed=0, amp=0.3):
    """(u_bl, b_bl, rho) numpy arrays of the synthetic flow at the flat BL
    points (r, th, ph); ph=None for an axisymmetric flow."""
    r, th = _t(r), _t(th)
    g = kerr.metric_cov(r, th, a)
    om = 1.0 / (r ** 1.5 + a)
    z = torch.zeros_like(r)
    u0 = kerr.calc_u0(g, z, z, om)
    u_bl = torch.stack([u0, z, z, om * u0], dim=-1)
    plunge = (r < kerr.calc_rms(a)) | (u0 == 1.0)
    u_bl = torch.where(plunge[..., None], kerr.rms_vel(a, th, r), u_bl)
    b_bl = toroidal_b(g, u_bl, 1.0 / r)
    mode = 1.0 if ph is None else 1.0 + 0.3 * np.cos(2.0 * np.asarray(ph))
    noise = np.exp(amp * np.random.default_rng(seed).standard_normal(
        r.shape[0]))
    rho = np.exp(-((r.numpy() - 6.0) / 6.0) ** 2) * mode * noise + 1e-4
    return u_bl, b_bl, rho


def to_mks(v_bl, r, a, drdx1, dthdx1, dthdx2, dphdx3=1.0):
    """BL four-vector -> KS -> the code's MKS basis, numpy (n, 4)."""
    d = r * r - 2.0 * r + a * a
    v1 = v_bl[..., 1] / drdx1
    return torch.stack([v_bl[..., 0] + 2.0 * r / d * v_bl[..., 1], v1,
                        (v_bl[..., 2] - dthdx1 * v1) / dthdx2,
                        (v_bl[..., 3] + a / d * v_bl[..., 1]) / dphdx3],
                       dim=-1).numpy()


def _central(f, x, dx):
    return (f(x + 0.5 * dx) - f(x - 0.5 * dx)) / dx


def _mks_grid(nx1, nx2, nx3, a, rout=50.0):
    x1 = np.linspace(np.log(kerr.horizon(a) * 0.98), np.log(rout), nx1)
    x2 = np.linspace(0.01, 0.99, nx2)
    x3 = np.linspace(0.0, 2.0 * np.pi * (1.0 - 1.0 / nx3), nx3)
    return x1, x2, x3


def harm_dump(nx1=32, nx2=24, h=0.3, a=A, seed=0):
    """HARM 2-D dump dict (theta fastest)."""
    x1, x2, _ = _mks_grid(nx1, nx2, 1, a)
    X1, X2 = (v.ravel() for v in np.meshgrid(x1, x2, indexing="ij"))
    R, TH = np.exp(X1), theta_of_x2(X2, h)
    u, b, rho = bl_flow(R, TH, None, a, seed)
    r = _t(R)
    dth = _t(np.pi * (1.0 + (1.0 - h) * np.cos(2.0 * np.pi * X2)))
    return dict(tcur=0.0, nx1=nx1, nx2=nx2, a=a, gam=GAM, h=h, x1=X1, x2=X2,
                r=R, th=TH, rho=rho, p=0.1 * rho,
                u=to_mks(u, r, a, r, 0.0, dth), b=to_mks(b, r, a, r, 0.0, dth),
                gdet=np.ones_like(R))


def harm3d_dump(nx1=32, nx2=24, nx3=16, a=A, seed=0):
    """HARM3D dump dict (phi fastest; theta = pi x2)."""
    x1, x2, x3 = _mks_grid(nx1, nx2, nx3, a)
    X1, X2, X3 = (v.ravel() for v in np.meshgrid(x1, x2, x3, indexing="ij"))
    R, TH = np.exp(X1), np.pi * X2
    u, b, rho = bl_flow(R, TH, X3, a, seed)
    r = _t(R)
    return dict(tcur=0.0, nx1=nx1, nx2=nx2, nx3=nx3, a=a, gam=GAM, h=1.0,
                x1=X1, x2=X2, x3=X3, r=R, th=TH, ph=X3, rho=rho, p=0.1 * rho,
                u=to_mks(u, r, a, r, 0.0, math.pi),
                b=to_mks(b, r, a, r, 0.0, math.pi))


def iharm_dump(nx1=32, nx2=24, nx3=16, metric=0, a=A, seed=0, hslope=0.3):
    """IHARM dump dict: metric 0 is MKS(h), 1 the MMKS map; carries the
    electron entropy kela."""
    x1, x2, x3 = _mks_grid(nx1, nx2, nx3, a)
    X1, X2, X3 = (v.ravel() for v in np.meshgrid(x1, x2, x3, indexing="ij"))
    mm = (hslope, 0.5, 0.82, 14.0, float(x1[0]))
    if metric == 1:
        TH = iharm.calcth_mmks(X2, X1, *mm)
        d1, d2 = iharm._mmks_derivs(X2, X1, *mm)
    else:
        TH = iharm.calcth_mksh(X2, hslope)
        d1 = np.zeros_like(X2)
        d2 = np.pi * (1.0 + (1.0 - hslope) * np.cos(2.0 * np.pi * X2))
    R = np.exp(X1)
    u, b, rho = bl_flow(R, TH, X3, a, seed)
    r = _t(R)
    return dict(tcur=0.0, nx1=nx1, nx2=nx2, nx3=nx3, a=a, hslope=hslope,
                gam=GAM, mks_smooth=mm[1], poly_xt=mm[2], poly_alpha=mm[3],
                startx1=mm[4], metric=metric, eheat=1, x1=X1, x2=X2, x3=X3,
                rho=rho, p=0.1 * rho,
                u=to_mks(u, r, a, r, _t(d1), _t(d2)),
                b=to_mks(b, r, a, r, _t(d1), _t(d2)),
                kela=(rho * 0.01) ** (1.0 / 3.0))


def _jet_grid(nx1, nx2, nx3, rin=1.2, rout=50.0):
    """Cell-centred uniform grid of the McKinney codes: header values and
    the flat (x1 fastest) coordinates."""
    hd = dict(startx1=np.log(rin), startx2=0.0, startx3=0.0,
              dx1=(np.log(rout) - np.log(rin)) / nx1, dx2=1.0 / nx2,
              dx3=1.0 / nx3)
    u1 = hd["startx1"] + hd["dx1"] * (0.5 + np.arange(nx1))
    u2 = hd["startx2"] + hd["dx2"] * (0.5 + np.arange(nx2))
    u3 = hd["startx3"] + hd["dx3"] * (0.5 + np.arange(nx3))
    X3, X2, X1 = (v.ravel() for v in np.meshgrid(u3, u2, u1, indexing="ij"))
    return hd, X1, X2, X3


def thickdisk_dump(nx1=32, nx2=24, nx3=16, a=A, seed=0):
    """THICKDISK fieldline dump dict (x1 fastest)."""
    hd, X1, X2, X3 = _jet_grid(nx1, nx2, nx3)
    xbr = math.log(1e5)
    x1, x2 = _t(X1), _t(X2)
    r = thickdisk.calcrmks(x1, xbr)
    th = thickdisk.calcthmks6(x2, r)
    u, b, rho = bl_flow(r, th, 2.0 * np.pi * X3, a, seed)
    # the derivatives umks2ubl applies
    dx1 = 1e-4 * x1.abs().clamp_min(1e-2)
    dx2 = 1e-6 * x2.abs().clamp_min(1e-2)
    dr = 1e-4 * r
    drdx1 = _central(lambda v: thickdisk.calcrmks(v, xbr), x1, dx1)
    dthdx1 = _central(lambda v: thickdisk.calcthmks6(x2, v), r, dr) * drdx1
    dthdx2 = _central(lambda v: thickdisk.calcthmks6(v, r), x2, dx2)
    # the three-field B^i = b^i u^t - b^t u^i, whose b^mu the loader recovers
    B = b * u[..., :1] - b[..., :1] * u
    B[..., 0] = 0.0
    u_mks = to_mks(u, r, a, drdx1, dthdx1, dthdx2, 2.0 * math.pi)
    b_mks = to_mks(B, r, a, drdx1, dthdx1, dthdx2, 2.0 * math.pi)
    b_mks[:, 0] = 0.0
    h = dict(hd, tcur=0.0, nx1=nx1, nx2=nx2, nx3=nx3, gam=GAM, asim=a, r0=0.0,
             rin=1.2, rout=50.0, h=0.3, dt=1.0, defcoord=1401, dlen=11)
    return dict(h=h, rho=rho, uint=0.1 * rho / (GAM - 1.0), u=u_mks, b=b_mks)


def mb09_dump(nx1=32, nx2=24, nx3=16, a=A, seed=0):
    """MB09 dict(grid=..., data=..., a=...) (x1 fastest; BL components)."""
    _, X1, X2, X3 = _jet_grid(nx1, nx2, nx3)
    r = thickdisk.calcrmks(_t(X1), mb09.XBR_MB09)
    th = mb09.calcthmks9(_t(X2), r)
    u, b, rho = bl_flow(r, th, 2.0 * np.pi * X3, a, seed)
    v = (u[..., 1:] / u[..., :1]).numpy()
    return dict(a=a, grid=dict(nx1=nx1, nx2=nx2, nx3=nx3, x1=X1, x2=X2, x3=X3),
                data=dict(rho=rho, p=0.1 * rho, vr=v[:, 0], vth=v[:, 1],
                          vph=v[:, 2], b=b.numpy()))


KORAL_MKS3 = dict(r0=0.0, h=0.6, aa=0.005, bb=0.01, pp=1.5)


def koral_dump(nx1=48, nx2=24, nx3=1, nrelbin=0, a=A, seed=0):
    """KORAL dump dict: 2-D (theta fastest) for nx3 = 1, else 3-D (x2
    fastest, then x1, then x3); u, b are BL already."""
    m = KORAL_MKS3
    x1 = np.linspace(np.log(kerr.horizon(a) * 0.98 - m["r0"]),
                     np.log(90.0 - m["r0"]), nx1)
    x2 = np.linspace(0.02, 0.98, nx2)
    x3 = np.linspace(-np.pi, np.pi * (1.0 - 2.0 / nx3), nx3)
    X3, X1, X2 = (v.ravel() for v in np.meshgrid(x3, x1, x2, indexing="ij"))
    R = m["r0"] + np.exp(X1)
    TH = koral.theta_mks3(_t(X2), _t(R), m["h"], m["aa"], m["bb"],
                          m["pp"]).numpy()
    u, b, rho = bl_flow(R, TH, X3 if nx3 > 1 else None, a, seed)
    d = dict(tcur=0.0, nx1=nx1, nx2=nx2, nx3=nx3, a=a, **m, x1=X1, x2=X2,
             r=R, th=TH, rho=rho, u=u.numpy(), b=b.numpy(), te=3e11 / R,
             be=np.where(np.cos(TH) ** 2 > 0.5, 0.2, 0.001))
    if nx3 > 1:
        d.update(x3=X3, ph=X3)
    if nrelbin:
        d["nnth"] = np.stack([rho * 10.0 ** -(i + 2) for i in range(nrelbin)],
                             axis=-1)
    return d


def harmpi_header(nx1, nx2, nx3, bl, a=A, cyl=0.0):
    """The 61-field private header line (eHEAT = 1: kel4a-d present)."""
    rin = 0.87 * kerr.horizon(a)
    startx1 = math.log(rin)
    base37 = [0.0, nx1, nx2, nx3, nx1, nx2, nx3, 0, 0, 0, startx1, -1.0, 0.0,
              (math.log(50.0) - startx1) / nx1, 2.0 / nx2, 2 * math.pi / nx3,
              1e4, 0, a, GAM, 0.5, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0.01, 0, 0, rin,
              50.0, 0.3, 0.0]
    cylv = [cyl, 1.0, 1.0, 100.0, 4.0, 1.0, 5.0, -1 + 1.0 / 256, 0.25, 0.40,
            2 * rin, 5 * rin, 2 * rin, 1e3, 0.75, 0.0, rin]
    return " ".join(map(str, base37 + [3, 3, 1, 0, 0] + [0] + cylv
                        + [float(bl)]))


def harmpi_dump(nx1=32, nx2=24, nx3=12, bl=3, a=A, seed=0):
    """HARMPI full-dump dict on the BL = 1 (MKS) or BL = 3 (jetcoords)
    grid, with the four electron entropies."""
    hdr = harmpi.parse_harmpi_header(harmpi_header(nx1, nx2, nx3, bl, a))
    p3 = harmpi.bl3_params_from_header(dict(hdr))
    x1 = np.linspace(hdr["startx1"], math.log(50.0), nx1)
    x2 = np.linspace(-1 + 1.0 / nx2, 1 - 1.0 / nx2, nx2)
    x3 = np.linspace(0.0, 2 * np.pi * (1 - 1.0 / nx3), nx3)
    X1, X2, X3 = (v.ravel() for v in np.meshgrid(x1, x2, x3, indexing="ij"))
    x1t, x2t = _t(X1), _t(X2)
    r = harmpi.calcrmks(x1t, p3)
    if bl == 3:
        th = harmpi.calcthmksbl3(x2t, r, p3)
        dthdx2 = _central(lambda v: harmpi.calcthmksbl3(v, r, p3), x2t, 1e-6)
        dthdx1 = _central(lambda v: harmpi.calcthmksbl3(
            x2t, harmpi.calcrmks(v, p3), p3), x1t, 1e-4)
        drdx1 = harmpi.drdx1_mks(x1t, p3)
    else:
        th = harmpi.theta_mksh(x2t, 0.3)
        dthdx2 = math.pi / 2 * (1 + 0.7 * torch.cos(math.pi * (1 + x2t)))
        dthdx1 = 0.0
        drdx1 = r
    th = th.clamp(1e-4, math.pi - 1e-4)
    u, b, rho = bl_flow(r, th, X3, a, seed)
    kel = (rho * 0.01) ** (1.0 / 3.0)
    return dict(h=hdr, x1=X1, x2=X2, x3=X3, r=r.numpy(), th=th.numpy(), ph=X3,
                rho=rho, uint=0.1 * rho / (GAM - 1.0),
                u=to_mks(u, r, a, drdx1, dthdx1, dthdx2),
                b=to_mks(b, r, a, drdx1, dthdx1, dthdx2),
                kela=kel, kelb=1.1 * kel, kelc=1.2 * kel, keld=1.3 * kel)


# ---------------------------------------------------------------------------
# writers: each code's native layout, read back by the models' readers
# ---------------------------------------------------------------------------

def write_harm(d, dfile):
    """HARM ASCII: 26-number header line, 34 columns a zone."""
    n = d["nx1"] * d["nx2"]
    header = np.zeros(26)
    header[[0, 1, 2, 9, 10, 24]] = [d["tcur"], d["nx1"], d["nx2"], d["a"],
                                    d["gam"], d["h"]]
    data = np.zeros((n, 34))
    for c, k in enumerate(("x1", "x2", "r", "th", "rho", "p")):
        data[:, c] = d[k]
    data[:, 13:17], data[:, 21:25], data[:, 33] = d["u"], d["b"], d["gdet"]
    with open(dfile, "w") as f:
        f.write(" ".join(repr(float(v)) for v in header) + "\n")
        np.savetxt(f, data, fmt="%.17e")


def write_harm3d(d, dfile, hfile=None):
    """Chris White binary dump (float32, 35 values a zone) and its 15-number
    header file (default dfile + ".head")."""
    n = d["nx1"] * d["nx2"] * d["nx3"]
    data = np.zeros((n, 35), np.float32)
    for c, k in enumerate(("x1", "x2", "x3", "r", "th", "ph", "rho", "p")):
        data[:, 3 + c] = d[k]
    data[:, 18:22], data[:, 26:30] = d["u"], d["b"]
    with open(dfile, "wb") as f:
        f.write(b"synthetic harm3d\n")
        f.write(data.tobytes())
    x1, x2, x3 = d["x1"], d["x2"], d["x3"]
    s1, s2 = d["nx2"] * d["nx3"], d["nx3"]
    hd = [d["tcur"], d["nx1"], d["nx2"], d["nx3"], x1[0], x2[0], x3[0],
          x1[s1] - x1[0], x2[s2] - x2[0], x3[1] - x3[0], d["a"], d["gam"],
          0.0, d["h"], 0.0]
    with open(hfile or str(dfile) + ".head", "w") as f:
        f.write(" ".join(repr(float(v)) for v in hd))


def write_iharm(d, dfile, hfile=None):
    """Raw float32 stream of 14 values a zone and the ASCII header file."""
    n = d["nx1"] * d["nx2"] * d["nx3"]
    data = np.zeros((n, 14), np.float32)
    for c, k in enumerate(("x1", "x2", "x3", "rho", "p")):
        data[:, c] = d[k]
    data[:, 5:9], data[:, 9:13], data[:, 13] = d["u"], d["b"], d["kela"]
    data.tofile(dfile)
    hd = [d["tcur"], d["nx1"], d["nx2"], d["nx3"], d["a"], d["hslope"],
          d["gam"], d["mks_smooth"], d["poly_xt"], d["poly_alpha"],
          d["startx1"], d["metric"], 1, 0, 14, 1.2, 50.0]
    with open(hfile or str(dfile) + ".head", "w") as f:
        f.write(" ".join(repr(v) for v in hd))


def write_thickdisk(d, dfile):
    """Binary fieldline dump: 30-number header line, float32 data of dlen
    values a zone."""
    h = d["h"]
    hv = [h["tcur"], h["nx1"], h["nx2"], h["nx3"], h["startx1"],
          h["startx2"], h["startx3"], h["dx1"], h["dx2"], h["dx3"], 0.0,
          h["gam"], h["asim"], h["r0"], h["rin"], h["rout"], h["h"], h["dt"],
          h["defcoord"]] + [0.0] * 10 + [h["dlen"]]
    u0 = d["u"][:, 0]
    data = np.zeros((d["rho"].shape[0], h["dlen"]), np.float32)
    data[:, 0], data[:, 1], data[:, 4] = d["rho"], d["uint"], u0
    data[:, 5:8] = d["u"][:, 1:] / u0[:, None]
    data[:, 8:11] = d["b"][:, 1:]
    with open(dfile, "wb") as f:
        f.write((" ".join(repr(float(v)) for v in hv) + "\n").encode())
        f.write(data.tobytes())


def _fortran_record(f, arr):
    mark = np.array([arr.nbytes], np.int32).tobytes()
    f.write(mark + arr.tobytes() + mark)


def write_mb09(d, gfile, dfile):
    """Fortran sequential-unformatted grid and data files."""
    g, v = d["grid"], d["data"]
    with open(gfile, "wb") as f:
        _fortran_record(f, np.array([g["nx1"], g["nx2"], g["nx3"]], np.int32))
        for k in ("x1", "x2", "x3"):
            _fortran_record(f, np.asarray(g[k], np.float64))
    n = v["rho"].shape[0]
    blocks = [v["rho"], v["p"], v["vr"], v["vth"], v["vph"]] \
        + [v["b"][:, i] for i in range(4)]
    with open(dfile, "wb") as f:
        _fortran_record(f, np.array([9 * n], np.int32))
        _fortran_record(f, np.concatenate(blocks).astype(np.float32))


def write_koral(d, dfile, nrelbin=0):
    """Formatted KORAL dump, 2-D or 3-D "shortfile" columns."""
    n = d["rho"].shape[0]
    three = d["nx3"] > 1
    data = np.zeros((n, (22 if three else 42) + nrelbin))
    grid = ("x1", "x2", "x3", "r", "th", "ph") if three else \
        ("x1", "x2", "r", "th")
    for c, k in enumerate(grid):
        data[:, 3 + c] = d[k]
    data[:, 9], data[:, 11:15] = d["rho"], d["u"]
    if three:
        data[:, 15:19], data[:, 20], data[:, 21] = d["b"], d["te"], d["be"]
    else:
        data[:, 24:28], data[:, 32] = d["b"], d["te"]
    if nrelbin:
        data[:, -nrelbin:] = d["nnth"]
    hd = [d["tcur"], d["nx1"], d["nx2"]] + ([d["nx3"]] if three else []) \
        + [d["a"], 1.0, d["r0"], d["h"], d["aa"], d["bb"], d["pp"]]
    with open(dfile, "w") as f:
        f.write(" ".join(repr(float(v)) for v in hd) + "\n")
        if nrelbin:
            f.write(f"{nrelbin} 1.0 1.0\n")
        np.savetxt(f, data, fmt="%.17e")


def write_harmpi(d, dfile):
    """Full harmpi dump: the header line, float32 data of dlen values."""
    h = d["h"]
    n = d["rho"].shape[0]
    data = np.zeros((n, h["dlen"]), np.float32)
    for c, k in enumerate(("x1", "x2", "x3", "r", "th", "ph", "rho", "uint")):
        data[:, 3 + c] = d[k]
    for c, k in enumerate(harmpi.KEL):
        data[:, 17 + c] = d[k]
    vpos = 18 + int(h["DOKTOT"])
    data[:, vpos:vpos + 4], data[:, vpos + 8:vpos + 12] = d["u"], d["b"]
    with open(dfile, "wb") as f:
        f.write(harmpi_header(int(h["nx1"]), int(h["nx2"]), int(h["nx3"]),
                              int(h["BL"]), h["asim"]).encode() + b"\n")
        f.write(data.tobytes())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", choices=["harm", "harm3d", "iharm", "thickdisk",
                                      "koral", "koral3d", "harmpi"])
    ap.add_argument("dfile")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nx", type=int, nargs=3, default=(32, 24, 16))
    args = ap.parse_args()
    nx1, nx2, nx3 = args.nx
    if args.model == "harm":
        write_harm(harm_dump(nx1, nx2, seed=args.seed), args.dfile)
    elif args.model == "harm3d":
        write_harm3d(harm3d_dump(nx1, nx2, nx3, seed=args.seed), args.dfile)
    elif args.model == "iharm":
        write_iharm(iharm_dump(nx1, nx2, nx3, seed=args.seed), args.dfile)
    elif args.model == "thickdisk":
        write_thickdisk(thickdisk_dump(nx1, nx2, nx3, seed=args.seed),
                        args.dfile)
    elif args.model == "harmpi":
        write_harmpi(harmpi_dump(nx1, nx2, nx3, seed=args.seed), args.dfile)
    else:
        write_koral(koral_dump(nx1, nx2, nx3 if args.model == "koral3d" else 1,
                               seed=args.seed), args.dfile)


if __name__ == "__main__":
    main()
