"""FFJET: Broderick & Loeb (2009) force-free M87 jet from a binary
fluid-solution file.

Port of grtrans_tpu/fluid/ffjet.py with its default sampling conventions
(reference fluid_model_ffjet.f90 file layout :187-210, bilinear log-r x
theta interpolation with equatorial symmetry :41-178, and
convert_fluidvars_ffjet, fluid.f90:1164-1172)."""

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
from grtrans_tpu_torch.ops.quad_gather import quad_gather


def _read_fortran_records(path):
    """All sequential Fortran unformatted records (4-byte markers)."""
    with open(path, "rb") as f:
        data = f.read()
    recs = []
    off = 0
    while off < len(data):
        n = int(np.frombuffer(data, np.int32, 1, off)[0])
        recs.append(data[off + 4: off + 4 + n])
        off += 8 + n
    return recs


def load_ffjet_file(path):
    """Read an FFJET dump -> (grids, fields) numpy dicts, fields (th, r)
    with r fastest, float64."""
    recs = _read_fortran_records(path)
    hdr = recs[0]
    aa = np.frombuffer(hdr, np.float32, 1, 0)[0]
    # header 'nx' is the TOTAL grid size nx^2 (fluid_model_ffjet.f90:203)
    n = int(np.frombuffer(hdr, np.int32, 1, 4)[0])
    nx = int(round(np.sqrt(n)))
    r2 = np.frombuffer(recs[1], np.float32)
    rc, thc, rho = r2[:n], r2[n:2 * n], r2[2 * n:3 * n]
    r3 = np.frombuffer(recs[2], np.float32)
    # record: b(n) scratch, then b0, br, bth, bph
    b0, br, bth, bph = (r3[i * n:(i + 1) * n] for i in range(1, 5))
    r4 = np.frombuffer(recs[3], np.float32)
    u0, vr, vth, vph = (r4[i * n:(i + 1) * n] for i in range(4))
    grids = {"a": float(aa), "nx": nx,
             "uniqr": rc[:nx].astype(np.float64),
             "uniqth": thc[::nx][:nx].astype(np.float64)}
    fields = {k: v.reshape(nx, nx).astype(np.float64)
              for k, v in dict(rho=rho, b0=b0, br=br, bth=bth, bph=bph,
                               u0=u0, vr=vr, vth=vth, vph=vph).items()}
    return grids, fields


class FFJet(nn.Module):
    """The FFJET sampler.  Its state is the corner-packed quad table: row
    (i_th, i_r) holds the 2x2 cell's four corners x nine fields, so one
    bilinear sample is one row gather plus a 4-term combine (the
    quad_gather kernel)."""

    FIELDS = ("rho", "vr", "vth", "vph", "u0", "b0", "br", "bth", "bph")

    @obs.model_setup
    def __init__(self, grids, fields, ntscl=2.0, nrscl=70.0, *, device):
        super().__init__()
        self.ntscl = ntscl          # nonthermal density scale (sp nfac)
        self.nrscl = nrscl          # field scale (sp bfac)
        self.grid_a = grids["a"]
        self.nx = nx = grids["nx"]
        uniqr = np.asarray(grids["uniqr"], np.float64)
        uniqth = np.asarray(grids["uniqth"], np.float64)
        # the grid is uniform in log r and theta, so cells are located
        # arithmetically from its end points
        self.x1a, self.x1b = math.log(uniqr[0]), math.log(uniqr[-1])
        self.x2a, self.x2b = float(uniqth[0]), float(uniqth[-1])
        A = np.stack([np.asarray(fields[k], np.float64) for k in self.FIELDS],
                     axis=-1)                            # (nx, nx, 9)
        # edge rows are duplicated; cell indices are clipped to nx-2, so
        # the pad is never addressed
        A1 = np.concatenate([A[1:], A[-1:]], axis=0)            # i_th+1
        B0 = np.concatenate([A[:, 1:], A[:, -1:]], axis=1)      # i_r+1
        B1 = np.concatenate([A1[:, 1:], A1[:, -1:]], axis=1)
        quad = np.stack([A, B0, A1, B1], axis=2)                # (nx,nx,4,9)
        self.register_buffer("fquad", torch.as_tensor(
            quad.reshape(nx * nx, 4 * len(self.FIELDS)), device=device))
        # the table that float32 points (prec="mixed") sample: the float32
        # quad_gather kernel reads half the bytes
        self.register_buffer("fquad32", self.fquad.float())

    def vals(self, x, k, a):
        nx = self.nx
        r = x[..., 1]
        th = x[..., 2]
        x2 = torch.arccos(th.cos().abs())       # equatorial symmetry
        x1 = r.log()
        u1a, u1b, u2a, u2b = self.x1a, self.x1b, self.x2a, self.x2b
        # cell indices: truncate, then clip (NaN radii land on row 0)
        lx1 = trunc_clip((x1 - u1a) / (u1b - u1a) * (nx - 1), nx - 2)
        lx2 = trunc_clip((x2 - u2a) / (u2b - u2a) * (nx - 1), nx - 2)
        d1 = (u1b - u1a) / (nx - 1)
        d2 = (u2b - u2a) / (nx - 1)
        r0 = torch.exp(u1a + lx1.to(r.dtype) * d1)
        rd = (r - r0) / (r0 * math.expm1(d1))
        td = (x2 - (u2a + lx2.to(r.dtype) * d2)) / d2
        inside = x1 > u1a

        i00 = (lx2 * nx + lx1).reshape(-1)
        w = torch.stack([(1 - rd) * (1 - td), rd * (1 - td),
                         (1 - rd) * td, rd * td], dim=-1)
        table = self.fquad32 if r.dtype == torch.float32 else self.fquad
        vals = quad_gather(table, i00, w.reshape(-1, 4), 4, 9)
        vals = vals.reshape(r.shape + (9,))
        with obs.sync("ffjet.vals"):
            fill = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                                dtype=vals.dtype, device=vals.device)
        vals = torch.where(inside[..., None], vals, fill)
        rho, vrl, vtl, vpl, u0, b0, br, bth, bph = vals.unbind(-1)

        b = torch.stack([b0, br, bth, bph], dim=-1)
        bmag = kerr.safe_sqrt(fv.dot(kerr.metric_cov(r, th, a), b, b))
        vr_, vth_, om_ = kerr.lnrf_frame_inv(vrl, vtl, vpl, r, a, th)
        u = torch.stack([u0, u0 * vr_, u0 * vth_, u0 * om_], dim=-1)
        return FluidVars(rho=rho, p=torch.zeros_like(rho), bmag=bmag, u=u,
                         b=b, rho2=rho)

    def convert(self, fv_, sp):
        z = torch.zeros_like(fv_.rho)
        return EmisInputs(ncgs=z, tcgs=z, bcgs=fv_.bmag * self.nrscl,
                          ncgsnth=fv_.rho * self.ntscl)


@base.register("FFJET")
def load(dfile, ntscl=2.0, nrscl=70.0, ref_conventions=False, *, device):
    """FFJET model from the dump at `dfile` on `device`.  grtrans_tpu's
    ref_conventions ablation (the reference's float32 grids) is not
    ported."""
    if ref_conventions:
        raise NotImplementedError("FFJET ref_conventions is not ported")
    grids, fields = load_ffjet_file(dfile)
    return FFJet(grids, fields, ntscl=ntscl, nrscl=nrscl, device=device)
