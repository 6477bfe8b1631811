"""KORAL radiative-GRMHD snapshot fluid models (2-D and 3-D) with the
jet / disk region variants and optional nonthermal electron bins.

Port of grtrans_tpu/fluid/koral.py (reference fluid_model_koral.f90 /
fluid_model_koral3d.f90 and fluid.f90 convert_fluidvars_koral
:1075-1162):

 * MKS3 coordinates: x1 = ln(r - r0) and an r-dependent polar map
   theta(x2, r) (transformmksh32bl, fluid_model_koral.f90:74-82) with the
   closed-form inverse x2(theta, r) (transformbl2mksh3, :64-71).
 * Dumps are formatted ASCII: header line (10 numbers 2-D / 11 numbers
   3-D: tcur, nx1, nx2[, nx3], asim, mbh, r0, h, aa, bb, pp), an optional
   second header line when nonthermal bins are present, then
   nx1*nx2[*nx3] rows.  1-based columns: 2-D grid(x1,x2,r,th)@4, rho@10,
   u^mu(BL)@12, b^mu(BL)@25, Te@33, bins@43; 3-D short:
   grid(x1,x2,x3,r,th,ph)@4, rho@10, u@12, b@16, Te@21, Ti@22, bins@23.
   u and b are BL four-vectors already.
 * Velocities are stored as LNRF components; rho and b scale with
   `scalefac` (rho sf, b sqrt(sf), bins sf; load_koral_data :516-530).
 * Sampling (koral_vals :84-286, koral3d_vals :83-346): bilinear /
   trilinear with the theta fraction measured in physical theta at the
   lower-r grid column, periodic phi on the raw BL azimuth wrapped to
   (-pi, pi], nearest neighbour + (3-D) 1e-3 damping inside the innermost
   zone, polar trust cuts of `minpolecell` cells, and region theta cuts for
   the DISK / TOPJET / BOTJET variants (koral3d :283-296).
 * Units (convert_fluidvars_koral): n = rho / mp, b_cgs = |b| sqrt(4 pi)
   sqrt(nfac), electron temperature straight from the dump (gmin < 1) or
   the charles_e prescription; Be >= 0.05 selects the jet.  sigma is
   b^2 / (4 pi rho c^2), as grtrans_tpu computes it.

The 2-D model samples its corner-packed table with quad_gather (4 corners
x 11 fields), the 3-D model its phi-pair-packed table with
quad_gather_rows (4 rows x 2 x 11); the nonthermal bins are a second
quad_gather_rows launch on the plain (zones, nrelbin) table, 4 rows a
sample in 2-D and 8 in 3-D.
"""

import math

import numpy as np
import torch
from torch import nn

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch import obs
from grtrans_tpu_torch.fluid import base
from grtrans_tpu_torch.fluid.base import EmisInputs, FluidVars
from grtrans_tpu_torch.fluid.grmhd3d import phi_pair_pack, trilinear_rows
from grtrans_tpu_torch.fluid.harm import f64, four_vectors
from grtrans_tpu_torch.geometry import kerr
from grtrans_tpu_torch.ops.intcast import to_int32, trunc_clip
from grtrans_tpu_torch.ops.quad_gather import (bilinear_packed,
                                               pack_corners_2d,
                                               quad_gather_rows)

KFIELDS = ("rho", "te", "be", "u0", "vrl", "vtl", "vpl", "b0", "br", "bth",
           "bph")


def theta_mks3(x2, r, h, aa, bb, pp):
    """MKS3 x2 -> BL theta at radius r (transformmksh32bl)."""
    return 0.5 * math.pi * (
        1.0 + torch.tan(h * math.pi * (-0.5 + x2 + (1.0 - 2.0 * x2)
                                       * (aa + 2.0 ** pp * (bb - aa)
                                          / r ** pp)))
        / math.tan(0.5 * h * math.pi))


def x2_mks3(th, r, h, aa, bb, pp):
    """BL theta -> MKS3 x2 at radius r (transformbl2mksh3)."""
    return 0.5 * (1.0 + (r ** pp / (h * math.pi))
                  * (torch.arctan(math.tan(0.5 * h * math.pi)
                                  * (1.0 - 2.0 * th / math.pi))
                     / ((bb - aa) * 2.0 ** pp + (aa - 0.5) * r ** pp)))


def relel_bins(gmin, gmax, nbin):
    """Log-spaced Lorentz-factor bin centres and widths, numpy (emis.f90
    emis_model_bins :885-908)."""
    logsp = (np.log(gmax) - np.log(gmin)) / nbin
    edges = gmin * np.exp(logsp * np.arange(nbin + 1))
    edges[-1] = gmax
    centers = np.exp(np.log(gmin) + logsp * (0.5 + np.arange(nbin)))
    return centers, edges[1:] - edges[:-1]


def read_koral_dump(dfile, hfile=None, ndim=2, nrelbin=0):
    """Parse one formatted KORAL dump into a dict of numpy arrays."""
    with open(hfile or dfile) as f:
        header = np.array(f.readline().split(), dtype=float)
    if ndim == 2:
        (tcur, nx1, nx2, asim, _mbh, r0, h, aa, bb, ppc) = header[:10]
        nx3 = 1
    else:
        (tcur, nx1, nx2, nx3, asim, _mbh, r0, h, aa, bb, ppc) = header[:11]
    data = np.loadtxt(dfile, skiprows=2 if nrelbin > 0 else 1)
    nx1, nx2, nx3 = int(nx1), int(nx2), int(nx3)
    if data.shape[0] != nx1 * nx2 * nx3:
        raise ValueError(f"{dfile}: {data.shape[0]} rows for a {nx1} x {nx2} "
                         f"x {nx3} grid")
    out = dict(tcur=tcur, nx1=nx1, nx2=nx2, nx3=nx3, a=asim, r0=r0, h=h,
               aa=aa, bb=bb, pp=ppc)
    if ndim == 2:
        out.update(x1=data[:, 3], x2=data[:, 4], r=data[:, 5],
                   th=data[:, 6], rho=data[:, 9], u=data[:, 11:15],
                   b=data[:, 24:28], te=data[:, 32], be=np.zeros(nx1 * nx2))
        if nrelbin > 0:
            out["nnth"] = data[:, 42:42 + nrelbin]
    else:
        # 3-D "shortfile" layout; the Be column stores the ion temperature
        out.update(x1=data[:, 3], x2=data[:, 4], x3=data[:, 5],
                   r=data[:, 6], th=data[:, 7], ph=data[:, 8],
                   rho=data[:, 9], u=data[:, 11:15], b=data[:, 15:19],
                   te=data[:, 20], be=data[:, 21])
        if nrelbin > 0:
            out["nnth"] = data[:, 22:22 + nrelbin]
    return out


def _lnrf_store(d, scalefac):
    """BL u, b -> (zones, 11) columns in KFIELDS order: u0, LNRF v and the
    scaled primitives (load_koral_data)."""
    u, b = f64(d["u"]), f64(d["b"])
    r, th = f64(d["r"]), f64(d["th"])
    vrl, vtl, vpl = kerr.lnrf_frame(u[:, 1] / u[:, 0], u[:, 2] / u[:, 0],
                                    u[:, 3] / u[:, 0], r, float(d["a"]), th)
    sb = math.sqrt(scalefac)
    return torch.stack([f64(d["rho"]) * scalefac, f64(d["te"]), f64(d["be"]),
                        u[:, 0], vrl, vtl, vpl, b[:, 0] * sb, b[:, 1] * sb,
                        b[:, 2] * sb, b[:, 3] * sb], dim=-1)


class _KoralBase(nn.Module):
    """Shared state, cell search and convert of the KORAL family."""
    region = 0          # 0 all, 1 disk, 2 top jet, 3 bottom jet
    minpolecell = 4

    def _init_common(self, d, scalefac, nrelbin, relgammamin, relgammamax,
                     device):
        self.asim = float(d["a"])
        self.r0 = float(d["r0"])
        self.mks3 = (float(d["h"]), float(d["aa"]), float(d["bb"]),
                     float(d["pp"]))
        self.nx1 = int(d["nx1"])
        self.nx2 = int(d["nx2"])
        self.nrelbin = int(nrelbin)
        if nrelbin > 0:
            gammas, dgammas = relel_bins(relgammamin, relgammamax, nrelbin)
            self.register_buffer("gammas", f64(gammas).to(device))
            self.register_buffer("dgammas", f64(dgammas).to(device))
            # plain (zones, nrelbin) table in the dump's own zone order
            self.register_buffer("fn", (f64(d["nnth"]) * scalefac)
                                 .contiguous().to(device))
        else:
            self.fn = None

    def _cell_rt(self, r, th, a):
        """(x1, x2, lx1, lx2, rd, td, inner, trusted) of the (r, theta)
        cell search both models share."""
        nx1, nx2 = self.nx1, self.nx2
        x1 = (r - self.r0).clamp_min(1e-12).log()
        x2 = x2_mks3(th, r, *self.mks3)
        u1a, u1b = self.uniqx1[0], self.uniqx1[-1]
        u2a, u2b = self.uniqx2[0], self.uniqx2[-1]
        lx1 = trunc_clip((x1 - u1a) / (u1b - u1a) * (nx1 - 1), nx1 - 2)
        lx2 = trunc_clip((x2 - u2a) / (u2b - u2a) * (nx2 - 1), nx2 - 2)
        i1, i2 = lx1.long(), lx2.long()
        # r-dependent theta grid: bounds at the lower-r column
        # (koral_vals:153-166)
        rl = self.uniqr[i1]
        rd = (r - rl) / (self.uniqr[i1 + 1] - rl)
        thl = theta_mks3(self.uniqx2[i2], rl, *self.mks3)
        thu = theta_mks3(self.uniqx2[i2 + 1], rl, *self.mks3)
        td = ((th - thl) / (thu - thl)).abs().clamp(0.0, 1.0)
        inner = (rl <= kerr.horizon(a)) | (lx1 == 0)
        rd = torch.where(inner, 1.0, rd.clamp(0.0, 1.0))
        trusted = (x1 > u1a) & (x2 > self.uniqx2[self.minpolecell - 1]) \
            & (x2 < self.uniqx2[nx2 - self.minpolecell])
        return lx1, lx2, rd, td, inner, trusted

    def _sample_bins(self, idxs, ws, shape):
        """Nonthermal bins: R rows of the plain table a sample."""
        idx = torch.stack(idxs, dim=-1).reshape(-1, len(idxs))
        w = torch.stack(ws, dim=-1).reshape(-1, len(idxs), 1)
        out = quad_gather_rows(self.fn, idx.contiguous(),
                               w.to(self.fn.dtype).contiguous(), 1,
                               self.nrelbin)
        return out.reshape(shape + (self.nrelbin,))

    def _assemble(self, col, nbins, trusted, damp, r, th, a):
        out = ~trusted
        rho = torch.where(out, 0.0, col["rho"])
        te = torch.where(out, 1.0, col["te"])
        if damp is not None:
            rho, te = rho * damp, te * damp
        be = torch.where(out, 0.0, col["be"])
        u, b, bmag = four_vectors(col, out, r, th, a)
        if nbins is not None:
            nbins = torch.where(out[..., None], 0.0, nbins)
        return FluidVars(rho=rho, p=te, bmag=bmag, u=u, b=b, rho2=rho,
                         nbins=nbins, be=be)

    def convert(self, fv_, sp):
        """convert_fluidvars_koral (fluid.f90:1075-1162)."""
        rhocgs = fv_.rho * sp.nfac
        ncgs = rhocgs / pc.mp
        bcgs = fv_.bmag * math.sqrt(4.0 * math.pi) * math.sqrt(sp.nfac)
        if sp.gmin >= 1.0:
            tempcgs = base.charles_e(fv_.rho, fv_.p + fv_.be,
                                     2.0 * fv_.p + fv_.be, fv_.bmag, 1.0,
                                     sp.gmin)
        else:
            tempcgs = fv_.p           # the dump stores T_e directly
        rhocgs, ncgs, tempcgs = base.sigma_cut(bcgs, rhocgs, tempcgs, ncgs,
                                               sp.sigcut)
        sigma = bcgs * bcgs / (rhocgs * pc.c2 * 4.0 * math.pi).clamp_min(
            1e-37)
        if self.region == 1:       # disk: zero the Be >= 0.05 jet
            cut = fv_.be >= 0.05
        elif self.region in (2, 3):  # jets: zero the bound disk
            cut = (fv_.be <= 0.05) & (sigma <= 1.0)
        else:
            cut = torch.zeros_like(fv_.rho, dtype=torch.bool)
        ncgs = torch.where(cut, 0.0, ncgs)
        tempcgs = torch.where(cut, 10.0, tempcgs)
        bcgs = torch.where(cut, 0.0, bcgs)
        ei = EmisInputs(ncgs=ncgs, tcgs=tempcgs, bcgs=bcgs,
                        ncgsnth=torch.zeros_like(ncgs))
        if fv_.nbins is None:
            return ei
        nbins = torch.where(cut[..., None], 0.0, fv_.nbins * sp.nfac)
        return ei._replace(nbins=nbins, gammas=self.gammas,
                           dgammas=self.dgammas)


@base.register("KORAL")
@base.register("KORALNTH")
class Koral(_KoralBase):
    """2-D (axisymmetric) KORAL snapshot (fluid_model_koral.f90).  fargs:
    dfile (and hfile) or dump= the dict of `read_koral_dump`; scalefac;
    nrelbin, relgammamin, relgammamax for dumps with nonthermal bins."""

    @obs.model_setup
    def __init__(self, dfile="", hfile=None, scalefac=1.0, nrelbin=0,
                 relgammamin=1.0, relgammamax=1.0, dump=None, *, device):
        super().__init__()
        d = dump if dump is not None else read_koral_dump(
            dfile, hfile, ndim=2, nrelbin=nrelbin)
        self._init_common(d, scalefac, nrelbin, relgammamin, relgammamax,
                          device)
        nx1, nx2 = self.nx1, self.nx2
        # theta fastest-changing (koral_vals:115-117)
        uniqx1 = f64(d["x1"]).reshape(nx1, nx2)[:, 0]
        uniqx2 = f64(d["x2"]).reshape(nx1, nx2)[0, :]
        grid = _lnrf_store(d, scalefac).reshape(nx1, nx2, len(KFIELDS))
        quad = torch.from_numpy(pack_corners_2d(grid.numpy()))
        for name, t in (("uniqx1", uniqx1), ("uniqx2", uniqx2),
                        ("uniqr", self.r0 + uniqx1.exp()), ("fquad", quad)):
            self.register_buffer(name, t.contiguous().to(device))

    def vals(self, x, k, a):
        nx2 = self.nx2
        r = x[..., 1]
        th = x[..., 2]
        lx1, lx2, rd, td, _, trusted = self._cell_rt(r, th, a)
        cols = bilinear_packed(self.fquad, nx2, len(KFIELDS), lx1, lx2, rd,
                               td)
        nbins = None
        if self.fn is not None:
            i00 = lx1 * nx2 + lx2
            nbins = self._sample_bins(
                [i00, i00 + nx2, i00 + 1, i00 + nx2 + 1],
                [(1 - rd) * (1 - td), rd * (1 - td), (1 - rd) * td, rd * td],
                r.shape)
        return self._assemble(dict(zip(KFIELDS, cols.unbind(-1))), nbins,
                              trusted, None, r, th, a)


@base.register("KORAL3D")
class Koral3D(_KoralBase):
    """3-D KORAL snapshot and, with region = 1, 2, 3, its DISK / TOPJET /
    BOTJET variants (fluid_model_koral3d.f90; masks koral3d_vals:283-310
    and the type branches of convert_fluidvars_koral).  fargs as Koral."""

    @obs.model_setup
    def __init__(self, dfile="", hfile=None, scalefac=1.0, nrelbin=0,
                 relgammamin=1.0, relgammamax=1.0, region=None, dump=None, *,
                 device):
        super().__init__()
        d = dump if dump is not None else read_koral_dump(
            dfile, hfile, ndim=3, nrelbin=nrelbin)
        self._init_common(d, scalefac, nrelbin, relgammamin, relgammamax,
                          device)
        if region is not None:
            self.region = region
        self.nx3 = nx3 = int(d["nx3"])
        nx1, nx2 = self.nx1, self.nx2
        # x2 fastest, then x1, then x3 (koral3d_vals:113-117)
        shape = (nx3, nx1, nx2)
        uniqx1 = f64(d["x1"]).reshape(shape)[0, :, 0]
        st = _lnrf_store(d, scalefac).reshape(shape + (len(KFIELDS),))
        for name, t in (("uniqx1", uniqx1),
                        ("uniqx2", f64(d["x2"]).reshape(shape)[0, 0, :]),
                        ("uniqx3", f64(d["x3"]).reshape(shape)[:, 0, 0]),
                        ("uniqr", self.r0 + uniqx1.exp()),
                        ("fpair", phi_pair_pack(st, 0))):
            self.register_buffer(name, t.contiguous().to(device))

    def vals(self, x, k, a):
        nx1, nx2, nx3 = self.nx1, self.nx2, self.nx3
        r = x[..., 1]
        th = x[..., 2]
        # raw BL azimuth wrapped to (-pi, pi] (koral3d_vals:131-140)
        zphi = torch.remainder(x[..., 3], 2.0 * math.pi)
        zphi = torch.where(zphi < 0.0, zphi + 2.0 * math.pi, zphi)
        zphi = torch.where(zphi > math.pi, zphi - 2.0 * math.pi, zphi)
        lx1, lx2, rd, td, inner, trusted = self._cell_rt(r, th, a)
        u3a = self.uniqx3[0]
        dph = self.uniqx3[1] - u3a
        lx3raw = to_int32(torch.floor((zphi - u3a) / dph))
        lx3 = torch.remainder(lx3raw, nx3)
        ux3 = torch.remainder(lx3raw + 1, nx3)
        pd = ((zphi - (u3a + lx3raw * dph)) / dph).clamp(0.0, 1.0)
        damp = torch.ones_like(r).masked_fill(inner, 1e-3)
        # region theta cuts (koral3d_vals:283-296)
        if self.region == 1:
            trusted = trusted & (th > 0.25) & (th < math.pi - 0.25)
        elif self.region == 2:
            trusted = trusted & (th < 0.5 * math.pi)
        elif self.region == 3:
            trusted = trusted & (th > 0.5 * math.pi)

        ws = [(1 - rd) * (1 - td), (1 - rd) * td, rd * (1 - td), rd * td]
        cell = lx1 * nx2 + lx2
        offs = (0, 1, nx2, nx2 + 1)
        lo = lx3 * (nx1 * nx2) + cell
        cols = trilinear_rows(self.fpair, [lo + o for o in offs], ws, pd,
                              len(KFIELDS))
        nbins = None
        if self.fn is not None:
            hi = ux3 * (nx1 * nx2) + cell
            nbins = self._sample_bins(
                [lo + o for o in offs] + [hi + o for o in offs],
                [w * (1 - pd) for w in ws] + [w * pd for w in ws], r.shape)
        return self._assemble(dict(zip(KFIELDS, cols.unbind(-1))), nbins,
                              trusted, damp, r, th, a)


def _variant(name, region_id):
    def load(*, device, **fargs):
        return Koral3D(**{"region": region_id, **fargs}, device=device)
    load.__doc__ = f"KORAL3D restricted to region {region_id} ({name})."
    load.__wrapped__ = Koral3D          # the fargs it takes
    return base.register(name)(load)


load_koral3d_disk = _variant("KORAL3D_DISK", 1)
load_koral3d_topjet = _variant("KORAL3D_TOPJET", 2)
load_koral3d_botjet = _variant("KORAL3D_BOTJET", 3)
# grtrans_tpu's names of the regions (its classes; here the loaders)
Koral3DDisk = load_koral3d_disk
Koral3DTopJet = load_koral3d_topjet
Koral3DBotJet = load_koral3d_botjet
