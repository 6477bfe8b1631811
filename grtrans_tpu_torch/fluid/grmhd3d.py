"""Shared machinery of the 3-D GRMHD snapshot fluid models on an
(nt, nx1, nx2, nx3) lattice with phi fastest (HARM3D, IHARM).

Port of grtrans_tpu/fluid/grmhd3d.py (reference fluid_model_harm3d.f90
harm3d_vals :107-330 and its clones):

 * grid-aligned storage of (rho, p, u0, LNRF velocities, b^mu), velocities
   as LNRF components so that interpolation stays subluminal;
 * BL -> KS azimuth and mod-2pi wrap before lookup (:156-161);
 * trilinear interpolation with fractional distances measured in the
   physical coordinates (r, theta, phi) while indices live on the
   (possibly stretched) simulation grid (:169-207), periodic in phi;
 * nearest neighbour + 1e-6 damping of p, n, b inside the innermost zone
   outside the horizon (:209-218);
 * a linear blend between two time slices for slow light (:229-254);
 * four-vector reconstruction LNRF -> BL (:297-305) and
   bmag = sqrt(max(b.b, 0)) (:293-295).

The lookup is one launch of quad_gather_rows on the phi-pair-packed table
(NS rows of 2 x nf: a zone and its phi + 1 neighbour): 4 rows a sample,
8 with the two time slices, whose blend is folded into the weights.
"""

import math

import torch
from torch import nn

from grtrans_tpu_torch.fluid.base import FluidVars
from grtrans_tpu_torch.fluid.harm import four_vectors, x2_of_theta
from grtrans_tpu_torch.geometry import kerr
from grtrans_tpu_torch.ops.intcast import to_int32, trunc_clip
from grtrans_tpu_torch.ops.quad_gather import quad_gather_rows

FIELDS = ("rho", "p", "u0", "vrl", "vtl", "vpl", "b0", "br", "bth", "bph")


def to_lnrf_storage(u_bl, b_bl, r, th, a):
    """BL four-vectors u^mu, b^mu (..., 4) -> the stored layout: u0, the
    LNRF velocities vrl, vtl, vpl and b^mu (init_harm3d_data); rho and p
    are None, for the caller to fill."""
    u0 = u_bl[..., 0]
    vrl, vtl, vpl = kerr.lnrf_frame(u_bl[..., 1] / u0, u_bl[..., 2] / u0,
                                    u_bl[..., 3] / u0, r, a, th)
    return {"rho": None, "p": None, "u0": u0, "vrl": vrl, "vtl": vtl,
            "vpl": vpl, "b0": b_bl[..., 0], "br": b_bl[..., 1],
            "bth": b_bl[..., 2], "bph": b_bl[..., 3]}


def phi_pair_pack(st, phi_axis):
    """(..., nf) field stack -> (rows, 2 nf): every zone followed by its
    phi + 1 neighbour (periodic wrap), so that a trilinear sample needs 4
    rows of 2 nf contiguous values instead of 8 of nf."""
    nf = st.shape[-1]
    return torch.cat([st, torch.roll(st, -1, dims=phi_axis)],
                     dim=-1).reshape(-1, 2 * nf)


def trilinear_rows(table, idxs, ws, pd, nf):
    """One quad_gather_rows launch for a trilinear sample of a
    phi-pair-packed table: idxs and ws are the R row indices (int32) and
    corner weights of each sample, pd the phi fraction.  Returns
    pd.shape + (nf,)."""
    idx = torch.stack(idxs, dim=-1).reshape(-1, len(idxs))
    wr = torch.stack(ws, dim=-1)
    w = torch.stack([wr * (1 - pd)[..., None], wr * pd[..., None]], dim=-1)
    out = quad_gather_rows(table, idx.contiguous(),
                           w.reshape(-1, len(idxs), 2).contiguous(), 2, nf)
    return out.reshape(pd.shape + (nf,))


class Grmhd3D(nn.Module):
    """vals() for (nt, nx1, nx2, nx3) gridded data.  Subclasses set asim,
    h, call `_set_grid` and `_store`, and may override `x123_of_blks` for
    their coordinate maps."""

    nt_slices = 1
    tstep = 1.0
    toffset = 0.0          # simulation time of slice 0
    # theta-fraction space: physical theta (harm3d_vals:189-207) or
    # simulation x2 (needed when theta(x2) also depends on x1: MMKS)
    interp_td_in_x2 = False

    def x123_of_blks(self, r, th, ph):
        """MKS(h) map: x1 = ln r, x2 = x2(theta), x3 = phi
        (transformbl2mksh, fluid_model_harm3d.f90:68-80)."""
        return r.log(), x2_of_theta(th, self.h), ph

    def _set_grid(self, device, **coords):
        """Register the 1-D coordinate arrays uniqx1/2/3, uniqr, uniqth
        (float64 CPU tensors) on `device`."""
        self.device = torch.device(device)
        for name, t in coords.items():
            self.register_buffer(name, t.contiguous().to(device))

    def _store(self, arrs):
        """Per-field (nx1, nx2, nx3) arrays -> slice 0 of the buffer."""
        self.f = {k: torch.as_tensor(arrs[k], dtype=torch.float64)[None]
                  .to(self.device) for k in FIELDS}
        self.extra3 = {}
        self.nt_slices = 1
        self._fstack_key = None

    def append_slice(self, arrs):
        """Push a later time slice (advance_harm3d_timestep /
        load_harm3d_data, :612-680)."""
        for k in FIELDS:
            new = torch.as_tensor(arrs[k], dtype=torch.float64)[None]
            self.f[k] = torch.cat([self.f[k], new.to(self.device)], dim=0)
        self.nt_slices = int(self.f["rho"].shape[0])
        self._fstack_key = None

    def _stacked_fields(self, dtype=torch.float64):
        """All FIELDS + extra3 grids stacked minor-most, phi-pair packed
        and flattened to (nt * nx1*nx2*nx3, 2 nf).  Cached; invalidated by
        _store / append_slice."""
        names = list(FIELDS) + sorted(self.extra3)
        nt = self.nt_slices
        key = (nt, tuple(names), dtype)
        if self._fstack_key != key:
            arrs = []
            for n in names:
                g = self.f[n] if n in self.f else self.extra3[n]
                g = g if g.dim() == 4 else g[None]
                # a static extra field on a time series
                arrs.append(g.expand(nt, *g.shape[1:]))
            st = torch.stack(arrs, dim=-1)             # (nt, n1, n2, n3, nf)
            self._fstack = phi_pair_pack(st, 3).to(dtype).contiguous()
            self._fstack_key = key
        return self._fstack, names

    def _query(self, x, a, time=0.0):
        """Per-sample interpolation geometry: grid indices, corner
        weights, time blend, innermost-zone damping: everything but the
        gather."""
        nx1 = self.uniqx1.shape[0]
        nx2 = self.uniqx2.shape[0]
        nx3 = self.uniqx3.shape[0]
        r = x[..., 1]
        th = x[..., 2]
        # BL -> KS azimuth, wrapped to [0, 2 pi) (harm3d_vals:156-161)
        zphi = torch.remainder(kerr.bl2ks_phi(r, x[..., 3], a), 2.0 * math.pi)
        zphi = torch.where(zphi < 0.0, zphi + 2.0 * math.pi, zphi)
        x1, x2, x3 = self.x123_of_blks(r, th, zphi)

        u1a, u1b = self.uniqx1[0], self.uniqx1[-1]
        u2a, u2b = self.uniqx2[0], self.uniqx2[-1]
        u3a, u3b = self.uniqx3[0], self.uniqx3[-1]
        lx1 = trunc_clip((x1 - u1a) / (u1b - u1a) * (nx1 - 1), nx1 - 2)
        lx2 = trunc_clip((x2 - u2a) / (u2b - u2a) * (nx2 - 1), nx2 - 2)
        # phi periodic: the lower index may wrap below 0 or above nx3 - 1
        dph = (u3b - u3a) / max(nx3 - 1, 1)
        lx3raw = to_int32(torch.floor((x3 - u3a) / dph))
        lx3 = torch.remainder(lx3raw, nx3)
        minph = u3a + lx3raw * dph          # unwrapped cell-left phi

        # fractional distances in physical coordinates (:189-207)
        i1, i2 = lx1.long(), lx2.long()
        r_lo = self.uniqr[i1]
        rd = (r - r_lo) / (self.uniqr[i1 + 1] - r_lo)
        if self.interp_td_in_x2:
            x2_lo = self.uniqx2[i2]
            td = (x2 - x2_lo) / (self.uniqx2[i2 + 1] - x2_lo)
        else:
            th_lo = self.uniqth[i2]
            td = (th - th_lo).abs() / (self.uniqth[i2 + 1] - th_lo)
        pd = (x3 - minph) / dph

        # innermost-zone handling (:209-218)
        inner = r_lo <= torch.clamp(self.uniqr[0], min=kerr.horizon(a))
        rd = torch.where(inner, 1.0, rd.clamp(0.0, 1.0))
        damp = torch.ones_like(r).masked_fill(inner, 1e-6)
        td = td.clamp(0.0, 1.0)
        pd = pd.clamp(0.0, 1.0)
        outside = x1 <= u1a

        # time-slice blend (slow light, harm_vals:136-197 + :229-254).
        # Slices are ordered forward in simulation time: slice k holds the
        # dump at t_sim = toffset + k * tstep.  The sample's KS time (<= 0:
        # the trace lies in the observer's past, zeroed at the ray's own
        # first point) plus the camera epoch `time` selects the bracketing
        # pair; with one slice the blend is the identity.
        if self.nt_slices > 1:
            r0 = r[..., :1]
            tks = (kerr.bl2ks_time(r, x[..., 0], a)
                   - kerr.bl2ks_time(r0, 0.0 * r0, a))
            s = (time - self.toffset + tks) / self.tstep
            tind = trunc_clip(s, self.nt_slices - 2)
            ttd = (s - tind).clamp(0.0, 1.0)
        else:
            tind = ttd = None

        ws = ((1 - rd) * (1 - td), (1 - rd) * td, rd * (1 - td), rd * td)
        return dict(r=r, th=th, lx1=lx1, lx2=lx2, lx3=lx3, ws=ws, pdc=pd,
                    tind=tind, ttd=ttd, damp=damp, outside=outside)

    def _gather_cols(self, table, NS, nx2, nx3, q, nf):
        """The trilinear sample of every field: one quad_gather_rows launch
        of 4 rows a sample (8 with the time blend) on the (nt * NS, 2 nf)
        table."""
        lx1, lx2, lx3 = q["lx1"], q["lx2"], q["lx3"]
        lo = (lx1 * nx2 + lx2) * nx3 + lx3
        hi = ((lx1 + 1) * nx2 + lx2) * nx3 + lx3
        idxs = [lo, lo + nx3, hi, hi + nx3]
        ws = list(q["ws"])
        if q["tind"] is not None:
            off, ttd = q["tind"] * NS, q["ttd"]
            idxs = [off + i for i in idxs] + [off + NS + i for i in idxs]
            ws = [w * (1 - ttd) for w in ws] + [w * ttd for w in ws]
        return trilinear_rows(table, idxs, ws, q["pdc"], nf)

    def vals(self, x, k, a, time=0.0):
        nx2 = self.uniqx2.shape[0]
        nx3 = self.uniqx3.shape[0]
        q = self._query(x, a, time=time)
        table, names = self._stacked_fields(q["r"].dtype)
        NS = table.shape[0] // self.nt_slices
        vals = self._gather_cols(table, NS, nx2, nx3, q, len(names))
        return self._assemble(vals, names, q, a)

    def _assemble(self, vals, names, q, a):
        """Columns + query geometry -> FluidVars (LNRF -> BL, innermost-zone
        damping, outside-grid defaults).  Extra columns travel in the
        result: kela by name, any other in `extra`."""
        r, th = q["r"], q["th"]
        damp, outside = q["damp"], q["outside"]
        col = dict(zip(names, vals.unbind(-1)))
        u, b, bmag = four_vectors(col, outside, r, th, a)
        rho = torch.where(outside, 0.0, col["rho"] * damp)
        p = torch.where(outside, 1e-18, col["p"] * damp)
        extra = {n: torch.where(outside, 0.0, col[n]) for n in self.extra3}
        kela = extra.pop("kela", None)
        return FluidVars(rho=rho, p=p, bmag=bmag * damp, u=u, b=b, rho2=rho,
                         kela=kela, extra=extra or None)
