"""The 3-D GRMHD snapshot sampler on an (nt, nx1, nx2, nx3) lattice with
phi fastest (reference fluid_model_harm3d.f90 harm3d_vals :107-330):

 * grid-aligned storage of (rho, p, u0, LNRF velocities, b^mu), velocities
   as LNRF components so that interpolation stays subluminal;
 * BL -> KS azimuth and mod-2pi wrap before lookup (:156-161);
 * trilinear interpolation with fractional distances measured in the
   physical coordinates (r, theta, phi) while indices live on the
   (possibly stretched) simulation grid (:169-207), periodic in phi;
 * nearest neighbour + 1e-6 damping of p, n, b inside the innermost zone
   outside the horizon (:209-218);
 * four-vector reconstruction LNRF -> BL (:297-305) and
   bmag = sqrt(max(b.b, 0)) (:293-295).

The lookup is one quad_gather_rows (gather.py) on the phi-pair-packed
table (NS rows of 2 x nf: a zone and its phi + 1 neighbour), 4 rows a
sample.
"""

import math

import torch
from torch import nn

from .fluidbase import FluidVars
from .harm import four_vectors, x2_of_theta
from . import kerr
from .intcast import to_int32, trunc_clip
from .gather import quad_gather_rows

FIELDS = ("rho", "p", "u0", "vrl", "vtl", "vpl", "b0", "br", "bth", "bph")


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
    corner weights of each sample, pd the phi fraction; the weights take
    the table's dtype.  Returns pd.shape + (nf,)."""
    idx = torch.stack(idxs, dim=-1).reshape(-1, len(idxs))
    wr = torch.stack(ws, dim=-1)
    w = torch.stack([wr * (1 - pd)[..., None], wr * pd[..., None]], dim=-1)
    out = quad_gather_rows(table, idx.contiguous(), w.reshape(
        -1, len(idxs), 2).to(table.dtype).contiguous(), 2, nf)
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

    def stacked_names(self):
        """Field-column order of the packed stack (the gather's layout)."""
        return list(FIELDS) + sorted(self.extra3)

    def _stacked_fields(self, dtype=torch.float64):
        """All FIELDS + extra3 grids stacked minor-most, phi-pair packed
        and flattened to (nt * nx1*nx2*nx3, 2 nf), in `dtype` (float32 for
        the points of prec="mixed", the float64 stack rounded).  Cached for
        each dtype; invalidated by _store / append_slice."""
        names = self.stacked_names()
        nt = self.nt_slices
        key = (nt, tuple(names))
        if self._fstack_key != key:
            self._fstacks = {}
            self._fstack_key = key
        if dtype not in self._fstacks:
            arrs = []
            for n in names:
                g = self.f[n] if n in self.f else self.extra3[n]
                g = g if g.dim() == 4 else g[None]
                # a static extra field on a time series
                arrs.append(g.expand(nt, *g.shape[1:]))
            st = torch.stack(arrs, dim=-1)             # (nt, n1, n2, n3, nf)
            self._fstacks[dtype] = phi_pair_pack(st, 3).to(dtype).contiguous()
        return self._fstacks[dtype], names

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

        # the weights in the query's dtype, as the table is stacked in it
        # (float32 under prec="mixed")
        dt = r.dtype
        ws = tuple(w.to(dt) for w in ((1 - rd) * (1 - td), (1 - rd) * td,
                                      rd * (1 - td), rd * td))
        return dict(r=r, th=th, lx1=lx1, lx2=lx2, lx3=lx3, ws=ws,
                    pdc=pd.to(dt), tind=tind,
                    ttd=None if ttd is None else ttd.to(dt),
                    damp=damp.to(dt), outside=outside)

    def _gather_cols(self, table, NS, nx2, nx3, q, nf, own=None):
        """The trilinear sample of every field: one quad_gather_rows launch
        of 4 rows a sample (8 with the time blend) on the (nt * NS, 2 nf)
        table.  own (bool, the queries' shape): where False the sample
        weighs exactly 0 (slab_sample: its indices were clamped into a slab
        that does not hold it, and its weights may be NaN past a ray's
        end)."""
        lx1, lx2, lx3 = q["lx1"], q["lx2"], q["lx3"]
        lo = (lx1 * nx2 + lx2) * nx3 + lx3
        hi = ((lx1 + 1) * nx2 + lx2) * nx3 + lx3
        idxs = [lo, lo + nx3, hi, hi + nx3]
        ws, pd = list(q["ws"]), q["pdc"]
        if q["tind"] is not None:
            off, ttd = q["tind"] * NS, q["ttd"]
            idxs = [off + i for i in idxs] + [off + NS + i for i in idxs]
            ws = [w * (1 - ttd) for w in ws] + [w * ttd for w in ws]
        if own is not None:
            ws = [torch.where(own, w, 0.0) for w in ws]
            pd = torch.where(own, pd, 0.0)
        return trilinear_rows(table, idxs, ws, pd, nf)

    def vals(self, x, k, a, time=0.0):
        """FluidVars of every sample."""
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
