"""PHATDISK and NUMDISK: inhomogeneous and numerical thin-disk surfaces.
Port of grtrans_tpu/fluid/disks.py.

 * PHATDISK (fluid_model_phatdisk.f90): Dexter & Agol 2011 disk with
   log-normal temperature fluctuations.  A table F_nu(r, nu) is built at
   load from the thin-disk T(r) convolved with the log-normal weight
   (:85-125) and sampled along rays for the INTERP emissivity.
 * NUMDISK (fluid_model_numdisk.f90): a T_eff(r, phi) image from a
   Fortran unformatted file (:190-212) or from arrays, sampled bilinearly
   in log r x phi (:45-140), with the tscl / rscl scalings.

Both use the thin disk's Keplerian flow and the disk-surface polarization
basis (fluid.f90:622-652).  Both interpolations are weighted combines of
packed table rows, so they go through ops.quad_gather: the hand-written
kernel on the card, its plain version on the CPU."""

import math

import numpy as np
import torch
from torch import nn

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch.fluid import base
from grtrans_tpu_torch.fluid.analytic import ThinDisk, _u_from_3vel
from grtrans_tpu_torch.fluid.base import EmisInputs, FluidVars
from grtrans_tpu_torch.fluid.ffjet import _read_fortran_records
from grtrans_tpu_torch.geometry import kerr
from grtrans_tpu_torch.ops.intcast import trunc_clip
from grtrans_tpu_torch.ops.interp import get_weight
from grtrans_tpu_torch.ops.quad_gather import pair_rows, quad_gather

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def phatdisk_tables(a=0.998, mbh=10.0, mdot=0.1, rin=0.0, rout=1e4, nw=500,
                    wmin=1e-4, wmax=1e4, nfreq_tab=100, fmin=1e17 / 3.0,
                    fmax=3e19 * 3.0, nr=500, sigt=0.4, fcol=1.7):
    """The PHATDISK tables on the host: dict of float64 numpy arrays
    freq_tab (nfreq_tab,), r_tab (nr,), om_tab (nr,), fnu_tab
    (nr, nfreq_tab).  `rin` is read and unused, as in
    fluid_model_phatdisk.f90."""
    # frequency, weight and radius grids (read_phatdisk_inputs :36-49)
    if nfreq_tab == 1:
        freq = np.array([fmin])
    else:
        freq = fmin * np.exp(np.arange(nfreq_tab) * np.log(fmax / fmin)
                             / (nfreq_tab - 1))
    w = wmin * np.exp(np.arange(nw) * np.log(wmax / wmin) / max(nw - 1, 1))
    rh = 1.0 + np.sqrt(1.0 - a ** 2)
    r_tab = rh * np.exp(np.arange(1, nr + 1) / (nr - 1.0)
                        * np.log(rout / rh))
    # T(r) and Omega(r) of the thin disk in the equatorial plane
    x4 = np.zeros((nr, 4))
    x4[:, 1] = r_tab
    x4[:, 2] = np.pi / 2
    kdum = np.zeros((nr, 4))
    kdum[:, 0] = 1.0
    fv = ThinDisk(a=a, mbh=mbh, mdot=mdot, device="cpu").vals(
        torch.from_numpy(x4), torch.from_numpy(kdum), a)
    T = fv.rho.numpy()
    om = (fv.u[:, 3] / fv.u[:, 0]).numpy()
    # log-normal flux table (init_phatdisk :100-122)
    l10 = np.log(10.0) * sigt
    x = np.log(w)
    fw = np.exp(-(x + l10 ** 2) ** 2 / l10 ** 2) / l10 / np.sqrt(np.pi)
    fnu = np.empty((nr, nfreq_tab))
    for k_i, nu in enumerate(freq):
        z = pc.h * nu / pc.k / T / fcol
        zi = z[:, None] / w[None, :]
        den = np.where(zi > 1e-4, np.expm1(np.minimum(zi, 700.0)), zi)
        igrand = np.where(fw[None, :] > 0, fw[None, :] / den, 0.0)
        integ = _trapezoid(igrand, x, axis=1)
        fnu[:, k_i] = fcol ** (-4.0) * 2.0 * np.pi * z ** 3 \
            * (pc.k * fcol * T) ** 3 / pc.h / pc.h / pc.c2 * integ
    return dict(freq_tab=freq, r_tab=r_tab, om_tab=om, fnu_tab=fnu)


class PhatDisk(nn.Module):
    """The PHATDISK sampler.  Its state is the pair-packed table: row ix
    holds [Omega, F_nu(0..nfreq_tab-1)] at radii ix and ix + 1, so one
    sample is one row gather and a two-term combine (quad_gather with
    nc = 2, nf = 1 + nfreq_tab)."""

    def __init__(self, freq_tab, r_tab, om_tab, fnu_tab, *, device):
        super().__init__()
        rows = np.concatenate([np.asarray(om_tab, np.float64)[:, None],
                               np.asarray(fnu_tab, np.float64)], axis=1)
        self.nf = rows.shape[1]
        for name, arr in (("freq_tab", freq_tab), ("r_tab", r_tab),
                          ("packed", pair_rows(rows))):
            self.register_buffer(name, torch.as_tensor(
                np.array(arr, np.float64), device=device))

    def vals(self, x, k, a):
        r = x[..., 1]
        th = x[..., 2]
        ix, wgt = get_weight(self.r_tab, r)
        w = torch.stack([1 - wgt, wgt], dim=-1).reshape(-1, 2)
        rows = quad_gather(self.packed, ix.reshape(-1), w, 2, self.nf)
        rows = rows.reshape(r.shape + (self.nf,))
        om, fnu = rows[..., 0], rows[..., 1:]
        g = kerr.metric_cov(r, th, a)
        z = torch.zeros_like(r)
        u = _u_from_3vel(g, z, z, om)
        bvec = kerr.calc_polvec(r, th.cos(), k, a, math.pi / 2.0)
        return FluidVars(rho=z, p=z, bmag=z, u=u, b=bvec, rho2=z, fnu=fnu)

    def convert(self, fv, sp):
        one = torch.ones_like(fv.rho)
        return EmisInputs(ncgs=one, tcgs=fv.rho, bcgs=one,
                          ncgsnth=torch.zeros_like(fv.rho), fnu=fv.fnu,
                          freq_tab=self.freq_tab)


@base.register("PHATDISK")
def load_phatdisk(*, device, **kwargs):
    """PHATDISK on `device` with tables built from the parameters of
    `phatdisk_tables`."""
    return PhatDisk(**phatdisk_tables(**kwargs), device=device)


load_phatdisk.__wrapped__ = phatdisk_tables     # the fargs it takes


def read_numdisk_file(dfile, tscl=1.0, rscl=1.0):
    """NUMDISK table dict (nr, nphi, r, phi, T; r fastest) from the
    Fortran unformatted file (fluid_model_numdisk.f90:190-212)."""
    recs = _read_fortran_records(dfile)
    nr = int(np.frombuffer(recs[0], np.int32)[0])
    nphi = int(np.frombuffer(recs[1], np.int32)[0])
    arr = np.frombuffer(recs[2], np.float32)
    n = nr * nphi
    rc, phc, T = arr[:n], arr[n:2 * n], arr[2 * n:3 * n]
    return dict(nr=nr, nphi=nphi, r=rc.astype(np.float64) * rscl,
                phi=phc.astype(np.float64), T=T.astype(np.float64) * tscl)


class NumDisk(nn.Module):
    """The NUMDISK sampler.  Row (i_phi, i_r) of its corner-packed table
    holds T at the four corners of that cell (quad_gather with nc = 4,
    nf = 1)."""

    def __init__(self, table, *, device):
        super().__init__()
        self.nr_, self.nphi_ = nr, nphi = int(table["nr"]), int(table["nphi"])
        # r fastest-changing (fluid_model_numdisk.f90:71-77)
        uniqr = np.asarray(table["r"], np.float64)[:nr]
        uniqp = np.asarray(table["phi"], np.float64)[::nr][:nphi]
        T = np.asarray(table["T"], np.float64).reshape(nphi, nr)
        Tr = np.concatenate([T[:, 1:], T[:, -1:]], axis=1)      # i_r + 1
        Tp = np.concatenate([T[1:], T[-1:]], axis=0)            # i_phi + 1
        Tpr = np.concatenate([Tp[:, 1:], Tp[:, -1:]], axis=1)
        quad = np.stack([T, Tr, Tp, Tpr], axis=-1).reshape(nphi * nr, 4)
        for name, arr in (("uniqr", uniqr), ("uniqp", uniqp),
                          ("tquad", quad)):
            self.register_buffer(name, torch.as_tensor(
                np.array(arr, np.float64), device=device))
        self.lnr0, self.lnr1 = math.log(uniqr[0]), math.log(uniqr[-1])
        self.p0, self.dph = float(uniqp[0]), float(uniqp[1] - uniqp[0])

    def vals(self, x, k, a):
        r = x[..., 1]
        th = x[..., 2]
        phi = torch.remainder(x[..., 3] + 12.0 * math.pi, 2.0 * math.pi)
        nx1, nx2 = self.nr_, self.nphi_
        # cell indices: truncate, then clip (NaN radii land on row 0)
        lx1 = trunc_clip((r.log() - self.lnr0) / (self.lnr1 - self.lnr0)
                         * (nx1 - 1), nx1 - 2)
        lx2 = trunc_clip((phi - self.p0) / self.dph, nx2 - 2)
        r0 = self.uniqr[lx1.long()]
        rd = ((r - r0) / (self.uniqr[lx1.long() + 1] - r0)).clamp(0.0, 1.0)
        pd = ((phi - self.uniqp[lx2.long()]) / self.dph).clamp(0.0, 1.0)
        w = torch.stack([(1 - rd) * (1 - pd), rd * (1 - pd),
                         (1 - rd) * pd, rd * pd], dim=-1)
        T = quad_gather(self.tquad, (lx2 * nx1 + lx1).reshape(-1),
                        w.reshape(-1, 4), 4, 1).reshape(r.shape)
        inside = (r >= self.uniqr[0]) & (r <= self.uniqr[-1])
        T = torch.where(inside, T, 0.0)
        om = 1.0 / (r ** 1.5 + a)
        g = kerr.metric_cov(r, th, a)
        z = torch.zeros_like(r)
        u = _u_from_3vel(g, z, z, om)
        bvec = kerr.calc_polvec(r, th.cos(), k, a, 0.0)
        return FluidVars(rho=T, p=z, bmag=z, u=u, b=bvec, rho2=z)

    def convert(self, fv, sp):
        """tcgs = T, ncgs = 1 (convert_fluidvars_numdisk)."""
        one = torch.ones_like(fv.rho)
        return EmisInputs(ncgs=one, tcgs=fv.rho, bcgs=one,
                          ncgsnth=torch.zeros_like(fv.rho))


@base.register("NUMDISK")
def load_numdisk(dfile="phatdiskm8st25.bin", tscl=1.0, rscl=1.0, table=None,
                 *, device):
    """NUMDISK on `device` from `table` (a dict as read_numdisk_file
    returns, taken as it is) or else from the file `dfile`."""
    if table is None:
        table = read_numdisk_file(dfile, tscl, rscl)
    return NumDisk(table, device=device)
