"""Walker-Penrose transport of the polarization basis and the comoving
orthonormal frame (Kulkarni+2011).  Port of
grtrans_tpu/geometry/tetrad.py (reference kerr.f90:502-730)."""

import torch

from . import fourvector as fv
from . import kerr
from .kerr import safe_sqrt
from . import scalar as sc


def transport_perpk(kvec, r, th, a, g_cov, kap1, kap2):
    """Parallel-transported basis vector f = (0, f1, f2, f3), orthogonal
    to k, with Walker-Penrose constants (kap1, kap2) (kerr.f90:502-548)."""
    g03 = g_cov[..., 3]
    g11 = g_cov[..., 4]
    g22 = g_cov[..., 7]
    g33 = g_cov[..., 9]
    cth = th.cos()
    sth = th.sin()
    k0, k1, k2, k3 = kvec.unbind(-1)
    gam1 = a * cth * k0 - a * a * cth * sth * sth * k3
    gam2 = r * (r * r + a * a) * sth * k3 - a * r * sth * k0
    gam3 = a * a * cth * sth * sth * k1 - r * (r * r + a * a) * sth * k2
    del1 = r * k0 - r * a * sth * sth * k3
    del2 = -a * cth * sth * (r * r + a * a) * k3 + a * a * sth * cth * k0
    del3 = r * a * sth * sth * k1 + a * cth * sth * (r * r + a * a) * k2
    denom = ((gam2 * del1 - gam1 * del2) * (g33 * k3 + g03 * k0)
             + (gam3 * del2 - gam2 * del3) * g11 * k1
             - (gam3 * del1 - gam1 * del3) * g22 * k2)
    f1 = ((gam2 * kap1 - del2 * kap2) * (g33 * k3 + g03 * k0)
          - g22 * k2 * (gam3 * kap1 - del3 * kap2))
    f2 = ((del1 * kap2 - gam1 * kap1) * (g33 * k3 + g03 * k0)
          + g11 * k1 * (gam3 * kap1 - del3 * kap2))
    f3 = (g22 * k2 * (gam1 * kap1 - del1 * kap2)
          - g11 * k1 * (gam2 * kap1 - del2 * kap2))
    nz = denom.abs() > 0.0
    safe = torch.where(nz, denom, 1.0)
    return (torch.where(nz, f1 / safe, f1), torch.where(nz, f2 / safe, f2),
            torch.where(nz, f3 / safe, f3))


def comoving_ortho(r, th, a, alpha, beta, mus, u, b, k):
    """Project (u, b, k) into the comoving orthonormal tetrad.

    Returns (s2xi, c2xi, ang, g, cosne, frame_ok): the rotation of the
    transported polarization basis onto the projected B field (sin/cos of
    twice the angle), the k-B pitch angle, the redshift 1/khat^t, the disk
    emission cosine and a validity mask (kerr.f90:550-730).  `mus` is the
    observer's cos(inclination), a number (a 0-d tensor where a gradient
    flows to it)."""
    g_cov = kerr.metric_cov(r, th, a)
    gtt = g_cov[..., 0]
    gtp = g_cov[..., 3]
    grr = g_cov[..., 4]
    gmm = g_cov[..., 7]
    gpp = g_cov[..., 9]
    ut, ur, um, up = u.unbind(-1)
    utc = gtt * ut + gtp * up
    upc = gpp * up + gtp * ut
    urc = grr * ur
    umc = gmm * um

    # Walker-Penrose constants at the observer (kerr.f90:635-636)
    kap1 = alpha + a * sc.sqrt(1.0 - mus * mus)
    kap2 = -beta
    al1, al2, al3 = transport_perpk(k, r, th, a, g_cov, kap1, kap2)
    # degenerate pole-on case: basis along e_phi (kerr.f90:639-641)
    degen = (kap1 == 0.0) & (kap2 == 0.0)
    al1 = torch.where(degen, 0.0, al1)
    al2 = torch.where(degen, 0.0, al2)
    al3 = torch.where(degen, 1.0 / gpp.sqrt(), al3)
    z = torch.zeros_like(al1)
    aa = torch.stack([z, al1, al2, al3], dim=-1)

    # Kulkarni+2011 comoving tetrad (kerr.f90:644-667); the norms go
    # negative for unphysical four-velocities, which frame_ok reports
    d = r * r + a * a - 2.0 * r
    nr2 = -grr * (utc * ut + upc * up) * (1.0 + umc * um)
    nm2 = gmm * (1.0 + umc * um)
    np2 = -(utc * ut + upc * up) * d * th.sin() ** 2
    frame_ok = (nr2 > 0.0) & (nm2 > 0.0) & (np2 > 0.0)
    snr = torch.where(frame_ok, safe_sqrt(nr2), 1.0)
    snm = torch.where(frame_ok, safe_sqrt(nm2), 1.0)
    snp = torch.where(frame_ok, safe_sqrt(np2), 1.0)
    ekt = -u
    ekr = torch.stack([urc * ut / snr, -(utc * ut + upc * up) / snr,
                       z, urc * up / snr], dim=-1)
    ekm = torch.stack([umc * ut / snm, umc * ur / snm,
                       (1.0 + umc * um) / snm, umc * up / snm], dim=-1)
    ekp = torch.stack([upc / snp, z, z, -utc / snp], dim=-1)

    def proj(v):
        return torch.stack([fv.dot(g_cov, e, v) for e in (ekt, ekr, ekm, ekp)],
                           dim=-1)

    bhat = proj(b)
    khat = proj(k)
    ahat = proj(aa)

    knorm = khat[..., 1] ** 2 + khat[..., 2] ** 2 + khat[..., 3] ** 2
    kt_nz = khat[..., 0].abs() > 0.0
    frame_ok = frame_ok & (knorm > 0.0) & kt_nz
    kt_safe = torch.where(kt_nz, khat[..., 0], 1.0)
    # spatial part of the transported basis, projected perpendicular to k
    # with the null condition (kerr.f90:674-676)
    aahat = torch.stack([ahat[..., i] - khat[..., i] * ahat[..., 0] / kt_safe
                         for i in (1, 2, 3)], dim=-1)
    sk = torch.where(knorm > 0.0, safe_sqrt(knorm), 1.0)
    bbhat = torch.stack(
        [-(aahat[..., 1] * khat[..., 3] - aahat[..., 2] * khat[..., 2]) / sk,
         -(aahat[..., 2] * khat[..., 1] - aahat[..., 0] * khat[..., 3]) / sk,
         -(aahat[..., 0] * khat[..., 2] - aahat[..., 1] * khat[..., 1]) / sk],
        dim=-1)

    bdotb = fv.dot(g_cov, b, b)
    bdotk = (bhat[..., 1] * khat[..., 1] + bhat[..., 2] * khat[..., 2]
             + bhat[..., 3] * khat[..., 3])
    bsp = bhat[..., 1:4]
    aadotbp = (bsp * aahat).sum(-1)
    bpdotbb = (bsp * bbhat).sum(-1)
    nrm = aadotbp ** 2 + bpdotbb ** 2
    ok = bdotb > 0.0
    safenrm = torch.where(nrm > 0.0, nrm, 1.0)
    s2xi = torch.where(ok, -2.0 * aadotbp * bpdotbb / safenrm, 0.0)
    c2xi = torch.where(ok, (bpdotbb ** 2 - aadotbp ** 2) / safenrm, 1.0)
    angnorm = torch.where(
        ok, bdotk / sk / safe_sqrt(torch.where(ok, bdotb, 1.0)), 0.5)
    # keep |cos| just inside 1 (roundoff can push it over); unlike the
    # reference's +-0.99 clip this keeps the true pitch angle
    ang = torch.arccos(angnorm.clamp(-1.0 + 1e-8, 1.0 - 1e-8))
    g = 1.0 / kt_safe
    cosne = g * safe_sqrt(
        beta * beta + mus * mus * (alpha * alpha - a * a)) / r
    return s2xi, c2xi, ang, g, cosne, frame_ok
