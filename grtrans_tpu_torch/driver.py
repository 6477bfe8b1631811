"""The per-ray rendering pipeline, batched over all pixels (reference
grtrans_driver.f90:57-465): fluid state -> comoving tetrad ->
coefficients -> rotation and invariant scalings -> Stokes integration.
Port of grtrans_tpu/driver.py, in float64 or its mixed precision: every
emissivity and integrator, the ray-integrating (standard=1) and the
thin-disk single-point (standard=2) branches, the 19 extra diagnostic
channels and the debug dump."""

import math

import torch

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch import obs
from grtrans_tpu_torch.emis import (bb, binned, brems, framework, mixtures,
                                    polsynch)
from grtrans_tpu_torch.emis import polsynchpl as pl_mod
from grtrans_tpu_torch.emis.chandra import interp_chandra
from grtrans_tpu_torch.fluid.base import apply_source_params
from grtrans_tpu_torch.geometry import kerr, tetrad
from grtrans_tpu_torch.integrate import solvers
from grtrans_tpu_torch.ops import render_polsynchth as rp
from grtrans_tpu_torch.ops.interp import get_weight


def calc_emissivity(ename, nu, ei, ang, cosne, sp, gmin=None):
    """(npix, npts, 11) coefficient block for emissivity `ename`
    (reference emis.f90:461-571).  gmin overrides sp.gmin."""
    ename = ename.upper()
    if gmin is None:
        gmin = sp.gmin
    if ename == "POLSYNCHTH":
        return polsynch.polsynchth(nu, ei.ncgs, ei.bcgs, ei.tcgs, ang)
    if ename == "SYMPOLTH":
        return polsynch.sympolemisth(nu, ei.ncgs, ei.bcgs, ei.tcgs, ang)
    if ename in ("SYNCHTHAV", "SYNCHTH"):
        return polsynch.synchemis(nu, ei.ncgs, ei.bcgs, ei.tcgs)
    if ename == "SYNCHTHAVNOABS":
        return polsynch.synchemisnoabs(nu, ei.ncgs, ei.bcgs, ei.tcgs)
    if ename == "POLSYNCHPL":
        return pl_mod.polsynchpl(nu, ei.ncgsnth, ei.bcgs, ang, sp.p1, gmin,
                                 sp.gmax)
    if ename == "SYNCHPL":
        return pl_mod.synchpl(nu, ei.ncgsnth, ei.bcgs, ang, sp.p1, gmin,
                              sp.gmax)
    if ename == "HYBRIDTHPL":
        return (polsynch.polsynchth(nu, ei.ncgs, ei.bcgs, ei.tcgs, ang)
                + pl_mod.polsynchpl(nu, ei.ncgsnth, ei.bcgs, ang, sp.p1,
                                    gmin, sp.gmax))
    if ename == "BB":
        return bb.bbemis(nu, ei.tcgs)
    if ename == "FBB":
        return bb.fbbemis(nu, ei.tcgs, 1.8)
    if ename == "BBPOL":
        return bb.fbbpolemis(nu, ei.tcgs, 1.8, cosne)
    if ename == "MAXJUTT":
        return mixtures.maxjutt(nu, ei.ncgs, ei.bcgs, ei.tcgs, ang,
                                sp.otherargs or (3.5, 1, 1, 1, 1, 1, 1))
    if ename == "MAXCOMP":
        return mixtures.maxcomp(nu, ei.ncgs, ei.bcgs, ei.tcgs, ang,
                                sp.otherargs or (3.5, 1, 1, 1, 1, 1, 1, 1))
    if ename in ("SYNCHBIN", "POLSYNCHBIN"):
        return binned.synchbinemis(nu, ei.nbins, ei.bcgs, ang, ei.gammas,
                                   ei.dgammas)
    if ename in ("BREMS", "BREMSHEROIC"):
        return brems.brememis_heroic(nu, ei.ncgs, ei.tcgs)
    if ename == "BREMSGRAY":
        return brems.brememis_gray(nu, ei.ncgs, ei.tcgs)
    if ename == "RHO":
        return bb.rhoemis(ei.ncgs, torch.ones_like(ei.ncgs))
    if ename == "INTERP":
        return _interpemis(nu, ei.fnu, ei.freq_tab)
    raise ValueError(f"unknown emissivity {ename!r}")


def _interpemis(nu, fnu, freq_tab):
    """Log-log interpolation of a tabulated F_nu (emis.f90:80-143; the
    PHATDISK path): fnu (..., nfreq_tab) at the frequencies freq_tab."""
    ix, w = get_weight(torch.log(freq_tab), torch.log(nu))
    ix = ix.long()[..., None]
    f0 = torch.gather(fnu, -1, ix)[..., 0]
    f1 = torch.gather(fnu, -1, ix + 1)[..., 0]
    val = torch.exp(torch.log(f0.clamp_min(1e-37)) * (1 - w)
                    + torch.log(f1.clamp_min(1e-37)) * w)
    inside = (nu >= freq_tab[0]) & (nu <= freq_tab[-1])
    j1 = torch.where(inside & (f0 > 0) & (f1 > 0), val, 0.0)
    return framework.from_columns({0: j1})


def _extra_channels(geo, fv, ei, j, K, prof, ok):
    """The 19 extra diagnostic images (reference grtrans_driver.f90:230-292
    + README:84-114): optical depths tau_I,Q,U,V and Faraday depths
    rho_Q, rho_V at the photosphere, emissivity-weighted <r>, <theta>,
    <phi>, <n>, <T_e>, <B>, <beta_plasma>, midplane-side fraction, and
    linear-polarization-weighted <r>, <theta>, <tau_FR>, <tau_FC>,
    <side>.  Returns (npix, 19)."""
    lam = geo.lam
    dlam = lam[..., 1:] - lam[..., :-1]

    def mid(q):
        return 0.5 * (q[..., 1:] + q[..., :-1])

    def cum(q):
        return torch.cat([torch.zeros_like(lam[..., :1]),
                          (mid(q) * dlam).cumsum(-1)], dim=-1)

    # optical depths along the ray for [aI aQ aU aV rhoQ rhoV]
    taus = [cum(K[..., i].abs()) for i in (0, 1, 2, 3, 4, 6)]
    tau_i = taus[0]
    # photosphere: the sample closest to tau_I = 1, the first one on a
    # tie, or the ray's end if it is thin
    taudex = (tau_i - 1.0).abs().argmin(-1)
    thin = tau_i[..., -1] < 1.0
    taudex = torch.where(thin, lam.shape[-1] - 1, taudex)

    def at_dex(q):
        return torch.gather(q, -1, taudex[..., None])[..., 0]

    out = [at_dex(t) for t in taus]
    # emissivity-weighted averages
    w = j[..., 0] * torch.exp(-tau_i.clamp_max(300.0))
    w = torch.where(ok, w, 0.0)
    side = torch.sign(torch.cos(geo.x[..., 2]))
    beta_pl = fv.p * 2.0 / fv.bmag.clamp_min(1e-37) ** 2
    safe = at_dex(cum(w)).clamp_min(1e-37)
    for q in (geo.x[..., 1], geo.x[..., 2], geo.x[..., 3], ei.ncgs,
              ei.tcgs, ei.bcgs, beta_pl, side):
        out.append(at_dex(cum(w * q)) / safe)
    # linear-polarization-weighted quantities from the Stokes profile
    lp = torch.sqrt(prof[..., 0] ** 2 + prof[..., 1] ** 2)
    dlp = (lp[..., :-1] - lp[..., 1:]).abs()    # LP growth per cell
    dsum = dlp.sum(-1).clamp_min(1e-37)
    for q in (geo.x[..., 1], geo.x[..., 2], taus[4], taus[5], side):
        out.append((dlp * mid(q)).sum(-1) / dsum)
    return torch.stack(out, dim=-1)


def _observe(geo, fv, ei, j, K, ok, iname, nvals, extra, profile):
    """(res, prof) of one frequency of a ray-integrating render from its
    rotated, scaled coefficients j (npix, npts, 4), K (npix, npts, 7) and
    mask ok: res the observer's Stokes (npix, nvals), with the 19 extra
    channels appended for extra=1; prof the Stokes profile where extra or
    `profile` asks for it, else None (the march keeps the observer's row
    only)."""
    if not (extra or profile):
        return solvers.observed_stokes(geo.lam, j, K, method=iname,
                                       mask=ok)[..., :nvals], None
    prof = solvers.integrate(geo.lam, j, K, method=iname, mask=ok)
    res = prof[..., 0, :nvals]
    if extra:
        res = torch.cat(
            [res, _extra_channels(geo, fv, ei, j, K, prof, ok)], dim=-1)
    return res, prof


def _on_card(*tensors):
    """Whether every tensor lies on a CUDA device."""
    return all(t.is_cuda for t in tensors)


def _kernel_takes(geo, fv, ei, ename, freqs, mu0, alpha, beta, a, mbh,
                  single, debug, prec):
    """Whether render_rays takes the POLSYNCHTH coefficient kernel: the
    emissivity POLSYNCHTH on a ray-integrating render (not `single`), no
    debug dump, operands on the card with no gradient recorded through
    them, the spin, mu0, mbh and frequencies numbers, and float64 operands
    or prec="mixed"."""
    ts = (geo.x, geo.k, fv.u, fv.b, alpha, beta, ei.ncgs, ei.bcgs, ei.tcgs)
    return (ename.upper() == "POLSYNCHTH" and not single and not debug
            and not any(torch.is_tensor(v) for v in (a, mu0, mbh, *freqs))
            and _on_card(*ts) and not solvers._needs_grad(*ts)
            and (prec == "mixed"
                 or all(t.dtype == torch.float64 for t in ts)))


def _render_kernel(geo, fv, ei, freqs, mu0, alpha, beta, a, mbh, sp, iname,
                   nvals, extra, mixed):
    """render_rays on the kernel's path: each frequency's j, K and ok from
    one launch of ops/render_polsynchth (the float32 kernel for mixed),
    then the march; no sync.  POLSYNCHTH reads neither ncgsnth nor gmin,
    so apply_source_params is left out; the extra channels read ei in the
    render's dtype, as the twin hands it to them."""
    if extra and mixed:
        ei = type(ei)(*(v.float() if torch.is_tensor(v) else v for v in ei))
    out = []
    for fghz in freqs:
        j, K, ok = rp.render_polsynchth(
            geo.x, geo.k, geo.valid, fv.u, fv.b, alpha, beta, ei.ncgs,
            ei.bcgs, ei.tcgs, a=a, mu0=mu0, fghz=fghz, mbh=mbh,
            coefindx=sp.coefindx, rotate=nvals == 4, mixed=mixed)
        out.append(_observe(geo, fv, ei, j, K, ok, iname, nvals, extra,
                            False)[0])
    ivals = torch.stack(out, dim=0)
    return ivals.double() if mixed else ivals


@obs.spanned("render")
def render_rays(geo, fv, ei, ename, freqs, mu0, alpha, beta, a, mbh, sp,
                iname="lsoda", nvals=4, standard=1, extra=0, debug=False,
                prec="f64"):
    """Observed Stokes for one camera and a list of frequencies.

    geo: GeodesicBundle; fv: FluidVars; ei: EmisInputs (cgs); freqs:
    observed frequencies [Hz]; alpha, beta (npix,) tensors; mu0, a, mbh
    floats.  Returns ivals (nfreq, npix, nvals), with 19 more columns for
    extra=1 on a ray-integrating render.  debug=True returns
    (ivals, dbg): dbg holds every intermediate of the pipeline (the
    reference's debug=1 dump, grtrans_driver.f90:91-110, :341-427) --
    geodesic coordinates, fluid state, tetrad angles, coefficients and
    Stokes profiles of each frequency -- so that any pixel can be
    integrated again on its own.

    prec="mixed" (grtrans_tpu's mixed path) runs the tetrad projection,
    the coefficients and the whole Stokes march in float32, with the
    affine parameter handed to the march in float64 (the march forms the
    Faraday phase in float64 and reduces it mod 2 pi before its float32
    trig); the image comes back float64.  Single-point renders (standard=2
    or one point a ray) stay float64.

    On the card, a POLSYNCHTH ray-integrating render with no gradient
    recorded and no debug dump, in float64 or mixed, takes each
    frequency's coefficients from one kernel launch (_render_kernel); every
    other call takes the torch code below, the kernel's twin.  obs counts
    "render.kernel.launches" (one a frequency) and "render.twin.calls"
    (one a call)."""
    single = standard == 2 or geo.x.shape[-2] == 1
    mixed = prec == "mixed" and not single
    if _kernel_takes(geo, fv, ei, ename, freqs, mu0, alpha, beta, a, mbh,
                     single, debug, prec):
        return _render_kernel(geo, fv, ei, freqs, mu0, alpha, beta, a, mbh,
                              sp, iname, nvals, extra, mixed)
    obs.count("render.twin.calls")
    r = geo.x[..., 1]
    th = geo.x[..., 2]
    # sanitize the fluid four-vectors before the tetrad projection
    okf = torch.isfinite(fv.u).all(-1) & torch.isfinite(fv.b).all(-1)
    like = dict(dtype=fv.u.dtype, device=fv.u.device)
    with obs.sync("driver.render_rays", 2):
        u_rest = torch.tensor([1.0, 0.0, 0.0, 0.0], **like)
        b_unit = torch.tensor([0.0, 0.0, 0.0, 1.0], **like)
    u_safe = torch.where(okf[..., None], fv.u, u_rest)
    b_safe = torch.where(okf[..., None], fv.b, b_unit)
    k = geo.k
    if mixed:
        r, th, alpha, beta, u_safe, b_safe, k = (
            v.float() for v in (r, th, alpha, beta, u_safe, b_safe, k))
    s2xi, c2xi, ang, g, cosne, frame_ok = tetrad.comoving_ortho(
        r, th, a, alpha[:, None], beta[:, None], mu0, u_safe, b_safe, k)
    # fluid models produce NaN four-velocities where their flow is
    # unphysical; mask explicitly rather than rely on NaN propagation
    ok = (geo.valid & okf & frame_ok & torch.isfinite(g)
          & torch.isfinite(s2xi) & torch.isfinite(c2xi)
          & torch.isfinite(ang))
    if mixed:
        # a plunging ray's last sample lies 1e-6 r+ outside the horizon,
        # where float32 holds r - r+ to a few percent and the projection
        # onto the fluid frame (terms ~ 1 / Delta that cancel) gives any
        # redshift; in float64 g -> 0 there and the sample emits nothing,
        # so the float32 leg leaves out the samples within HOR_F32 r+
        rh = kerr.horizon(a)
        ok = ok & (r - rh > rp.HOR_F32 * rh)
    s2xi = torch.where(ok, s2xi, 0.0)
    c2xi = torch.where(ok, c2xi, 1.0)
    ang = torch.where(ok, ang, math.pi / 2.0)
    cosne = torch.where(ok & torch.isfinite(cosne), cosne, 0.5)
    g = torch.where(ok, g, 1.0).clamp(1e-8, 1e8)
    lbh = pc.lbh(mbh)
    thin_pol = standard == 2 and ename.upper() == "BBPOL" and nvals == 4
    if thin_pol:
        # Chandrasekhar scattering polarization rotated to the observer's
        # basis (grtrans_driver.f90:483-505)
        q2b = (beta ** 2 + (alpha ** 2 - a * a) * mu0 ** 2)[:, None]
        c2psi, s2psi, cosne2 = kerr.calc_polar_psi(
            r, th.cos(), q2b, a, alpha[:, None], beta[:, None], g, mu0,
            geo.k)
        chI, chd = interp_chandra(cosne2)
    ei, gmin_eff = apply_source_params(ei, sp)
    if mixed:
        # every cgs quantity fits float32 once the coefficient formulas
        # form their dimensionless ratios first
        ei = type(ei)(*(v.float() if torch.is_tensor(v) else v for v in ei))
        if torch.is_tensor(gmin_eff):
            gmin_eff = gmin_eff.float()
        ang, cosne, s2xi, c2xi = (v.float() for v in (ang, cosne, s2xi,
                                                      c2xi))

    dbg = {}
    if debug:
        dbg.update(x=geo.x, kvec=geo.k, lam=geo.lam, mino=geo.mino,
                   tpm=geo.tpm, tpr=geo.tpr, valid=geo.valid,
                   u=fv.u, b=fv.b, rho=fv.rho, p=fv.p, bmag=fv.bmag,
                   ncgs=ei.ncgs, tcgs=ei.tcgs, bcgs=ei.bcgs,
                   ncgsnth=ei.ncgsnth, s2xi=s2xi, c2xi=c2xi, ang=ang,
                   g=g, cosne=cosne, ok=ok)

    out = []
    for kf, fghz in enumerate(freqs):
        nu = fghz / g
        e = calc_emissivity(ename, nu, ei, ang, cosne, sp, gmin=gmin_eff)
        if sp.coefindx is not None:
            # zero de-selected absorption/rotation coefficients
            # (emis.f90:557-558)
            e = e * torch.tensor((1.0,) * 4 + tuple(sp.coefindx),
                                 dtype=e.dtype, device=e.device)
        e = torch.where(ok[..., None], e, 0.0)
        e = torch.where(torch.isfinite(e), e, 0.0)
        j, K = framework.split_e(e)
        if single:
            # thin-disk single-point branch (grtrans_driver.f90:295-312)
            if thin_pol:
                j1 = j[..., 0] * chI
                j = torch.stack([j1, j1 * c2psi * chd, j1 * s2psi * chd,
                                 torch.zeros_like(j1)], dim=-1)
            j = framework.invariant_intensity(j, g, 3)
            j = torch.where(ok[..., None], j, 0.0)
            j = torch.where(torch.isfinite(j), j, 0.0)
            res = j[..., -1, :nvals]
        else:
            if nvals == 4:
                j, K = framework.rotate_emis(j, K, s2xi, c2xi)
            j, K = framework.invariant_emis(j, K, g)
            # cgs per unit geometric path (grtrans_driver.f90:217,228)
            j = j * lbh
            K = K * lbh
            res, prof = _observe(geo, fv, ei, j, K, ok, iname, nvals, extra,
                                 debug)
        if debug:
            dbg[f"nu_{kf}"] = nu
            dbg[f"j_{kf}"] = j
            dbg[f"K_{kf}"] = K
            if not single:
                dbg[f"prof_{kf}"] = prof
        out.append(res)
    ivals = torch.stack(out, dim=0)
    if mixed:
        ivals = ivals.double()
    return (ivals, dbg) if debug else ivals
