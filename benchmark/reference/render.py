"""The reference image of one camera at a chosen set of its pixels: the
camera's rays traced, the fluid sampled and the Stokes vector marched
again from the benchmark's own data, in float64."""

import math

import numpy as np
import torch

from . import camera, driver, geokerr
from .fluidbase import CONST, TAIL, SourceParams


def source_params(cfg, mdot):
    """The emission model's parameters of one render (reference
    source_params, fluid.f90:69-75)."""
    return SourceParams(nfac=mdot, mbh=cfg["mbh"], mdot=mdot, mu=cfg["muval"],
                        gmin=cfg["gmin"], gmax=cfg["gmax"], p1=cfg["p1"],
                        p2=cfg["p2"], jetalpha=cfg["jetalpha"],
                        stype=CONST if cfg["stype"] == "const" else TAIL,
                        sigcut=cfg["sigcut"])


def render_pixels(cfg, model, mu0, mdots, pix, device, block=4096):
    """IQUV of the pixels `pix` (indices into the camera's nro x nphi
    grid, beta fastest) of the camera at cos(inclination) mu0, for each
    accretion rate of `mdots`: (len(mdots), nfreq, len(pix), nvals),
    float64.  cfg: the configuration file's `grtrans` dict; the rays are
    rendered `block` at a time."""
    a = cfg["spin"]
    nro, nphi, npts = cfg["nn"]
    cam = camera.make_camera(a, float(mu0), *cfg["gridvals"], nro, nphi,
                             cfg["nrotype"], cfg["rcut"], device=device)
    # rays start at uout when it lies inside the camera's own u0
    uout = cfg["uout"] if cfg["uout"] > cam.u0 * 1.0001 else None
    if cfg["nfreq"] == 1:
        freqs = [float(cfg["fmin"])]
    else:
        freqs = [float(f) for f in np.logspace(
            math.log10(cfg["fmin"]), math.log10(cfg["fmax"]), cfg["nfreq"])]
    pix = torch.as_tensor(pix, dtype=torch.long, device=device)
    out = []
    for lo in range(0, pix.shape[0], block):
        sel = pix[lo:lo + block]
        alpha, beta = cam.alpha[sel], cam.beta[sel]
        geo = geokerr.trace(a, float(mu0), alpha, beta, cam.l[sel],
                            cam.q2[sel], cam.sm[sel], cam.u0, npts,
                            uout=uout, phi0=cfg["phi0"])
        fv = model.vals(geo.x, geo.k, a)
        part = []
        for mdot in mdots:
            sp = source_params(cfg, float(mdot))
            ei = model.convert(fv, sp)
            part.append(driver.render_rays(
                geo, fv, ei, cfg["ename"], freqs, float(mu0), alpha, beta, a,
                cfg["mbh"], sp, iname=cfg["iname"], nvals=cfg["nvals"]))
        out.append(torch.stack(part))
        del geo, fv
    return torch.cat(out, dim=2)
