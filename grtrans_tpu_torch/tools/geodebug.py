"""Single-ray debug dumps, the reference's debug=1 channel
(grtrans_driver.f90:91-110, :341-427; read_geodebug_file.py and
ray_integrate.py).

`dump_ray` renders the chosen pixel with the driver's debug channel on
and keeps every intermediate (geodesic coordinates, wavevector and affine
parameter, fluid state, tetrad angles, each frequency's coefficients and
Stokes profile) as numpy arrays, optionally in an .npz; `reintegrate`
gives the pixel's Stokes vector from the dumped coefficients alone.  The
keys are grtrans_tpu.tools.geodebug's, so a dump of either package
re-integrates in the other.
"""

import numpy as np
import torch

from grtrans_tpu_torch import driver
from grtrans_tpu_torch.fluid.base import load_fluid_model
from grtrans_tpu_torch.geodesics import camera as cam_mod
from grtrans_tpu_torch.integrate import solvers
from grtrans_tpu_torch.orchestrator import _source_params, trace_camera


def dump_ray(cfg, i, path=None, model=None, mu_index=0, mdot_index=0, *,
             device):
    """Render pixel i (1-based, the reference's i1/i2 convention) of the
    camera at mus()[mu_index], mdots()[mdot_index] on `device`, with the
    debug channel on.  model: a fluid model loaded on `device` (else
    loaded from cfg.fname / cfg.fargs).

    Returns the dump dict of numpy arrays (pixel axis of length 1); with
    `path`, also writes it as an .npz."""
    a = cfg.spin
    mu0 = float(cfg.mus()[mu_index])
    mdot = float(cfg.mdots()[mdot_index])
    nro, nphi, _ = cfg.nn
    cam = cam_mod.make_camera(a, mu0, *cfg.gridvals, nro, nphi, cfg.nrotype,
                              cfg.rcut, device=device)
    pix = slice(i - 1, i)
    cam = cam._replace(alpha=cam.alpha[pix], beta=cam.beta[pix],
                       l=cam.l[pix], q2=cam.q2[pix], sm=cam.sm[pix])
    if model is None:
        model = load_fluid_model(cfg.fname, device=device, **cfg.fargs)
    sp = _source_params(cfg, mdot)
    geo = trace_camera(cfg, cam, mu0)
    fv = model.vals(geo.x, geo.k, a)
    ei = model.convert(fv, sp)
    ivals, dbg = driver.render_rays(
        geo, fv, ei, cfg.ename, [float(f) for f in cfg.freqs()], mu0,
        cam.alpha, cam.beta, a, cfg.mbh, sp, iname=cfg.iname,
        nvals=cfg.nvals, standard=cfg.standard, extra=cfg.extra, debug=True)
    dump = {k: v.cpu().numpy() for k, v in dbg.items() if v is not None}
    dump["ivals"] = ivals.cpu().numpy()
    dump["alpha"] = cam.alpha.cpu().numpy()
    dump["beta"] = cam.beta.cpu().numpy()
    dump["pixel"] = np.asarray([i])
    dump["iname"] = np.asarray(cfg.iname)
    dump["nfreq"] = np.asarray(len(cfg.freqs()))
    if path is not None:
        np.savez(path, **dump)
    return dump


def load(path):
    """A geodebug dump as a dict of numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def reintegrate(dump, freq_index=0, method=None, *, device):
    """The dumped pixel's observed Stokes vector (npix, 4), integrated on
    `device` from the dump's coefficients alone (reference
    ray_integrate.py)."""
    def t(k):
        return torch.as_tensor(np.asarray(dump[k]), device=device)

    method = method or str(dump.get("iname", "formal"))
    prof = solvers.integrate(t("lam"), t(f"j_{freq_index}"),
                             t(f"K_{freq_index}"), method=method,
                             mask=t("ok"))
    return prof[..., 0, :].cpu().numpy()
