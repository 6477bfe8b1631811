"""Power-law polarized synchrotron with finite gamma_min/gamma_max cutoffs
(reference polsynchemis.f90 polsynchpl, :527-631).

The cumulative synchrotron-function integrals G(x; p) are tabulated with
scipy on a dense (log x, p) grid (the same numpy/scipy code as
grtrans_tpu/emis/polsynchpl.py, so the tables are identical), blended in
p on the host and looked up per sample by the quad_gather kernel: one
row of (6 tables x 2 bracketing x nodes) per sample, combined with the
linear log-x weights.  A per-sample index p (a tensor) takes one bilinear
(p, log x) lookup of the six tables stacked and corner-packed (4 x 6 a
row), also through quad_gather."""

import math
from functools import lru_cache

import numpy as np
import torch

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch import obs
from grtrans_tpu_torch.ops.intcast import trunc_clip
from grtrans_tpu_torch.ops.interp import get_weight
from grtrans_tpu_torch.ops.quad_gather import (bilinear_packed,
                                               pack_corners_2d, pair_rows,
                                               quad_gather)

NX = 201           # log-x table resolution (20 per decade)
NP = 131           # p step 0.05: 3.0, 3.5 and 7.0 are exact nodes
X_LO, X_HI = 1e-7, 1e3
P_LO, P_HI = 1.5, 8.0
_G_ORDER = ("gx", "gp", "gv", "ga", "gap", "gav")


@lru_cache(maxsize=1)
def _build_tables():
    with obs.setup("tables", table="polsynchpl.G"):
        return _tables()


def _tables():
    from scipy import special
    from scipy.integrate import cumulative_trapezoid

    # fine grid for the cumulative integrals
    xf = np.logspace(np.log10(X_LO) - 2, np.log10(X_HI) + 1, 4000)
    K53 = special.kv(5.0 / 3.0, xf)
    K23 = special.kv(2.0 / 3.0, xf)
    K13 = special.kv(1.0 / 3.0, xf)

    def revcum(y):                      # int_x^inf on the fine grid
        c = cumulative_trapezoid(y[::-1], -xf[::-1], initial=0.0)
        return c[::-1]

    IK53 = revcum(K53)
    IK13 = revcum(K13)
    F = xf * IK53
    FQ = xf * K23
    FV = xf * K13 + IK13

    ps = np.linspace(P_LO, P_HI, NP)
    xs = np.logspace(np.log10(X_LO), np.log10(X_HI), NX)
    tables = {}
    specs = {"gx": (F, -3.0), "gp": (FQ, -3.0), "gv": (FV, -2.0),
             "ga": (F, -2.0), "gap": (FQ, -2.0), "gav": (FV, -1.0)}
    for name, (kern, off) in specs.items():
        tab = np.empty((NP, NX))
        for j, p in enumerate(ps):
            G = revcum(xf ** ((p + off) / 2.0) * kern)
            tab[j] = np.interp(np.log(xs), np.log(xf), np.log(G + 1e-37))
        tables[name] = tab
    return np.log(xs), ps, tables


def _xweight(lx):
    """Cell index and weight on the log-uniform x grid, by arithmetic."""
    lo = float(np.log(X_LO))
    hi = float(np.log(X_HI))
    step = (hi - lo) / (NX - 1)
    f = (lx - lo) / step
    ix = trunc_clip(f, NX - 2)
    return ix, f - ix.to(f.dtype)


def _g_rows(p):
    """Host-side p-blend of the six tables into one (NX, 6) stack."""
    _, _, tables = _build_tables()
    pp = float(np.clip(p, P_LO, P_HI))
    fi = (pp - P_LO) / (P_HI - P_LO) * (NP - 1)
    i0 = int(min(fi, NP - 2))
    w = fi - i0
    return np.stack([tables[n][i0] * (1 - w) + tables[n][i0 + 1] * w
                     for n in _G_ORDER], axis=-1)


def _g_all(x, p):
    """All six cutoff factors at x: (..., 6).  Row ix of the (NX, 12)
    table holds grid nodes ix and ix+1 of all six tables; quad_gather
    blends them with weights (1 - wx, wx), then exp."""
    lx = torch.log(x.clamp(X_LO, X_HI))
    rows = _g_rows(p)
    with obs.sync("polsynchpl._g_all"):
        pair = torch.as_tensor(pair_rows(rows), dtype=lx.dtype,
                               device=lx.device)                # (NX, 12)
    ix, wx = _xweight(lx)
    w = torch.stack([1 - wx, wx], dim=-1).reshape(-1, 2)
    v = quad_gather(pair, ix.reshape(-1), w, 2, 6)
    return torch.exp(v).reshape(lx.shape + (6,))


@lru_cache(maxsize=4)
def _pg_packed(dtype, device):
    """The six (p, x) tables stacked (NP, NX, 6) and corner-packed for a
    bilinear lookup, (NP * NX, 4 x 6), placed on `device`."""
    _, _, tables = _build_tables()
    with obs.setup("tables", table="polsynchpl.pg_packed"):
        packed = pack_corners_2d(np.stack([tables[n] for n in _G_ORDER],
                                          axis=-1))
        return torch.as_tensor(packed, dtype=dtype, device=device)


def _g_all_p(x, p):
    """All six cutoff factors at x for a per-sample index p (a tensor that
    broadcasts with x): (..., 6).  The (p, log x) cell of each sample is
    found by search, as grtrans_tpu's _g does, and its four corners of all
    six tables are one quad_gather row."""
    logxs, ps, _ = _build_tables()
    lx = torch.log(x.clamp(X_LO, X_HI))
    pp = p.to(lx.dtype).clamp(P_LO, P_HI)
    lx, pp = torch.broadcast_tensors(lx, pp)
    ix, wx = get_weight(torch.as_tensor(logxs, dtype=lx.dtype,
                                        device=lx.device), lx)
    ip, wp = get_weight(torch.as_tensor(ps, dtype=lx.dtype,
                                        device=lx.device), pp)
    return torch.exp(bilinear_packed(_pg_packed(lx.dtype, lx.device), NX,
                                     len(_G_ORDER), ip, ix, wp, wx))


def polsynchpl(nu, n, b, theta, p, gmin, gmax):
    """Polarized power-law synchrotron coefficients with finite-cutoff
    corrections (polsynchemis.f90:527-631).

    nu [Hz], n = nonthermal density [cm^-3], b [G], theta = pitch angle
    (tensors); p = index (a number, or a tensor of per-sample indices);
    gmin (number or tensor), gmax.  Returns (..., 11) in the standard
    [j(4), a(4), rho(3)] layout."""
    thsafe = 1e-10
    tanth = torch.tan(theta) + torch.sign(torch.cos(theta)) * thsafe
    # |sin|: float32's pi lies above pi, and its sine is -8.7e-8
    sinth = torch.sin(theta).abs() + thsafe
    nubperp = pc.e * b / (pc.m * pc.c * 2.0 * math.pi) * sinth + 1e-10
    nucmin = 1.5 * nubperp * gmin ** 2
    nucmax = 1.5 * nubperp * gmax ** 2
    omega0 = nubperp * 2.0 * math.pi
    omega = nu * 2.0 * math.pi
    xmin = nu / nucmin
    xmax = nu / nucmax
    A = (p - 1.0) * n / (gmin ** (1.0 - p) - gmax ** (1.0 - p))

    # tables are int_x^inf and xmax < xmin, so G(xmax) - G(xmin) > 0
    g_all = _g_all_p if torch.is_tensor(p) else _g_all
    gall = g_all(xmax, p) - g_all(xmin, p)
    gxfac, gpfac, gvfac, gafac, gapfac, gavfac = gall.unbind(-1)

    jfac = A * pc.e ** 2 / pc.c * math.sqrt(3.0) / 4.0 \
        * (3.0 * nubperp / 2.0 / nu) ** ((p - 1.0) / 2.0) * nubperp
    ji = jfac * gxfac
    jq = jfac * gpfac
    jv = jfac * 4.0 / 3.0 / tanth * torch.sqrt(3.0 * nubperp / 2.0 / nu) \
        * gvfac

    alpha = (p - 1.0) / 2.0
    kperp = A * pc.e ** 2 / (pc.m * pc.c) / nubperp
    nui = gmin * gmin * nubperp
    kstaralphav = 2.0 * (alpha + 1.5) / (alpha + 1.0)
    kstarq = kperp * (nubperp / nu) ** 3 * gmin ** (-2.0 * alpha + 1.0) \
        * (1.0 - (nui / nu) ** (alpha - 0.5)) / (alpha - 0.5)
    log_gmin = torch.log(gmin) if torch.is_tensor(gmin) else math.log(gmin)
    kstarv = kstaralphav * kperp * (nubperp / nu) ** 2 * log_gmin \
        * gmin ** (-2.0 * (alpha + 1.0)) / tanth
    afac = (2.0 * math.pi) ** 3 * A * pc.e ** 2 * math.sqrt(3.0) * omega0 \
        * (p + 2.0) / 32.0 / math.pi ** 2 / (pc.m * pc.c) / omega ** 2 \
        * (2.0 * omega / 3.0 / omega0) ** (-p / 2.0)
    ai = afac * gafac
    aq = afac * gapfac
    av = afac * 4.0 / 3.0 / tanth * gavfac \
        * (2.0 * omega / 3.0 / omega0) ** (-0.5)
    z = torch.zeros_like(ji)
    return torch.stack(torch.broadcast_tensors(
        ji, jq, z, jv, ai, aq, z, av, kstarq, z, kstarv), dim=-1)


def synchpl(nu, n, b, theta, p, gmin, gmax):
    """Unpolarized power-law synchrotron: j_I and a_I of polsynchpl, the
    rest zero (polsynchemis.f90:633-698)."""
    e = polsynchpl(nu, n, b, theta, p, gmin, gmax)
    keep = torch.zeros(11, dtype=e.dtype, device=e.device)
    keep[0] = keep[4] = 1.0
    return torch.where(keep > 0, e, 0.0)
