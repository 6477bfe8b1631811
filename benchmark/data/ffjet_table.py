"""A seeded synthetic FFJET solution at the real table size (128 x 128 in
log r x theta), as the file layout holds it: float32 values read back as
float64.  A smooth jet-like flow: density concentrated on the axis, LNRF
velocities |v| <= 0.5, u^t that makes the four-velocity unit, and a
radial + toroidal field projected orthogonal to u with a power-law |b|.
The published M87 solution is not distributed with the repository."""

import numpy as np

R_IN, R_OUT = 1.2, 1e3
RHO0 = 5e4         # density scale at r = 2 on the axis (model units)
B0 = 2.0           # |b| at r = 2 (model units)
TH_JET = 0.35      # angular width of the density concentration [rad]


def _bl_cov(r, th, a):
    """Covariant BL metric components (gtt, gtp, grr, gthth, gpp)."""
    s2 = np.sin(th) ** 2
    sig = r * r + a * a * np.cos(th) ** 2
    dlt = r * r - 2.0 * r + a * a
    A = (r * r + a * a) ** 2 - a * a * dlt * s2
    return (-(1.0 - 2.0 * r / sig), -2.0 * a * r * s2 / sig, sig / dlt, sig,
            A / sig * s2)


def fields(nx, a, seed):
    """(grids, fields) float64 dicts: the grid's end points and the nine
    (theta, r) fields, r fastest, rounded to float32 as the file holds
    them."""
    rng = np.random.default_rng(seed)
    r1 = np.logspace(np.log10(R_IN), np.log10(R_OUT), nx)
    th1 = np.linspace(0.0, np.pi / 2.0, nx)
    r1 = r1.astype(np.float32).astype(np.float64)
    th1 = th1.astype(np.float32).astype(np.float64)
    a = float(np.float32(a))
    r = np.broadcast_to(r1[None, :], (nx, nx))
    th = np.broadcast_to(th1[:, None], (nx, nx))
    sth, cth = np.sin(th), np.cos(th)

    def noise(amp):
        return amp * rng.uniform(-1.0, 1.0, size=(nx, nx))

    rho = (RHO0 * (r / 2.0) ** -2 * (np.exp(-(th / TH_JET) ** 2) + 0.05)
           * (1.0 + noise(0.05)))
    vr = 0.4 * np.tanh(r / 10.0) * cth ** 2
    vth = noise(0.03) * sth
    vph = 0.25 * np.sin(2.0 * th) * (1.0 + noise(0.1))

    sig = r * r + a * a * cth ** 2
    dlt = r * r - 2.0 * r + a * a
    A = (r * r + a * a) ** 2 - a * a * dlt * sth ** 2
    gamma = 1.0 / np.sqrt(1.0 - (vr ** 2 + vth ** 2 + vph ** 2))
    enu = np.sqrt(dlt * sig / A)                        # lapse
    u0 = gamma / enu
    # coordinate four-velocity (the inverse LNRF map, kerr.f90:451-474)
    epsi = sth * np.sqrt(A / sig)
    om = 2.0 * a * r / A
    ur = u0 * enu / np.sqrt(sig / dlt) * vr
    uth = u0 * enu / np.sqrt(sig) * vth
    safe = np.where(epsi > 0.0, epsi, 1.0)
    uph = u0 * (np.where(epsi > 0.0, enu / safe * vph, 0.0) + om)

    gtt, gtp, grr, gthth, gpp = _bl_cov(r, th, a)
    d = (np.zeros_like(r), np.ones_like(r), np.zeros_like(r), 2.0 / r)
    u = (u0, ur, uth, uph)

    def dot(x, y):
        return (gtt * x[0] * y[0] + gtp * (x[0] * y[3] + x[3] * y[0])
                + grr * x[1] * y[1] + gthth * x[2] * y[2]
                + gpp * x[3] * y[3])

    ud = dot(u, d)
    b = [d[i] + ud * u[i] for i in range(4)]
    scale = B0 * (r / 2.0) ** -1 * (1.0 + noise(0.05)) / np.sqrt(dot(b, b))
    b = [bi * scale for bi in b]

    out = {"rho": rho, "b0": b[0], "br": b[1], "bth": b[2], "bph": b[3],
           "u0": u0, "vr": vr, "vth": vth, "vph": vph}
    out = {k: np.ascontiguousarray(v).astype(np.float32).astype(np.float64)
           for k, v in out.items()}
    grids = {"a": a, "nx": nx, "uniqr": r1.copy(), "uniqth": th1.copy()}
    return grids, out


def make(params, seed, device):
    """The table of the configuration's `data` parameters (nx, a) from
    the seed, on the host (it is 128 x 128)."""
    grids, f = fields(params["nx"], params["a"], seed)
    return {"grids": grids, "fields": f, "ntscl": params["ntscl"],
            "nrscl": params["nrscl"]}


def program_model(data, device):
    """The program's FFJET model of the table."""
    from grtrans_tpu_torch import convert
    return convert.ffjet_from_arrays(data["grids"], data["fields"], device,
                                     ntscl=data["ntscl"], nrscl=data["nrscl"])


def reference_model(data, device):
    """The reference's FFJET model of the table."""
    from benchmark.reference import ffjet
    return ffjet.FFJet(data["grids"], data["fields"], ntscl=data["ntscl"],
                       nrscl=data["nrscl"], device=device)
