"""Synthetic FFJET dump at the real table size, from a seed (numpy only).

The published M87 solution file is not distributed with this repository,
so tests and the GPU smoke run render this stand-in: a smooth, jet-like
flow on the same grid shape, written in the Fortran-record layout that
`load_ffjet_file` reads (fluid_model_ffjet.f90:187-210):

    header (f32 a, i32 n = nx^2)
    (rc, thc, rho)
    (scratch, b0, br, bth, bph)
    (u0, vr, vth, vph)

Arrays are (theta, r) with r fastest, float32 on disk.  r is log-uniform
on [1.2, 1e3], theta uniform on [0, pi/2].  vr, vth, vph are LNRF
velocities with |v| <= 0.5; u0 = gamma sqrt(A / (Sigma Delta)) makes the
four-velocity unit; b is a radial + toroidal direction projected
orthogonal to u, scaled to a power-law |b|.  The geometry is computed at
the float32-rounded grid values, so it holds at the stored nodes.
"""

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


def ffjet_fields(nx=128, a=0.998, seed=0):
    """(grids, fields) float64 dicts in the layout of load_ffjet_file,
    before the float32 rounding of the file."""
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
    # field direction: radial + toroidal, projected orthogonal to u
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

    grids = {"a": a, "nx": nx, "uniqr": r1.copy(), "uniqth": th1.copy()}
    fields = {"rho": rho, "b0": b[0], "br": b[1], "bth": b[2], "bph": b[3],
              "u0": u0, "vr": vr, "vth": vth, "vph": vph}
    return grids, {k: np.ascontiguousarray(v) for k, v in fields.items()}


def _record(f, *arrays):
    payload = b"".join(np.asarray(x).tobytes() for x in arrays)
    marker = np.int32(len(payload)).tobytes()
    f.write(marker + payload + marker)


def write_ffjet_dump(path, nx=128, a=0.998, seed=0):
    """Write the synthetic dump to `path`; returns (grids, fields) of
    ffjet_fields, the float64 values before rounding."""
    grids, fields = ffjet_fields(nx, a, seed)
    f32 = {k: v.astype(np.float32).ravel() for k, v in fields.items()}
    rc = np.broadcast_to(grids["uniqr"][None, :], (nx, nx))
    thc = np.broadcast_to(grids["uniqth"][:, None], (nx, nx))
    with open(path, "wb") as f:
        _record(f, np.float32(grids["a"]), np.int32(nx * nx))
        _record(f, rc.astype(np.float32), thc.astype(np.float32), f32["rho"])
        _record(f, np.zeros(nx * nx, np.float32), f32["b0"], f32["br"],
                f32["bth"], f32["bph"])
        _record(f, f32["u0"], f32["vr"], f32["vth"], f32["vph"])
    return grids, fields
