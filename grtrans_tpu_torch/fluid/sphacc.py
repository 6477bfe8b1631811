"""SPHACC: general-relativistic (Michel 1972) spherical Bondi accretion.
Port of grtrans_tpu/fluid/sphacc.py.

The reference (fluid_model_sphacc.f90) interpolates hard-coded 461/498
point solution tables (:13-449).  Here the transonic flow is solved at
load, on the host with scipy (Shapiro & Teukolsky ch. 14: sonic-point
conditions, relativistic Bernoulli and continuity on a log-r grid), with
the same parameters (Gamma = 5/3, T_inf = 0.917e-9 m_p c^2 ~ 1e4 K) and
the same closed-form density and equipartition-field normalizations
(:450-466):

    n(u) = ninf * alpha / (4 us) * (2 Gamma Tinf)^(-3/2) * (2u)^(3/2)
    B(u) = sqrt(8 pi n m_p / 2 c^2 u)

The four-velocity and field follow get_sphacc_fluidvars
(fluid.f90:1215-1247): radial infall in Schwarzschild, b from u.b = 0,
|b| = B with b_theta = b_phi = 0.  `solve_bondi` is the same numpy/scipy
code as grtrans_tpu's, so the tables are identical."""

import math

import numpy as np
import torch
from torch import nn

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch.fluid import base
from grtrans_tpu_torch.fluid.base import EmisInputs, FluidVars
from grtrans_tpu_torch.ops.interp import get_weight
from grtrans_tpu_torch.ops.quad_gather import pair_rows, quad_gather

GAMMA = 5.0 / 3.0
TINF = 0.917e-9          # theta_inf = k T_inf / (m_p c^2)
NINF = 1.0
ALPHA = 0.25
US = 0.94


def _synge_funcs():
    """Analytic Synge-gas thermodynamics for a single-temperature e-p
    plasma: enthalpy per baryon h(T), its derivative, the adiabat slope
    dlnT/dln n and the relativistic sound speed a^2(T) = (dP/de)_s.
    Closed-form Bessel identities (no tables, no cancellation noise)."""
    from scipy.special import kv

    def R_and_dR(x):
        """K3/K2(x) and d/dx; large-x asymptotics beyond overflow."""
        x = np.asarray(x, float)
        big = x > 300.0
        xs = np.where(big, 1.0, x)
        K1, K2, K3, K4 = (kv(n, xs) for n in (1, 2, 3, 4))
        R = K3 / np.maximum(K2, 1e-300)   # numpy: true f64 range
        dR = (-(K2 + K4) / 2.0 * K2 + K3 * (K1 + K3) / 2.0) \
            / np.maximum(K2 * K2, 1e-300)
        # asymptotic: R ~ 1 + 5/(2x) + 15/(8x^2) - 15/(8x^3)...
        Ra = 1.0 + 2.5 / x + 15.0 / (8.0 * x * x)
        dRa = -2.5 / (x * x) - 15.0 / (4.0 * x ** 3)
        return np.where(big, Ra, R), np.where(big, dRa, dR)

    def props(T):
        xp = pc.mp * pc.c2 / (pc.k * T)
        xe = pc.m * pc.c2 / (pc.k * T)
        Rp, dRp = R_and_dR(xp)
        Re, dRe = R_and_dR(xe)
        h = pc.mp * pc.c2 * Rp + pc.m * pc.c2 * Re
        # dh/dT = sum m c^2 dR/dx * (-x/T)
        dh = pc.mp * pc.c2 * dRp * (-xp / T) + pc.m * pc.c2 * dRe * (-xe / T)
        beta = (dh - 2.0 * pc.k) / (2.0 * pc.k * T)   # dln n/dT
        a2 = (2.0 * pc.k + 2.0 * pc.k * T * beta) \
            / (dh - 2.0 * pc.k + (h - 2.0 * pc.k * T) * beta)
        return h, dh, beta, a2

    return props


def solve_bondi(nr=600, r_min=1.9, r_max=1e5, t_inf_K=1e4):
    """Transonic GR Bondi flow (Michel 1972) for a single-temperature e-p
    Synge gas, by integrating the GR wind equation

        du/dr = [2 a^2/r - (1/r^2)/W] / [u/W - a^2/u],  W = 1-2/r+u^2

    outward and inward from the critical point (non-relativistic for a
    Gamma=5/3-at-infinity gas; launched along the L'Hopital slope).
    Closes with dlnT = (dlnT/dln n) dln n through the analytic Synge
    adiabat.  Returns (r, u_r, T[K]) sorted in r."""
    from scipy.integrate import solve_ivp

    props = _synge_funcs()

    # non-relativistic critical point: 6.75 us^4 = 3 a_inf^2, then make
    # (us, rs) exactly consistent with the analytic a^2(Ts)
    mbar = pc.mp + pc.m
    a_inf2 = GAMMA * 2.0 * pc.k * t_inf_K / (mbar * pc.c2)
    us2_est = np.sqrt(3.0 * a_inf2 / 6.75)
    Ts = us2_est / (1.0 - 3.0 * us2_est) * mbar * pc.c2 / (GAMMA * 2.0 * pc.k)
    _, _, _, a_s2 = props(Ts)
    a_s2 = float(a_s2)
    us2 = a_s2 / (1.0 + 3.0 * a_s2)
    us_ = np.sqrt(us2)
    rs = 1.0 / (2.0 * us2)

    def rhs(lnr, y):
        lnu, lnT = y
        r = np.exp(lnr)
        u = np.exp(lnu)
        T = np.exp(lnT)
        _, _, beta, a2 = props(T)
        W = 1.0 - 2.0 / r + u * u
        num = 2.0 * a2 / r - (1.0 / (r * r)) / W
        den = u / W - a2 / u
        dlnu_dlnr = (num / den) * r / u
        # dlnT/dln n along the adiabat = 1/(T beta)
        dlnT_dlnn = 1.0 / (T * beta)
        dlnT_dlnr = dlnT_dlnn * (-dlnu_dlnr - 2.0)
        return [dlnu_dlnr, dlnT_dlnr]

    # L'Hopital slope at the critical point
    def N_of(r, u, T):
        a2 = props(T)[3]
        W = 1.0 - 2.0 / r + u * u
        return 2.0 * a2 / r - (1.0 / (r * r)) / W

    def D_of(r, u, T):
        a2 = props(T)[3]
        W = 1.0 - 2.0 / r + u * u
        return u / W - a2 / u

    def fd(f, x, h):
        return (f(x + h) - f(x - h)) / (2 * h)

    beta_s = float(props(Ts)[2])
    alpha_s = 1.0 / (Ts * beta_s)       # dlnT/dln n at the sonic point
    Nr = fd(lambda r: N_of(r, us_, Ts), rs, rs * 1e-6)
    Nu = fd(lambda u: N_of(rs, u, Ts), us_, us_ * 1e-6)
    NT = fd(lambda T: N_of(rs, us_, T), Ts, Ts * 1e-6)
    Dr = fd(lambda r: D_of(r, us_, Ts), rs, rs * 1e-6)
    Du = fd(lambda u: D_of(rs, u, Ts), us_, us_ * 1e-6)
    DT = fd(lambda T: D_of(rs, us_, T), Ts, Ts * 1e-6)
    c1 = -alpha_s * Ts / us_
    c0 = -alpha_s * Ts * 2.0 / rs
    A = Du + DT * c1
    B = Dr + DT * c0 - Nu - NT * c1
    Cq = -(Nr + NT * c0)
    disc = np.sqrt(max(B * B - 4 * A * Cq, 0.0))
    roots = sorted([(-B - disc) / (2 * A), (-B + disc) / (2 * A)])
    ups = roots[0]          # accretion branch: du/dr < 0
    Tps = c1 * ups + c0

    eps = 1e-4 * rs
    rr_in = np.logspace(np.log10(rs - eps), np.log10(r_min), nr)
    rr_out = np.logspace(np.log10(rs + eps), np.log10(r_max), nr)
    out = {}
    for tag, rr_leg, dr0 in (("in", rr_in, -eps), ("out", rr_out, +eps)):
        y0 = [np.log(us_ + ups * dr0), np.log(Ts + Tps * dr0)]
        sol = solve_ivp(rhs, (np.log(rr_leg[0]), np.log(rr_leg[-1])), y0,
                        t_eval=np.log(rr_leg), rtol=1e-11, atol=1e-13,
                        method="LSODA")
        ny = sol.y.shape[1]
        out[tag] = (rr_leg[:ny], np.exp(sol.y[0]), np.exp(sol.y[1]))

    rr = np.concatenate([out["in"][0][::-1], out["out"][0]])
    uu = np.concatenate([out["in"][1][::-1], out["out"][1]])
    TT = np.concatenate([out["in"][2][::-1], out["out"][2]])
    return rr, uu, TT


class SphAcc(nn.Module):
    """The SPHACC sampler over the solved (r, u^r, T) tables.  Row ix of
    its pair-packed table holds (u^r, T) at radii ix and ix + 1
    (quad_gather with nc = 2, nf = 2)."""

    def __init__(self, r_tab, v_tab, T_tab, *, device):
        super().__init__()
        rows = np.stack([np.asarray(v_tab, np.float64),
                         np.asarray(T_tab, np.float64)], axis=1)
        self.register_buffer("r_tab", torch.as_tensor(
            np.array(r_tab, np.float64), device=device))
        self.register_buffer("packed", torch.as_tensor(pair_rows(rows),
                                                       device=device))

    def vals(self, x, k, a):
        r = x[..., 1]
        u = 1.0 / r
        ix, w = get_weight(self.r_tab, r)
        vT = quad_gather(self.packed, ix.reshape(-1),
                         torch.stack([1 - w, w], dim=-1).reshape(-1, 2), 2, 2)
        ur, T = vT.reshape(r.shape + (2,)).unbind(-1)
        # closed-form density and field (fluid_model_sphacc.f90:462-465)
        n = NINF * ALPHA / 4.0 / US * (2.0 * GAMMA * TINF) ** (-1.5) \
            * (2.0 * u) ** 1.5
        B = torch.sqrt(8.0 * math.pi * n * pc.mp / 2.0 * pc.c2 * u)
        g00 = -(1.0 - 2.0 * u)
        grr = -1.0 / g00
        ut = ((-grr * ur * ur - 1.0) / g00).clamp_min(1e-30).sqrt()
        z = torch.zeros_like(r)
        uvec = torch.stack([ut, -ur, z, z], dim=-1)
        # b from u.b = 0, b.b = B^2, b^th = b^ph = 0 (fluid.f90:1233-1236)
        bt2 = ur ** 2 * grr * B ** 2 \
            / (ur ** 2 * g00 * grr + ut ** 2 * g00 * g00)
        bt = bt2.clamp_min(0.0).sqrt()
        br = -(B ** 2 / grr - bt2 * g00 / grr).clamp_min(0.0).sqrt()
        bvec = torch.stack([bt, br, z, z], dim=-1)
        return FluidVars(rho=n, p=T, bmag=B, u=uvec, b=bvec, rho2=z)

    def convert(self, fv, sp):
        """ncgs = n, bcgs = B, tcgs = T (fluid.f90:1249-1259)."""
        return EmisInputs(ncgs=fv.rho, tcgs=fv.p, bcgs=fv.bmag,
                          ncgsnth=torch.zeros_like(fv.rho))


@base.register("SPHACC")
def load_sphacc(nr=600, tin=1.0e11, *, device):
    """SPHACC on `device`: solve the flow on nr points a leg and anchor
    the temperature to `tin` [K] at r = 2, where the reference normalizes
    its table (fluid_model_sphacc.f90:461); v(r) and n(r) do not depend
    on it."""
    rr, uu, TT = solve_bondi(nr)
    TT = TT * (tin / float(np.interp(2.0, rr, TT)))
    return SphAcc(rr, uu, TT, device=device)
