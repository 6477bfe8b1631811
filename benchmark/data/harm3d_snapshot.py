"""A seeded synthetic HARM3D snapshot (Chris White layout: MKS u^mu and
b^mu, theta = pi x2, phi fastest) at the EHT library's iharm3d resolution,
made on the device and handed over as the host arrays a dump holds.

The flow: Keplerian rotation outside the ISCO and the plunging geodesic
flow inside it, a toroidal field of strength 1 / r, and a torus of density
exp(-((r - 6) / 6)^2) with an m = 2 azimuthal mode and seeded log-normal
turbulence; the pressure is a tenth of the density.  The BL four-vectors
are carried to MKS (BL -> KS -> MKS) with the derivatives the loader
applies in the other direction."""

import math

import numpy as np
import torch

from benchmark.reference import kerr
from benchmark.reference.fluidbase import toroidal_b

GAM = 13.0 / 9.0
AMP = 0.3          # log-normal turbulence amplitude
ROUT = 50.0        # outer radius of the grid


def _to_mks(v, r, a):
    """BL four-vector -> KS -> MKS with x1 = ln r, theta = pi x2."""
    d = r * r - 2.0 * r + a * a
    v1 = v[..., 1] / r
    return torch.stack([v[..., 0] + 2.0 * r / d * v[..., 1], v1,
                        v[..., 2] / math.pi, v[..., 3] + a / d * v[..., 1]],
                       dim=-1)


def make(params, seed, device):
    """The dump dict of the configuration's `data` parameters (nx1, nx2,
    nx3, a, mdot_code) from the seed: the arrays made in float64 on
    `device` by one generator, then brought to the host."""
    nx1, nx2, nx3 = params["nx1"], params["nx2"], params["nx3"]
    a = params["a"]
    f64 = dict(dtype=torch.float64, device=device)
    x1 = torch.linspace(math.log(kerr.horizon(a) * 0.98), math.log(ROUT),
                        nx1, **f64)
    x2 = torch.linspace(0.01, 0.99, nx2, **f64)
    x3 = torch.arange(nx3, **f64) * (2.0 * math.pi / nx3)
    X1, X2, X3 = (v.reshape(-1) for v in torch.meshgrid(x1, x2, x3,
                                                        indexing="ij"))
    r, th = X1.exp(), math.pi * X2
    g = kerr.metric_cov(r, th, a)
    om = 1.0 / (r ** 1.5 + a)
    z = torch.zeros_like(r)
    u0 = kerr.calc_u0(g, z, z, om)
    u = torch.stack([u0, z, z, om * u0], dim=-1)
    plunge = (r < kerr.calc_rms(a)) | (u0 == 1.0)
    u = torch.where(plunge[..., None], kerr.rms_vel(a, th, r), u)
    b = toroidal_b(g, u, 1.0 / r)
    del g
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    noise = torch.exp(AMP * torch.randn(r.shape, generator=gen, **f64))
    rho = (torch.exp(-((r - 6.0) / 6.0) ** 2)
           * (1.0 + 0.3 * torch.cos(2.0 * X3)) * noise + 1e-4)

    def host(t):
        return t.cpu().numpy()

    return {"dump": dict(tcur=0.0, nx1=nx1, nx2=nx2, nx3=nx3, a=a, gam=GAM,
                         h=1.0, x1=host(X1), x2=host(X2), x3=host(X3),
                         r=host(r), th=host(th), ph=host(X3), rho=host(rho),
                         p=host(0.1 * rho), u=host(_to_mks(u, r, a)),
                         b=host(_to_mks(b, r, a))),
            "mdot_code": params["mdot_code"]}


def program_model(data, device):
    """The program's HARM3D model of the dump."""
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    return load_fluid_model("HARM3D", device=device, dump=data["dump"],
                             mdot_code=data["mdot_code"])


def reference_model(data, device):
    """The reference's HARM3D model of the dump."""
    from benchmark.reference import harm3d
    return harm3d.Harm3D(data["dump"], mdot_code=data["mdot_code"],
                         device=device)
