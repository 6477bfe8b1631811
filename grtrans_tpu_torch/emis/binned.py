"""Binned nonthermal electron synchrotron emissivity SYNCHBIN (reference
polsynchemis.f90 synchbinemis :1036-1160): per-cell electron populations
tabulated in Lorentz-factor bins, summed with the Westfold F(x) and
K_{5/3}(x) fitting functions.  The bin axis broadcasts and the sum is one
reduction over (npix, npts, nbin)."""

import math

import torch

from grtrans_tpu_torch import constants as pc


def _fx(x):
    """Westfold F(x) fit (polsynchemis.f90:1106-1131)."""
    x = x.clamp_min(1e-37)
    s = x.sqrt()
    cb = x ** (1.0 / 3.0)
    d1 = torch.exp(-0.97947838884478688 * x - 0.83333239129525072 * s
                   + 0.15541796026816246 * cb)
    d2 = -torch.expm1(-0.0469247165562628882 * x - 0.7005501805646288 * s
                      + 0.0103876297841949544 * cb)
    v = 2.149528241534479 * cb * d1 \
        + 1.2533141373155 * s * torch.exp(-x) * d2
    return torch.where(x >= 1000.0, 0.0, v)


def _k53x(x):
    """K_{5/3}(x) fit (polsynchemis.f90:1133-1158)."""
    x = x.clamp_min(1e-37)
    s = x.sqrt()
    cb = x ** (1.0 / 3.0)
    d1 = torch.exp(-1.0194198041210243 * x + 0.28011396300530672 * s
                   - 0.0771058491739234908 * cb)
    d2 = -torch.expm1(-15.761577796582387 * x)
    v = 1.433018827689652 * x ** (-5.0 / 3.0) * d1 \
        + 1.2533141373155 * torch.exp(-x) / s * d2
    v = torch.where(x <= 1e-6, 6.7e16, v)
    return torch.where(x >= 1000.0, 0.0, v)


def synchbinemis(nu, nbins, b, theta, gammas, dgammas):
    """Binned synchrotron j_I and a_I (polsynchemis.f90:1036-1103).

    nu, b, theta: (...,); nbins: (..., nbin) electrons / cm^3 per bin;
    gammas, dgammas: (nbin,) bin centers and widths.  Returns (..., 11)
    with only j_I and a_I populated."""
    sth = torch.sin(theta).abs()
    babs = b.abs()
    prefj = math.sqrt(3.0) * pc.e ** 3 * babs * sth \
        / (4.0 * math.pi ** 2 * pc.m * pc.c2)
    prefa = torch.where(babs > 0.0,
                        4.0 * math.pi * pc.e
                        / (3.0 * math.sqrt(3.0)
                           * (babs * sth).clamp_min(1e-37)), 0.0)
    nup = 3.0 * pc.e * babs * sth / (4.0 * math.pi * pc.m * pc.c)
    xm = nu[..., None] / (nup[..., None] * gammas ** 2).clamp_min(1e-37)
    jnu = prefj * (_fx(xm) * nbins * dgammas).sum(-1)
    anu = prefa * (_k53x(xm) * nbins * dgammas / gammas ** 5).sum(-1)
    z = torch.zeros_like(jnu)
    return torch.stack([jnu] + [z] * 3 + [anu] + [z] * 6, dim=-1)
