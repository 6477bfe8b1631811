"""Blackbody-type emissivities for thin-disk surface emission (reference
emis.f90 bbemis / fbbemis / fbbpolemis :153-187, rhoemis :144-151)."""

import torch

from grtrans_tpu_torch.emis.chandra import interp_chandra
from grtrans_tpu_torch.emis.framework import from_columns
from grtrans_tpu_torch.emis.polsynch import bnu


def bbemis(nu, T):
    """Planck surface brightness (emis.f90:162-168)."""
    return from_columns({0: bnu(T, nu)})


def fbbemis(nu, T, f):
    """Color-corrected blackbody f^-4 B_nu(f T) (emis.f90:153-160)."""
    return from_columns({0: f ** (-4.0) * bnu(T * f, nu)})


def fbbpolemis(nu, T, f, cosne):
    """Color-corrected blackbody with Chandrasekhar electron-scattering
    limb darkening and polarization (emis.f90:170-185).  The reference
    sets f = 1.8 inside, whatever it is given."""
    f = 1.8
    I0 = f ** (-4.0) * bnu(T * f, nu)
    chi, chd = interp_chandra(cosne)
    return from_columns({0: I0 * chi, 1: I0 * chi * chd})


def rhoemis(rho, rshift):
    """Emissivity proportional to density (the 'RHO' test type,
    emis.f90:144)."""
    return from_columns({0: rho * rshift})
