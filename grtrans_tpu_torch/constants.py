"""Physical constants in cgs units.

Parity target: reference phys_constants.f90:3-6.  The reference uses a few
slightly non-standard values (e.g. msun=1.998e33, G=6.67e-8); we keep those
values so that images/spectra agree with the reference to well below its own
regression tolerance (rel. L1 1e-2).
"""

import numpy as np

h = 6.626e-27        # Planck [erg s]
k = 1.38e-16         # Boltzmann [erg/K]
c = 2.99792458e10    # speed of light [cm/s]
e = 4.8032e-10       # electron charge [esu]
G = 6.67e-8          # gravitational constant [cgs]
m = 9.10938188e-28   # electron mass [g]
me = m
mp = 1.67262158e-24  # proton mass [g]
pi = float(np.pi)
c2 = c * c
sigb = 5.6704e-5     # Stefan-Boltzmann [cgs]
msun = 1.998e33      # solar mass [g] (reference value)
sigt = 6.6523e-25    # Thomson cross-section [cm^2]


def ledd(mbh_msun):
    """Eddington luminosity [erg/s] for BH mass in solar masses.

    Parity: reference kerr.f90:94-99."""
    return 4.0 * pi * G * mbh_msun * msun * mp * c / sigt


def lbh(mbh_msun):
    """Gravitational length GM/c^2 [cm]."""
    return G * mbh_msun * msun / c2


def tbh(mbh_msun):
    """Gravitational time GM/c^3 [s]."""
    return G * mbh_msun * msun / (c2 * c)
