"""Run configuration with reference-parity parameter names.

Same fields and defaults as `grtrans_tpu.config.GrtransConfig` (the
reference's six namelists, read_inputs.f90:8-20).  Model-specific
parameters go in `fargs`.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np


@dataclass
class GrtransConfig:
    # geodata
    standard: int = 1
    mumin: float = 0.1
    mumax: float = 1.0
    nmu: int = 1
    phi0: float = -0.5          # units of pi (geodesics.f90:218)
    spin: float = 0.998
    uout: float = 1e-4
    uin: float = 1.0
    rcut: float = 1.0
    nrotype: int = 2
    gridvals: tuple = (-15.0, 15.0, -15.0, 15.0)  # a1,a2,b1,b2
    nn: tuple = (100, 100, 400)                    # nro,nphi,nup
    i1: int = -1                # pixel subrange (1-based); -1 = full camera
    i2: int = -1

    # fluiddata
    fname: str = "THINDISK"
    dt: float = 10.0
    nt: int = 1
    nload: int = 1
    nmdot: int = 1
    mdotmin: float = 1.57e15
    mdotmax: float = 1.57e15
    sigcut: float = 1e10
    epotherargs: Optional[tuple] = None
    epcoefindx: Optional[tuple] = None
    fargs: Dict[str, Any] = field(default_factory=dict)

    # emisdata
    ename: str = "POLSYNCHTH"
    mbh: float = 10.0
    nfreq: int = 1
    fmin: float = 1.e11
    fmax: float = 1.e11
    muval: float = 0.25
    gmin: float = 100.0
    gmax: float = 1e5
    p1: float = 3.5
    p2: float = 3.5
    jetalpha: float = 0.02
    stype: str = "const"

    # general
    use_geokerr: bool = True
    nvals: int = 4
    iname: str = "lsoda"
    cflag: int = 1
    extra: int = 0
    debug: int = 0
    prec: str = "f64"

    def freqs(self):
        if self.nfreq == 1:
            return np.array([self.fmin])
        return np.logspace(np.log10(self.fmin), np.log10(self.fmax),
                           self.nfreq)

    def mdots(self):
        if self.nmdot == 1:
            return np.array([self.mdotmin])
        return np.logspace(np.log10(self.mdotmin), np.log10(self.mdotmax),
                           self.nmdot)

    def mus(self):
        if self.nmu == 1:
            return np.array([self.mumin])
        return np.linspace(self.mumin, self.mumax, self.nmu)
