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

    def header_keys(self, freq=None, mu=None, mdot=None, t=None):
        """Run-parameter provenance for output headers: every input
        parameter plus this camera's (freq, mu, mdot, t), as the reference
        persists its inputs as FITS keywords (camera.f90:219-305)."""
        d = {}
        for name in ("standard", "mumin", "mumax", "nmu", "phi0", "spin",
                     "uout", "uin", "rcut", "nrotype", "i1", "i2", "fname",
                     "dt", "nt", "nload", "nmdot", "mdotmin", "mdotmax",
                     "sigcut", "ename", "mbh", "nfreq", "fmin", "fmax",
                     "muval", "gmin", "gmax", "p1", "p2", "jetalpha",
                     "stype", "use_geokerr", "nvals", "iname", "cflag",
                     "extra", "debug"):
            d[name] = getattr(self, name)
        for i, v in enumerate(self.gridvals):
            d[f"grid{i + 1}"] = float(v)
        for i, v in enumerate(self.nn):
            d[f"nn{i + 1}"] = int(v)
        if self.epcoefindx is not None:
            for i, v in enumerate(self.epcoefindx):
                d[f"epco{i + 1}"] = int(v)
        for k, v in self.fargs.items():
            if isinstance(v, (bool, int, float, str, np.integer,
                              np.floating)):
                d[f"f_{k}"] = v
        if freq is not None:
            d["freq"] = float(freq)
        if mu is not None:
            d["mu0cam"] = float(mu)
        if mdot is not None:
            d["mdotcam"] = float(mdot)
        if t is not None:
            d["tcam"] = float(t)
        return d

    def camera_key_dicts(self):
        """Per-camera provenance dicts in output camera order (freq
        fastest, then mdot, then time, then mu; pgrtrans.f90:198-211)."""
        return [self.header_keys(freq=f, mu=mu, mdot=md, t=it * self.dt)
                for mu in self.mus() for it in range(self.nt)
                for md in self.mdots() for f in self.freqs()]
