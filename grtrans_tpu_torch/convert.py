"""Carry configuration and model state over from grtrans_tpu objects, so
both packages compute from identical inputs.  Takes plain Python and
numpy values only; nothing here imports JAX."""

import dataclasses

from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.fluid.base import load_fluid_model
from grtrans_tpu_torch.fluid.disks import NumDisk, PhatDisk
from grtrans_tpu_torch.fluid.ffjet import FFJet
from grtrans_tpu_torch.fluid.sphacc import SphAcc

_ANALYTIC = ("HOTSPOT", "POWERLAW", "SARIAF", "SCHNITTMAN", "THINDISK", "TOY")
_TABLE_MODELS = {"PHATDISK": PhatDisk, "NUMDISK": NumDisk, "SPHACC": SphAcc}
_GRMHD = ("HARM", "HARM3D", "IHARM", "HARMPI", "THICKDISK", "MB09", "KORAL",
          "KORALNTH", "KORAL3D", "KORAL3D_DISK", "KORAL3D_TOPJET",
          "KORAL3D_BOTJET")


def config_from_jax(cfg):
    """GrtransConfig with the field values of a grtrans_tpu config."""
    names = {f.name for f in dataclasses.fields(GrtransConfig)}
    return GrtransConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)
                            if f.name in names})


def ffjet_from_arrays(grids, fields, device, ntscl=2.0, nrscl=70.0):
    """FFJet model on `device` from the (grids, fields) numpy dicts that
    `load_ffjet_file` returns."""
    return FFJet(grids, fields, ntscl=ntscl, nrscl=nrscl, device=device)


def analytic_from_fields(name, fields, device):
    """The port's analytic model `name` (one of _ANALYTIC) on `device`
    from a dict of the grtrans_tpu dataclass's fields
    (dataclasses.asdict of it)."""
    if name.upper() not in _ANALYTIC:
        raise NotImplementedError(f"no analytic model {name!r} in the port")
    return load_fluid_model(name, device=device, **fields)


def table_model_from_arrays(name, device, **tables):
    """The port's PHATDISK, NUMDISK or SPHACC on `device` from the tables
    of the grtrans_tpu model as numpy arrays, named as the port's class
    takes them: PHATDISK freq_tab, r_tab, om_tab, fnu_tab; NUMDISK table
    (the dict with nr, nphi, r, phi, T); SPHACC r_tab, v_tab, T_tab."""
    cls = _TABLE_MODELS.get(name.upper())
    if cls is None:
        raise NotImplementedError(f"no table model {name!r} in the port")
    return cls(**tables, device=device)


def grmhd_model_from_arrays(name, device, **dump_or_fields):
    """The port's GRMHD snapshot model `name` (one of _GRMHD) on `device`
    from the arguments the grtrans_tpu dataclass of the same name takes:
    dump= the numpy dump dict (the one handed to grtrans_tpu, so that both
    packages load identical arrays) or dfile= / hfile= / gfile= paths, plus
    the model's own options (mdot_code, scalefac, nrelbin, jonfix, ...)."""
    if name.upper() not in _GRMHD:
        raise NotImplementedError(f"no GRMHD model {name!r} in the port")
    return load_fluid_model(name, device=device, **dump_or_fields)
