"""Carry configuration and model state over from grtrans_tpu objects, so
both packages compute from identical inputs.  Takes plain Python and
numpy values only; nothing here imports JAX."""

import dataclasses

from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.fluid.base import load_fluid_model
from grtrans_tpu_torch.fluid.ffjet import FFJet


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
    """The port's POWERLAW / SARIAF / TOY model on `device` from a dict of
    the grtrans_tpu dataclass's fields (dataclasses.asdict of it)."""
    if name.upper() not in ("POWERLAW", "SARIAF", "TOY"):
        raise NotImplementedError(f"no analytic model {name!r} in the port")
    return load_fluid_model(name, device=device, **fields)
