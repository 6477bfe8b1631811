"""Fluid models: the sampled state, its conversion to cgs, the registry."""

from grtrans_tpu_torch.fluid import base  # noqa: F401
from grtrans_tpu_torch.fluid.base import (  # noqa: F401
    FluidVars, SourceParams, convert_fluid_vars, get_fluid_vars,
    load_fluid_model)
