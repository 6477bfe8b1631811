"""Polarized radiative-transfer integrators."""

from grtrans_tpu_torch.integrate.solvers import (  # noqa: F401
    delo_solve, formal_solve, integrate, opacity_matrix, quadrature_solve)
