"""Numerical kernels.  quad_gather builds its CUDA kernels at their first
launch on the card, not on import."""

from grtrans_tpu_torch.ops import (bessel, elliptic, interp,  # noqa: F401
                                   polyroots, quad_gather, weierstrass)
