"""Gauss-Legendre nodes on [0, 1] (numpy, cached; callers move them to
their device and dtype)."""

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def gl_nodes(n):
    """(nodes, weights) for n-point Gauss-Legendre on [0, 1], as numpy."""
    x, w = np.polynomial.legendre.leggauss(n)
    return ((x + 1.0) / 2.0, w / 2.0)
