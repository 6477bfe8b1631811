"""Kerr null geodesics: the camera and the semi-analytic trace."""

from grtrans_tpu_torch.geodesics import camera, geokerr  # noqa: F401
from grtrans_tpu_torch.geodesics.geokerr import (  # noqa: F401
    GeodesicBundle, trace, trace_polar)
