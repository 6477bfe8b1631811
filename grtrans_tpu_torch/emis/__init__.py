"""Emission, absorption and Faraday coefficients."""

from grtrans_tpu_torch.emis import bb, framework, polsynch  # noqa: F401
