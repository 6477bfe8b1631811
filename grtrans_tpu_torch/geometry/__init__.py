"""Kerr metric, four-vectors and the comoving tetrad."""

from grtrans_tpu_torch.geometry import fourvector, kerr, tetrad  # noqa: F401
