"""Reading and writing the reference's binary and FITS outputs."""

from grtrans_tpu_torch.io import binio, fitsio  # noqa: F401
