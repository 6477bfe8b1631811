"""Float -> int32 conversion with XLA's semantics.

XLA converts NaN to 0 and saturates +-inf / out-of-range values to the
int32 limits; a plain `.to(torch.int32)` is undefined there (x86 gives
INT_MIN for all of them).  Table indices derived from NaN radii must land
on the same row as in `grtrans_tpu`, so every float -> index cast goes
through this helper.
"""

import torch

_I32_MIN = -2147483648.0
_I32_MAX = 2147483647.0


def to_int32(x):
    """Truncate toward zero to int32; NaN -> 0, saturating at the limits."""
    x = torch.nan_to_num(x, nan=0.0, posinf=_I32_MAX, neginf=_I32_MIN)
    return x.clamp(_I32_MIN, _I32_MAX).to(torch.int32)


def trunc_clip(x, hi):
    """`clip(int32(x), 0, hi)` as XLA computes it.  Clamping in float
    first is equivalent for every input (truncation is monotone) and
    keeps the cast in range."""
    x = torch.nan_to_num(x, nan=0.0)
    return x.clamp(0.0, float(hi)).to(torch.int32)
