"""Elementary functions of a number that is a Python float on a forward
render and a 0-d tensor that requires a gradient on a differentiated one
(the spin and the observer's cos(inclination); tools/invert.py).  math's
functions would turn such a tensor into a float and drop its gradient
without an error, so each of these takes math's path for a float and
torch's for a tensor."""

import math

import torch


def sqrt(x):
    return x.sqrt() if torch.is_tensor(x) else math.sqrt(x)


def sign(x):
    """-1, 0 or 1."""
    return x.sign() if torch.is_tensor(x) else float((x > 0) - (x < 0))


def clamp_min(x, lo):
    return x.clamp_min(lo) if torch.is_tensor(x) else max(x, lo)
