"""Four-vector algebra on packed symmetric metrics: trailing axis 4 for
vectors, trailing axis 10 for the metric in the reference's packing
[tt, tr, tth, tph, rr, rth, rph, thth, thph, phph]
(class_four_vector.f90:5-60)."""

import torch

_PAIRS = [(0, 0), (0, 1), (0, 2), (0, 3),
          (1, 1), (1, 2), (1, 3),
          (2, 2), (2, 3),
          (3, 3)]


def dot(g, u, v):
    """Metric dot product g_{mu nu} u^mu v^nu with packed metric g."""
    out = 0.0
    for idx, (i, j) in enumerate(_PAIRS):
        if i == j:
            out = out + g[..., idx] * u[..., i] * v[..., i]
        else:
            out = out + g[..., idx] * (u[..., i] * v[..., j]
                                       + u[..., j] * v[..., i])
    return out


def _at(i, j):
    """Packed index of the symmetric entry (i, j)."""
    return _PAIRS.index((min(i, j), max(i, j)))


def unpack(g):
    """(..., 10) packed metric -> (..., 4, 4) symmetric matrix."""
    return torch.stack([torch.stack([g[..., _at(i, j)] for j in range(4)],
                                    dim=-1) for i in range(4)], dim=-2)


def lower(g, u):
    """u_mu = g_{mu nu} u^nu with the packed metric g
    (class_four_vector.f90 lower)."""
    return torch.stack([sum(g[..., _at(i, j)] * u[..., j] for j in range(4))
                        for i in range(4)], dim=-1)
