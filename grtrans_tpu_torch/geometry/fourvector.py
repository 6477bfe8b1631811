"""Four-vector algebra on packed symmetric metrics: trailing axis 4 for
vectors, trailing axis 10 for the metric in the reference's packing
[tt, tr, tth, tph, rr, rth, rph, thth, thph, phph]
(class_four_vector.f90:5-60)."""

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
