"""Packed-row table lookups as plain indexing (the reference's stand-in
for the program's gather kernels):

    quad_gather:       out[n, f] = sum_c w[n, c] * table[idx[n], c * nf + f]
    quad_gather_rows:  out[n, f] = sum_r sum_c w[n, r, c]
                                            * table[idx[n, r], c * nf + f]

and the row pairing of a linear interpolation (pair_rows).
"""

import numpy as np


def pair_rows(rows):
    """(n, f) numpy table -> (n, 2 f): row i holds rows i and i + 1 (the
    last row repeats itself; cell indices stop at n - 2)."""
    return np.concatenate([rows, np.concatenate([rows[1:], rows[-1:]])],
                          axis=1)


def quad_gather(table, idx, w, nc, nf):
    """(table[idx].view(N, nc, nf) * w).sum(corners): (N, nf)."""
    n = idx.shape[0]
    return (table[idx.long()].view(n, nc, nf) * w[..., None]).sum(-2)


def quad_gather_rows(table, idx, w, nc, nf):
    """The R rows of each query, viewed (N, R, nc, nf), weighted and
    summed over rows and corners: (N, nf)."""
    n, r = idx.shape
    rows = table[idx.long().reshape(-1)].view(n, r, nc, nf)
    return (rows * w[..., None]).sum((1, 2))


