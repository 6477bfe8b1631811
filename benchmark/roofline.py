"""The card's published peaks and the least time of a gather.

NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): 3.35 TB/s of
HBM3, 67 TFLOP/s float32 and 33.5 TFLOP/s float64 outside the tensor
cores.  A card set below 700 W runs slower under load: the harness
prints the card's power limit beside each share."""

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}


def gather_bytes(table, idx, w, nc, nf):
    """Bytes one gather call must move: the index, the weights and the
    output once, and each distinct table row the index names once
    (out[n] = sum over the R rows and nc corners of w * table[idx], as
    quad_gather (R = 1, idx (N,)) and quad_gather_rows (idx (N, R)))."""
    n = idx.shape[0]
    size = table.element_size()
    distinct = torch.unique(idx).numel()
    return (idx.numel() * idx.element_size() + w.numel() * w.element_size()
            + n * nf * size + distinct * table.shape[1] * size)


def gather_flops(idx, w, nc, nf):
    """Operations of one gather call: a multiply and an add for each
    weight and field."""
    return 2.0 * w.numel() * nf


def gather_least_s(table, idx, w, nc, nf):
    """The least time the card could take for one gather call: the larger
    of its bytes over the memory rate and its operations over the peak."""
    return max(gather_bytes(table, idx, w, nc, nf) / HBM_BYTES_PER_S,
               gather_flops(idx, w, nc, nf) / PEAK_FLOPS[table.dtype])
