"""Kernel launches in the traced window over the renders it completed."""


def read(trace):
    if not trace.frames:
        return None
    return len(trace.kernels()) / trace.frames
