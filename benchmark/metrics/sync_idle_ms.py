"""The device's idle time in gaps that began while the host waited on it
(innermost program span `sync`) per render, in ms: the queue drained by
a host sync until the next launch reaches the device."""

from benchmark import program_spans


def read(trace):
    prog = program_spans.ran(trace)
    if prog is None or not trace.frames:
        return None
    return prog.idle_by_name().get("sync", 0.0) / trace.frames * 1e3
