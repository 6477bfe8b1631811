"""Places where the host waited on the device (the program's counters
`sync.<site>`) in the traced window per render."""

from benchmark import program_spans


def read(trace):
    prog = program_spans.ran(trace)
    if prog is None or not trace.frames:
        return None
    return prog.count("sync") / trace.frames
