"""Device busy time of the Stokes march (span `march`) per render, in ms."""


def read(trace):
    n = trace.count("render")
    ops = trace.under("march")
    if not n or not ops:
        return None
    return trace.busy(ops) / n * 1e3
