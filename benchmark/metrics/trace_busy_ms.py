"""Device busy time of the geodesic trace (spans `geodesics`) per traced
camera, in ms."""


def read(trace):
    n = trace.count("geodesics")
    ops = trace.under("geodesics")
    if not n or not ops:
        return None
    return trace.busy(ops) / n * 1e3
