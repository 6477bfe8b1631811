"""The device's idle share while it runs the Stokes march: for each
`march` span, the device interval from the start of its first operation
to the end of its last, less the time any operation ran in it, summed
over the spans; in %."""


def read(trace):
    total = idle = 0.0
    for i, name in enumerate(trace.span_name):
        if name != "march":
            continue
        ops = [op for op in trace.ops if i in op[3]]
        if not ops:
            continue
        lo = min(op[1] for op in ops)
        hi = max(op[2] for op in ops)
        total += hi - lo
        idle += (hi - lo) - trace.union(lo, hi)
    if total <= 0.0:
        return None
    return 100.0 * idle / total
