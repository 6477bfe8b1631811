"""Device busy time of the fluid model's sampling and conversion (spans
`fluid.vals` and `fluid.convert`, the gathers inside them included) per
sampled camera (a `fluid.vals` span), in ms."""


def read(trace):
    n = trace.count("fluid.vals")
    ops = trace.under("fluid.vals") + trace.under("fluid.convert")
    if not n or not ops:
        return None
    return trace.busy(ops) / n * 1e3
