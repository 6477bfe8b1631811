"""Device busy time of driver.render_rays outside the Stokes march (span
`render` less span `march`) per render, in ms."""


def read(trace):
    n = trace.count("render")
    ops = trace.under("render", without=("march",))
    if not n or not ops:
        return None
    return trace.busy(ops) / n * 1e3
