"""The host's time in the Stokes march's block loop (the program's span
`march`) per render (a `render` span), in ms: the time the host takes to
issue the march, against march_busy_ms, the device's time in it."""

from benchmark import program_spans


def read(trace):
    prog = program_spans.ran(trace)
    renders = prog.named("render") if prog else []
    if not renders:
        return None
    return prog.seconds(prog.named("march")) / len(renders) * 1e3
