"""The host's time in the fluid model's sampling and conversion (the
program's spans `vals` and `convert`, the gathers inside them included)
per sampled camera (a `vals` span), in ms."""

from benchmark import program_spans


def read(trace):
    prog = program_spans.ran(trace)
    vals = prog.named("vals") if prog else []
    if not vals:
        return None
    return (prog.seconds(vals) + prog.seconds(prog.named("convert"))) \
        / len(vals) * 1e3
