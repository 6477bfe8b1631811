"""The host's time in the geodesic trace (the program's span `trace`) per
traced camera, in ms."""

from benchmark import program_spans


def read(trace):
    prog = program_spans.ran(trace)
    spans = prog.named("trace") if prog else []
    if not spans:
        return None
    return prog.seconds(spans) / len(spans) * 1e3
