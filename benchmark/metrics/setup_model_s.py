"""The set-up's construction of the program's fluid model (the program's
set-up spans `setup.model` that ended before the traced window), in s."""

from benchmark import program_spans


def read(trace):
    prog = program_spans.of(trace)
    spans = prog.before_window("setup.model") if prog else []
    if not spans:
        return None
    return prog.seconds(spans)
