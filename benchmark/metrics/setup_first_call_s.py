"""The set-up's warm-up call, the process's first grtrans_run call (the
program's span `run` of call 1, before the traced window), in s: it pays
the kernel build or load (`setup.kernels`) and the tables built on first
use (`setup.tables`)."""

from benchmark import program_spans


def read(trace):
    prog = program_spans.of(trace)
    first = [i for i in prog.before_window("run")
             if prog.spans[i][4] == 1] if prog else []
    if not first:
        return None
    return prog.seconds(first)
