"""Kernel launches of the Stokes march (kernels under the benchmark's span
`march`, around solvers.observed_stokes) per block step of its loop (the
program's counter `march.blocks`, BLK cells a step): what a march kernel
would take off each step."""

from benchmark import program_spans


def read(trace):
    prog = program_spans.ran(trace)
    blocks = prog.count("march.blocks") if prog else 0
    if not blocks:
        return None
    kernels = [op for op in trace.under("march") if op[4] == "kernel"]
    return len(kernels) / blocks
