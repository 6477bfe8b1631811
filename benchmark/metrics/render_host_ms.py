"""The host's time in driver.render_rays outside the Stokes march (the
program's span `render` less its spans `march`) per render, in ms."""

from benchmark import program_spans


def read(trace):
    prog = program_spans.ran(trace)
    renders = prog.named("render") if prog else []
    if not renders:
        return None
    inner = [i for i in prog.named("march") if prog.within(i, "render")]
    return (prog.seconds(renders) - prog.seconds(inner)) \
        / len(renders) * 1e3
