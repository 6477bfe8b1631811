"""The program's own spans and counters (grtrans_tpu_torch.obs) in a traced
run, set against the device trace.

The program stamps its spans with time.time_ns(), the clock the profiler
gives its events (Unix time), which tracing.Trace keeps in seconds: so a
span of the program and a device operation of the trace can be compared
directly.  `of(trace)` gathers the program's records once a trace, or
gives None where the program keeps none (a version without obs), so that
every reader of them then returns None."""

import bisect
import math

NOWHERE = "host outside every program span"


def _records():
    """The program's records, or None where it keeps none."""
    try:
        from grtrans_tpu_torch import obs
    except ImportError:
        return None
    return obs.records()


class Program:
    """The program's spans and counter events against one Trace.

    spans: (name, t0, t1, parent, call, attrs) in seconds, every span in
    record order (parent indexes this list); inside: the indices
    of the spans that lie in the trace's window; events: (name, t, n) of
    the counter events in the window."""

    def __init__(self, records, trace):
        self.trace = trace
        lo, hi = trace.window
        # a span still open ends never
        self.spans = [(s.name, s.t0_ns * 1e-9,
                       math.inf if s.t1_ns is None else s.t1_ns * 1e-9,
                       s.parent, s.call, s.attrs) for s in records.spans]
        self.inside = [i for i, s in enumerate(self.spans)
                       if lo <= s[1] and s[2] <= hi]
        self.events = [(c.name, c.t_ns * 1e-9, c.n) for c in records.counts
                       if lo <= c.t_ns * 1e-9 <= hi]

    def ran(self):
        """Whether the window holds a grtrans_run call of the program."""
        return any(self.spans[i][0] == "run" for i in self.inside)

    def named(self, name):
        """The window's spans `name` that lie in no other span `name`."""
        out = []
        for i in self.inside:
            if self.spans[i][0] == name and not self.within(i, name):
                out.append(i)
        return out

    def within(self, i, name):
        """Whether span i lies in a span `name`."""
        p = self.spans[i][3]
        while p is not None:
            if self.spans[p][0] == name:
                return True
            p = self.spans[p][3]
        return False

    def seconds(self, idx):
        return sum(self.spans[i][2] - self.spans[i][1] for i in idx)

    def count(self, name):
        """The window's events of the counter `name` or of the counters
        under it ("sync" counts "sync.<site>"), summed."""
        return sum(n for c, _, n in self.events
                   if c == name or c.startswith(name + "."))

    def before_window(self, name):
        """The spans `name` that ended before the window began (the set-up)
        and lie in no other span `name`."""
        lo = self.trace.window[0]
        return [i for i, s in enumerate(self.spans)
                if s[0] == name and s[2] <= lo and not self.within(i, name)]

    def idle(self):
        """The device's idle gaps in the window, each with the innermost
        span of the program the host was in when it began: a list of
        (span index or None, seconds)."""
        lo, hi = self.trace.window
        ivs = sorted((max(op[1], lo), min(op[2], hi))
                     for op in self.trace.ops if op[2] > lo and op[1] < hi)
        gaps, cur = [], lo
        for a, b in ivs:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if hi > cur:
            gaps.append((cur, hi))
        # in record order a span opens after every span it lies in
        starts = [self.spans[i][1] for i in self.inside]
        out = []
        for g0, g1 in gaps:
            inner = None
            for k in range(bisect.bisect_right(starts, g0) - 1, -1, -1):
                i = self.inside[k]
                if self.spans[i][2] >= g0:
                    inner = i
                    break
            out.append((inner, g1 - g0))
        return out

    def idle_by_name(self):
        """The device's idle seconds in the window by the name of the
        innermost program span (NOWHERE outside every span)."""
        by = {}
        for i, sec in self.idle():
            name = NOWHERE if i is None else self.spans[i][0]
            by[name] = by.get(name, 0.0) + sec
        return by


def of(trace):
    """The Program of the trace (once a trace), or None where the program
    keeps no records."""
    if not hasattr(trace, "program"):
        recs = _records()
        trace.program = None if recs is None else Program(recs, trace)
    return trace.program


def ran(trace):
    """The Program of the trace where its window holds a call of the
    program, else None."""
    prog = of(trace)
    return prog if prog is not None and prog.ran() else None
