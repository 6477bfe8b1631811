"""The traced run's spans and its reading of the device trace.

Spans are record_function ranges that the benchmark puts around the calls
into the program's layers: each file spans/<name>.json names a function
("module:attribute", replaced wherever a module of the program holds it,
or "model:method" on the run's fluid model) and the span's name.  With
"record_args" the call's operands are kept for a reader (the gathers'
bytes).  The profiler (CPU and CUDA) records the spans, the CUDA runtime
calls and the device's kernels, copies and fills; each device operation
is put under the spans that were open on the host when it was launched
(the runtime call with its correlation id)."""

import bisect
import functools
import json
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

HERE = Path(__file__).resolve().parent
PROGRAM = "grtrans_tpu_torch"
WINDOW = "bench/window"
CALL = "bench/call"
TO_HOST = "bench/to_host"


def _kind(name):
    """"memcpy", "memset" or "kernel": what a device operation is."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def span_specs():
    """Every spans/<name>.json."""
    return [json.loads(p.read_text())
            for p in sorted((HERE / "spans").glob("*.json"))]


class Spans:
    """Installs the span wrappers; `remove()` puts the originals back."""

    def __init__(self, model):
        self.undo = []
        self.records = {}
        for spec in span_specs():
            self._install(model, spec)

    def _wrap(self, fn, spec):
        name = spec["span"]
        keep = self.records.setdefault(name, []) if spec.get("record_args") \
            else None

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if keep is not None:
                keep.append(args)
            with record_function(name):
                return fn(*args, **kwargs)
        return spanned

    def _install(self, model, spec):
        where, attr = spec["target"].split(":")
        if where == "model":
            fn = getattr(model, attr)
            model.__dict__[attr] = self._wrap(fn, spec)
            self.undo.append(lambda: model.__dict__.pop(attr, None))
            return
        __import__(where)
        fn = getattr(sys.modules[where], attr)
        new = self._wrap(fn, spec)
        for mname, mod in list(sys.modules.items()):
            if mname.split(".")[0] != PROGRAM:
                continue
            for key, val in list(vars(mod).items()):
                if val is fn:
                    setattr(mod, key, new)
                    self.undo.append(
                        lambda m=mod, k=key, v=val: setattr(m, k, v))

    def remove(self):
        for fn in reversed(self.undo):
            fn()
        self.undo = []


class Trace:
    """The device operations of a traced window, each with the spans open
    at its launch.  Times in seconds on the profiler's clock.

    ops: list of (name, start, end, spans, kind) with spans a tuple of
    span ids (outermost first) and kind "kernel", "memcpy" or "memset";
    span_name[id], span_time[id] = (start, end); count(name): spans of
    that name; records: a span's kept operands.  `spans`: the names of
    the spans (the CPU events of those names are the spans)."""

    def __init__(self, events, records, spans):
        self.records = records
        known = set(spans)
        spans, runtime, device = [], {}, []
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((name, e.start_ns() * 1e-9, e.end_ns() * 1e-9,
                               e.correlation_id()))
            elif name in known:
                spans.append((e.start_ns() * 1e-9, e.end_ns() * 1e-9, name))
            elif name.startswith("cu"):
                # a CUDA runtime or driver call: its launch time on the host
                runtime[e.correlation_id()] = e.start_ns() * 1e-9
        # the device's copies of the spans are no device work
        device = [d + (_kind(d[0]),) for d in device if d[0] not in known]
        spans.sort()
        self.span_name = [s[2] for s in spans]
        self.span_time = [(s[0], s[1]) for s in spans]
        win = [i for i, n in enumerate(self.span_name) if n == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window span")
        self.window = self.span_time[win[0]]
        self.ops, self.unlaunched = [], 0
        launched = []
        for name, t0, t1, corr, kind in device:
            t = runtime.get(corr)
            if t is None:
                self.unlaunched += 1
                t = t0
            launched.append((t, name, t0, t1, kind))
        launched.sort()
        # sweep the launch times through the spans' opening and closing
        marks = sorted([(t0, 1, i) for i, (t0, _) in
                        enumerate(self.span_time)]
                       + [(t1, 0, i) for i, (_, t1) in
                          enumerate(self.span_time)])
        open_, k = [], 0
        for t, name, t0, t1, kind in launched:
            while k < len(marks) and marks[k][0] <= t:
                _, opening, i = marks[k]
                if opening:
                    open_.append(i)
                elif i in open_:
                    open_.remove(i)
                k += 1
            self.ops.append((name, t0, t1, tuple(open_), kind))

    def count(self, name):
        return sum(1 for n in self.span_name if n == name)

    def under(self, name, without=()):
        """The ops launched inside a span `name` and in none of `without`."""
        out = []
        for op in self.ops:
            names = {self.span_name[i] for i in op[3]}
            if name in names and not names.intersection(without):
                out.append(op)
        return out

    def kernels(self):
        """The kernels (not copies or fills) launched in the window."""
        return [op for op in self.under(WINDOW) if op[4] == "kernel"]

    @staticmethod
    def busy(ops):
        return sum(op[2] - op[1] for op in ops)

    def union(self, lo, hi, ops=None):
        """Seconds of [lo, hi] in which some device op ran."""
        ivs = sorted((max(op[1], lo), min(op[2], hi))
                     for op in (self.ops if ops is None else ops)
                     if op[2] > lo and op[1] < hi)
        total, cur0, cur1 = 0.0, None, None
        for a, b in ivs:
            if cur1 is None or a > cur1:
                if cur1 is not None:
                    total += cur1 - cur0
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        if cur1 is not None:
            total += cur1 - cur0
        return total

    def window_s(self):
        return self.window[1] - self.window[0]

    def busy_s(self):
        return self.union(*self.window)

    def top_ops(self, n=10):
        """The n device operations with the most time, by name."""
        by = {}
        for name, t0, t1, _, _ in self.ops:
            by[name] = by.get(name, 0.0) + (t1 - t0)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """The device's idle time in the window by the innermost span the
        host was in when each gap began, the longest n."""
        lo, hi = self.window
        ivs = sorted((max(op[1], lo), min(op[2], hi)) for op in self.ops
                     if op[2] > lo and op[1] < hi)
        gaps, cur = [], lo
        for a, b in ivs:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if hi > cur:
            gaps.append((cur, hi))
        starts = [t[0] for t in self.span_time]
        by = {}
        for g0, g1 in gaps:
            j = bisect.bisect_right(starts, g0)
            inner = "host outside every span"
            for i in range(j - 1, -1, -1):
                if self.span_time[i][1] >= g0:
                    inner = self.span_name[i]
                    break
            by[inner] = by.get(inner, 0.0) + (g1 - g0)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def traced(run_calls, model):
    """Run `run_calls()` (the traced window) under the profiler with the
    spans installed.  Returns (its result, Trace)."""
    spans = Spans(model)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                out = run_calls()
                torch.cuda.synchronize()
    finally:
        spans.remove()
    names = {s["span"] for s in span_specs()} | {WINDOW, CALL, TO_HOST}
    return out, Trace(prof.profiler.kineto_results.events(), spans.records,
                      names)
