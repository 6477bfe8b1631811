"""Spans and counters of the port's layers.

    with obs.span("march", blocks=n): ...      # a layer's host time
    obs.count("march.blocks", n)               # a process-wide counter

A span records its name, its start and end on the host (`t0_ns`, `t1_ns`,
from time.time_ns()), the index of the recorded span it opened in
(`parent`, None at the top), the id of the grtrans_run call it belongs to
(`call`, 0 outside any; `run` gives each call the next id) and its
keyword attributes.  Spans are recorded while a torch.profiler session
records, and never otherwise, with two kinds of one-off spans kept
always: the set-up spans (`setup`: the kernel build, a fluid model's
construction, a table built on first use) and every span of the
process's first grtrans_run call, which pays the first-use costs.  Off,
`span` returns one shared no-op after a single check of the profiler.

Counters always count (`counters()`); while spans are recorded, each
`count` also records a time-stamped event, so that a reader can count
within a window.  `records()` returns both kinds of records, `clear()`
drops them.

time.time_ns() is the clock the profiler gives its events (Unix ns), so
a reader can set the program's spans against the device operations of
the same session.  Nothing here enters the profiler's trace: no
record_function range, no NVTX range, no kernel, no device memory (a
record_function range would also appear on the device's timeline as an
annotation of its own)."""

import collections
import contextlib
import dataclasses
import functools
import time
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    t0_ns: int
    t1_ns: Optional[int]     # None while the span is open
    parent: Optional[int]    # index in records().spans
    call: int
    attrs: dict


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int
    call: int


class Records(NamedTuple):
    spans: list
    counts: list


_spans = []                  # recorded spans, in the order they opened
_counts = []                 # recorded counter events
_open = []                   # indices of the recorded spans now open
_counters = collections.Counter()
_calls = 0                   # grtrans_run calls begun in this process
_call = 0                    # the call the host is in
_first = False               # in the process's first call: keep every span


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Recorded:
    __slots__ = ("name", "attrs", "rec")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.rec = Span(self.name, time.time_ns(), None,
                        _open[-1] if _open else None, _call, self.attrs)
        _open.append(len(_spans))
        _spans.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        self.rec.t1_ns = time.time_ns()
        _open.pop()
        return False


def span(name, **attrs):
    """A context manager that records the host's time inside it as the
    span `name` while spans are recorded (its `as` target is the Span, or
    None when off)."""
    if _first or torch.autograd._profiler_enabled():
        return _Recorded(name, attrs)
    return _NO_SPAN


def spanned(name):
    """Decorator: each call of the function is the span `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return deco


def setup(what, **attrs):
    """The set-up span "setup.<what>", recorded always."""
    return _Recorded(f"setup.{what}", attrs)


def model_setup(init):
    """Decorator of a fluid model's __init__: its construction is the
    set-up span "setup.model" (attribute `model`, the class's name)."""
    @functools.wraps(init)
    def inner(self, *args, **kwargs):
        with setup("model", model=type(self).__name__):
            init(self, *args, **kwargs)
    return inner


@contextlib.contextmanager
def run(**attrs):
    """The span `run` around one grtrans_run call; the call takes the next
    call id, and the process's first call keeps every span."""
    global _calls, _call, _first
    outer = _call, _first
    _calls += 1
    _call, _first = _calls, _first or _calls == 1
    try:
        with span("run", **attrs) as rec:
            yield rec
    finally:
        _call, _first = outer


def count(name, n=1):
    """Add n to the counter `name`; while spans are recorded, also record
    the event."""
    _counters[name] += n
    if _first or torch.autograd._profiler_enabled():
        _counts.append(Count(name, time.time_ns(), n, _call))


def sync(site, n=1):
    """The span "sync" (attribute `site`) around a place where the host
    waits on the device: n synchronizing operations (a value read back, a
    blocking copy from host memory), counted as "sync.<site>"."""
    count(f"sync.{site}", n)
    return span("sync", site=site)


def counters():
    """A copy of every counter (a Counter: names not counted read 0)."""
    return collections.Counter(_counters)


def records():
    """The spans and counter events recorded so far."""
    return Records(list(_spans), list(_counts))


def clear():
    """Drop the recorded spans and counter events (not the counters);
    outside every span."""
    if _open:
        raise RuntimeError("obs.clear() inside a span")
    _spans.clear()
    _counts.clear()
