"""The benchmark's arithmetic on hand-made operands: the window's rate,
the traffic, a gather's bytes, and the reading of a device trace into
the per-layer metrics."""

import itertools
import math

import numpy as np
import pytest
import torch

from benchmark import cells, harness, roofline, tracing


def test_window_counts_every_call_and_the_whole_time():
    clock = itertools.count()
    made = []

    def program(mu0, mdots):
        made.append(mu0)
        return torch.zeros(len(mdots), 6, 4)

    orig = harness.time.perf_counter
    harness.time.perf_counter = lambda: float(next(clock))
    try:
        done, wall = harness.window(program, iter([(0.5, [1.0])] * 100), 3.0)
    finally:
        harness.time.perf_counter = orig
    # calls start at 0, 1, 2 (clock reads 1, 2, 3 after them): 3 calls,
    # the window from the first read to the read after the last call
    assert len(done) == len(made) == 3
    assert wall == 4.0
    frames = sum(iv.shape[0] for _, _, iv in done)
    assert frames * 6 / wall / 1e6 == pytest.approx(3 * 6 / 4.0 / 1e6)


def test_calls_are_spread_distinct_and_seeded():
    traffic = {"mu0_min": 0.3, "mu0_max": 0.9, "nmdot": 8,
               "mdot_min": 1e13, "mdot_max": 1e14}
    a = list(itertools.islice(cells.calls(traffic, 2 ** 31 + 5), 50))
    b = list(itertools.islice(cells.calls(traffic, 2 ** 31 + 5), 50))
    c = list(itertools.islice(cells.calls(traffic, 2 ** 31 + 6), 50))
    assert a == b and a != c
    mus = [m for m, _ in a]
    assert len(set(mus)) == 50 and min(mus) >= 0.3 and max(mus) <= 0.9
    # an even spread: every tenth of the range holds 3 to 7 of 50
    counts = np.histogram(mus, bins=10, range=(0.3, 0.9))[0]
    assert counts.min() >= 3 and counts.max() <= 7
    mdots = a[0][1]
    assert len(mdots) == 8 and mdots[0] == pytest.approx(1e13)
    assert mdots[-1] == pytest.approx(1e14)
    assert np.allclose(np.diff(np.log(mdots)), math.log(10) / 7)


def test_gather_bytes_and_least_time():
    table = torch.zeros(10, 2 * 9, dtype=torch.float64)
    idx = torch.tensor([1, 1, 3, 7], dtype=torch.int32)
    w = torch.zeros(4, 2, dtype=torch.float64)
    # index 4 x 4, weights 8 x 8, output 4 x 9 x 8, 3 distinct rows of 144
    assert roofline.gather_bytes(table, idx, w, 2, 9) == \
        16 + 64 + 288 + 3 * 144
    rows = torch.tensor([[0, 2], [2, 2]], dtype=torch.int32)
    wr = torch.zeros(2, 2, 2, dtype=torch.float32)
    t32 = torch.zeros(5, 2 * 3, dtype=torch.float32)
    # index 4 x 4, weights 8 x 4, output 2 x 3 x 4, 2 distinct rows of 24
    assert roofline.gather_bytes(t32, rows, wr, 2, 3) == 16 + 32 + 24 + 48
    least = roofline.gather_least_s(table, idx, w, 2, 9)
    assert least == pytest.approx((16 + 64 + 288 + 432) / 3.35e12)


class Ev:
    """A profiler event as the trace reader takes it."""

    def __init__(self, name, t0, t1, corr=0, device=False):
        self._n, self._t0, self._t1, self._c = name, t0, t1, corr
        self._d = device

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._t0 * 1e9)

    def end_ns(self):
        return int(self._t1 * 1e9)

    def correlation_id(self):
        return self._c

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d \
            else torch.autograd.DeviceType.CPU


def hand_trace():
    """A window of 10 s: one call with a trace (launch at 1, kernel 1-3),
    a fluid sample with a gather (launch 4, kernel 4-5) and a render with
    a march (launches 6 and 7, kernels 6-7 and 8-8.5); the device's copy
    of a span and a copy to the host (9-9.5) besides."""
    ev = [Ev(tracing.WINDOW, 0, 10), Ev(tracing.CALL, 0.5, 9.8),
          Ev("geodesics", 0.8, 1.5), Ev("fluid.vals", 3.5, 4.5),
          Ev("gather", 3.9, 4.2), Ev("render", 5.5, 7.5),
          Ev("march", 6.5, 7.2), Ev(tracing.TO_HOST, 8.9, 9.7),
          Ev("cudaLaunchKernel", 1.0, 1.01, 1),
          Ev("cudaLaunchKernel", 4.0, 4.01, 2),
          Ev("cudaLaunchKernel", 6.0, 6.01, 3),
          Ev("cudaLaunchKernel", 7.0, 7.01, 4),
          Ev("cudaMemcpyAsync", 9.0, 9.01, 5),
          Ev("aten::mul", 1.0, 1.02, 1),
          Ev("trace_k", 1.0, 3.0, 1, True), Ev("gather_k", 4.0, 5.0, 2, True),
          Ev("render_k", 6.0, 7.0, 3, True), Ev("march_k", 8.0, 8.5, 4, True),
          Ev("Memcpy DtoH (Device -> Pageable)", 9.0, 9.5, 5, True),
          Ev("render", 6.0, 7.0, 0, True)]
    names = {"geodesics", "fluid.vals", "gather", "render", "march",
             tracing.WINDOW, tracing.CALL, tracing.TO_HOST}
    idx = torch.tensor([0, 0, 1], dtype=torch.int32)
    table = torch.zeros(2, 8, dtype=torch.float64)
    w = torch.zeros(3, 2, dtype=torch.float64)
    tr = tracing.Trace(ev, {"gather": [(table, idx, w, 2, 4)]}, names)
    tr.frames, tr.calls = 1, 1
    return tr


def test_trace_puts_each_op_under_its_spans():
    tr = hand_trace()
    assert tr.unlaunched == 0 and len(tr.ops) == 5
    assert [op[0] for op in tr.under("gather")] == ["gather_k"]
    assert [op[0] for op in tr.under("render", without=("march",))] == \
        ["render_k"]
    assert len(tr.kernels()) == 4
    assert tr.window_s() == pytest.approx(10.0)
    assert tr.busy_s() == pytest.approx(2 + 1 + 1 + 0.5 + 0.5)


def test_readers_on_the_hand_trace():
    tr = hand_trace()
    read = {m["name"]: cells.reader(m["name"]).read(tr)
            for m in cells.load_manifest()["per_layer"]}
    assert read["launches_per_frame"] == 4
    assert read["trace_busy_ms"] == pytest.approx(2000.0)
    assert read["fluid_busy_ms"] == pytest.approx(1000.0)
    assert read["render_busy_ms"] == pytest.approx(1000.0)
    assert read["march_busy_ms"] == pytest.approx(500.0)
    assert read["march_idle_pct"] == pytest.approx(0.0)
    assert read["idle_pct"] == pytest.approx(50.0)
    bytes_ = 3 * 4 + 6 * 8 + 3 * 4 * 8 + 2 * 64
    assert read["gather_roofline"] == pytest.approx(
        100.0 * bytes_ / 3.35e12 / 1.0)
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(5.0)
    # the gap 7-8 began while the host was in the march
    assert gaps["march"] == pytest.approx(1.0)
    assert gaps[tracing.TO_HOST] == pytest.approx(0.5)
    top = dict(tr.top_ops())
    assert top["trace_k"] == pytest.approx(2.0)


def test_a_reader_with_nothing_to_read_returns_none():
    tr = hand_trace()
    tr.ops = []
    tr.records = {}
    for m in cells.load_manifest()["per_layer"]:
        if m["name"] in ("idle_pct", "launches_per_frame"):
            continue
        assert cells.reader(m["name"]).read(tr) is None
