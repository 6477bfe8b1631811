"""The readers of the program's own spans and counters (program_spans.py
and the nine metrics on it) on a hand-made trace and hand-made records,
and once on a real render under the CPU profiler."""

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import cells, program_spans, tracing
from benchmark.tests.test_bench_arith import Ev
from grtrans_tpu_torch import obs

NEW = ("trace_host_ms", "fluid_host_ms", "render_host_ms", "march_host_ms",
       "march_launches_per_block", "host_syncs_per_frame", "sync_idle_ms",
       "setup_model_s", "setup_first_call_s")


def ns(t):
    return int(round(t * 1e9))


def hand_records(sync=True):
    """The set-up (a model built over 0.5-1.5 s, the first call 2-4 s with
    the kernel load and a table inside) and, in the window 10-20 s, one
    call: a trace with a host sync in it (unless not `sync`), a fluid
    sample with a gather, a conversion, and a render whose march counts 50
    blocks."""
    spans, counts = [], []

    def span(name, t0, t1, parent, call, **attrs):
        spans.append(obs.Span(name, ns(t0), ns(t1), parent, call, attrs))
        return len(spans) - 1

    span("setup.model", 0.5, 1.5, None, 0, model="FFJet")
    first = span("run", 2.0, 4.0, None, 1)
    span("setup.kernels", 2.1, 2.6, first, 1, built=False)
    span("setup.tables", 3.0, 3.2, first, 1, table="polsynchpl.G")
    run = span("run", 10.2, 19.5, None, 2, ncams=1, npix=4)
    tr = span("trace", 10.3, 11.3, run, 2)
    if sync:
        span("sync", 10.5, 10.8, tr, 2, site="weierstrass.wp")
        counts.append(obs.Count("sync.weierstrass.wp", ns(10.5), 1, 2))
    vals = span("vals", 11.5, 12.0, run, 2)
    span("gather", 11.6, 11.7, vals, 2, op="quad_gather")
    span("convert", 12.0, 12.2, run, 2)
    render = span("render", 12.5, 18.5, run, 2)
    counts.append(obs.Count("march.blocks", ns(14.0), 50, 2))
    span("march", 14.0, 18.0, render, 2, blocks=50)
    return obs.Records(spans, counts)


def hand_trace():
    """The benchmark's spans and the device's operations of that window:
    a kernel before the sync (10.4-10.6) and one after it (10.9-11.2),
    three in the march (launched at 14.1, 15, 16, each 0.5 s), one in the
    render after the march (18.1-18.3) and a copy to the host
    (19.6-19.7)."""
    ev = [Ev(tracing.WINDOW, 10, 20), Ev(tracing.CALL, 10.1, 19.55),
          Ev("geodesics", 10.25, 11.4), Ev("render", 12.4, 18.6),
          Ev("march", 13.9, 18.05)]
    ops = [("k1", 10.4, 10.6), ("k2", 10.9, 11.2), ("k3", 14.1, 14.6),
           ("k4", 15.0, 15.5), ("k5", 16.0, 16.5), ("k6", 18.1, 18.3),
           ("Memcpy DtoH (Device -> Pageable)", 19.6, 19.7)]
    for c, (name, t0, t1) in enumerate(ops, start=1):
        ev += [Ev("cudaLaunchKernel", t0, t0 + 0.001, c),
               Ev(name, t0, t1, c, True)]
    tr = tracing.Trace(ev, {}, {tracing.WINDOW, tracing.CALL, "geodesics",
                                "render", "march"})
    tr.frames, tr.calls = 1, 1
    return tr


@pytest.fixture
def records(monkeypatch):
    recs = hand_records()
    monkeypatch.setattr(program_spans, "_records", lambda: recs)
    return recs


def read_all(tr):
    return {m: cells.reader(m).read(tr) for m in NEW}


def test_every_new_metric_is_declared():
    declared = {m["name"]: m for m in cells.load_manifest()["per_layer"]}
    for m in NEW:
        assert declared[m]["source"] in ("program_span", "program_counter",
                                         "device_trace")


def test_readers_on_hand_records(records):
    got = read_all(hand_trace())
    assert got["trace_host_ms"] == pytest.approx(1000.0)
    assert got["fluid_host_ms"] == pytest.approx(700.0)
    assert got["render_host_ms"] == pytest.approx(2000.0)
    assert got["march_host_ms"] == pytest.approx(4000.0)
    assert got["march_launches_per_block"] == pytest.approx(3 / 50)
    assert got["host_syncs_per_frame"] == 1
    assert got["sync_idle_ms"] == pytest.approx(300.0)
    assert got["setup_model_s"] == pytest.approx(1.0)
    assert got["setup_first_call_s"] == pytest.approx(2.0)


def test_idle_goes_to_the_innermost_program_span(records):
    prog = program_spans.of(hand_trace())
    by = prog.idle_by_name()
    # the gaps by where they began: 10-10.4 before the call's first span
    # and 19.7-20 after the call (outside every span); 10.6-10.9 in the
    # sync; 11.2-14.1 in the trace; 14.6-15, 15.5-16 and 16.5-18.1 in the
    # march; 18.3-19.6 in the render after its march
    assert by == pytest.approx({program_spans.NOWHERE: 0.4 + 0.3,
                                "sync": 0.3, "trace": 2.9,
                                "march": 0.4 + 0.5 + 1.6, "render": 1.3})
    assert sum(by.values()) == pytest.approx(
        10.0 - hand_trace().busy_s())


def test_nested_spans_of_one_name_count_once(monkeypatch):
    recs = hand_records()
    # a trace inside the trace (camera_delay in trace, say)
    recs.spans.append(obs.Span("trace", ns(10.4), ns(10.45), 5, 2, {}))
    monkeypatch.setattr(program_spans, "_records", lambda: recs)
    assert cells.reader("trace_host_ms").read(hand_trace()) == \
        pytest.approx(1000.0)


def test_a_window_without_syncs_reads_zero(monkeypatch):
    recs = hand_records(sync=False)
    monkeypatch.setattr(program_spans, "_records", lambda: recs)
    got = read_all(hand_trace())
    assert got["host_syncs_per_frame"] == 0
    assert got["sync_idle_ms"] == 0.0
    assert got["render_host_ms"] == pytest.approx(2000.0)


def test_a_program_without_records_reads_none(monkeypatch):
    """The parent of obs: no records, so every new reader gives None (and
    the traced run leaves those metrics out of its line)."""
    monkeypatch.setattr(program_spans, "_records", lambda: None)
    assert all(v is None for v in read_all(hand_trace()).values())


def test_records_outside_the_window_read_none(monkeypatch):
    """Records of other calls (a window with no call of the program, and
    no set-up before it) give nothing to read."""
    recs = hand_records()
    late = obs.Records([obs.Span(s.name, s.t0_ns + ns(100),
                                 s.t1_ns + ns(100), s.parent, s.call,
                                 s.attrs) for s in recs.spans], [])
    monkeypatch.setattr(program_spans, "_records", lambda: late)
    assert all(v is None for v in read_all(hand_trace()).values())


def test_a_real_render_under_the_cpu_profiler(tmp_path):
    """The program's spans of a tiny FFJET render, recorded under a CPU
    profiler session, lie in the profiler's window on its clock, and the
    host-time readers find them."""
    from grtrans_tpu_torch import convert
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid.ffjet import load_ffjet_file
    from grtrans_tpu_torch.orchestrator import grtrans_run
    from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump

    write_ffjet_dump(tmp_path / "ffjet.bin", nx=32)
    cfg = GrtransConfig(fname="FFJET", ename="POLSYNCHPL", nvals=4,
                        spin=0.998, nn=(4, 4, 24), uout=0.01, mbh=3.4e9,
                        mumin=0.906, mumax=0.906, fmin=3.45e11,
                        fmax=3.45e11, gridvals=(-40.0, 20.0, -20.0, 40.0),
                        iname="lsoda")
    model = convert.ffjet_from_arrays(
        *load_ffjet_file(tmp_path / "ffjet.bin"), device="cpu")
    grtrans_run(cfg, model, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW):
            grtrans_run(cfg, model, device="cpu")
    tr = tracing.Trace(prof.profiler.kineto_results.events(), {},
                       {tracing.WINDOW})
    tr.frames, tr.calls = 1, 1
    prog = program_spans.ran(tr)
    assert prog is not None
    names = [prog.spans[i][0] for i in prog.inside]
    assert names.count("run") == names.count("render") == 1
    assert names.count("march") == 1 and prog.count("march.blocks") == 3
    got = read_all(tr)
    for m in ("trace_host_ms", "fluid_host_ms", "render_host_ms",
              "march_host_ms", "host_syncs_per_frame"):
        assert got[m] is not None and got[m] >= 0.0
    # the two cameras' copies (12), the trace's constants (14) and its two
    # inversions, the cut's window, the fluid's fill, the render's rest
    # frame (2) and its two cutoff tables
    assert got["host_syncs_per_frame"] == 12 + 14 + 2 + 1 + 1 + 2 + 2
