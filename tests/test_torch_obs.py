"""grtrans_tpu_torch.obs: the port's spans and counters.  Off outside a
profiler session (one shared no-op, counters still count), nested and
grouped by grtrans_run call under one, on the profiler's clock, never in
the profiler's trace, and the image the same either way; the set-up and
the process's first call are kept always."""

import math
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from grtrans_tpu_torch import convert, obs
from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.fluid.ffjet import load_ffjet_file
from grtrans_tpu_torch.integrate.solvers import BLK
from grtrans_tpu_torch.orchestrator import grtrans_run
from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump

REPO = Path(__file__).resolve().parents[1]
SPAN_NAMES = {"run", "trace", "vals", "convert", "render", "march",
              "gather", "sync", "setup.model", "setup.kernels",
              "setup.tables"}


def flagship(**kw):
    """The FFJET flagship camera at 8x8 x 32, lsoda."""
    base = dict(fname="FFJET", ename="POLSYNCHPL", nvals=4, spin=0.998,
                nn=(8, 8, 32), uout=0.01, mbh=3.4e9, mumin=0.906,
                mumax=0.906, fmin=3.45e11, fmax=3.45e11,
                gridvals=(-40.0, 20.0, -20.0, 40.0), iname="lsoda")
    return GrtransConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    dfile = tmp_path_factory.mktemp("obs") / "ffjet.bin"
    write_ffjet_dump(dfile, nx=32)
    m = convert.ffjet_from_arrays(*load_ffjet_file(dfile), device="cpu")
    # the process's first call, whichever test runs first
    grtrans_run(flagship(), m, device="cpu")
    return m


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def test_off_records_nothing_and_counters_count(model):
    obs.clear()
    assert obs.span("march") is obs.span("trace") is obs._NO_SPAN
    with obs.span("march") as rec:
        assert rec is None
    before = obs.counters()
    grtrans_run(flagship(), model, device="cpu")
    assert obs.records() == obs.Records([], [])
    after = obs.counters()
    assert after["march.blocks"] - before["march.blocks"] == 4
    assert after["quad_gather_ref.calls"] - \
        before["quad_gather_ref.calls"] == 3
    assert after["gather.queries"] > before["gather.queries"]


def test_spans_nest_and_share_a_call_under_the_profiler(model):
    obs.clear()
    profiled(lambda: (grtrans_run(flagship(), model, device="cpu"),
                      grtrans_run(flagship(), model, device="cpu")))
    spans = obs.records().spans
    runs = [i for i, s in enumerate(spans) if s.name == "run"]
    assert len(runs) == 2 and spans[runs[0]].call + 1 == spans[runs[1]].call
    assert spans[runs[0]].attrs == {"ncams": 1, "npix": 64}
    for i, s in enumerate(spans):
        assert s.t0_ns <= s.t1_ns
        if s.name == "run":
            assert s.parent is None
            continue
        # every span lies in its parent, and in its call's run span
        p = spans[s.parent]
        assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
        top = i
        while spans[top].parent is not None:
            top = spans[top].parent
        assert spans[top].name == "run" and spans[top].call == s.call
    parents = {(s.name, spans[s.parent].name) for s in spans
               if s.parent is not None}
    assert parents == {("trace", "run"), ("vals", "run"),
                       ("convert", "run"), ("render", "run"),
                       ("march", "render"), ("gather", "vals"),
                       ("gather", "render"), ("sync", "run"),
                       ("sync", "trace"), ("sync", "vals"),
                       ("sync", "render")}


def test_a_span_agrees_with_the_profilers_clock():
    """A span around a record_function range: both ends within 1 ms of the
    profiler's event for the range (Unix ns on both sides)."""
    def work():
        out = []
        for k in range(3):
            with obs.span("probe", k=k) as rec:
                with record_function(f"probe{k}"):
                    torch.linalg.inv(torch.eye(64) + torch.ones(64, 64))
            out.append(rec)
        return out
    recs, events = profiled(work)
    ev = {e.name(): e for e in events if e.name().startswith("probe")}
    assert len(ev) == 3
    for k, rec in enumerate(recs):
        e = ev[f"probe{k}"]
        assert abs(e.start_ns() - rec.t0_ns) < 1e6
        assert abs(e.end_ns() - rec.t1_ns) < 1e6
        assert rec.attrs == {"k": k}


def test_one_span_a_stage_and_the_march_blocks(model):
    """Two mdots and two frequencies: one run, trace and vals, a convert and
    a render a mdot, a march a frequency of each render, each of
    ceil(31 / BLK) blocks; and the host syncs of the sites passed: the two
    cameras' copies from the host (6 each), the trace's root finder's and
    quadratures' constants and its two Weierstrass inversions, the fluid's
    fill, and each render's rest frame and cutoff tables."""
    cfg = flagship(nmdot=2, mdotmin=1e15, mdotmax=2e15, nfreq=2,
                   fmax=6.9e11)
    obs.clear()
    profiled(lambda: grtrans_run(cfg, model, device="cpu"))
    recs = obs.records()
    names = Counter(s.name for s in recs.spans)
    syncs = Counter()
    for c in recs.counts:
        if c.name.startswith("sync."):
            syncs[c.name[5:]] += c.n
    assert syncs == Counter({
        "camera.make_camera": 2 * 6, "polyroots._dk": 2 * 2,
        "quadrature.gl_tensors": 5 * 2, "weierstrass.wp": 2,
        "geokerr._cumulative_phases": 1, "ffjet.vals": 1,
        "driver.render_rays": 2 * 2, "polsynchpl._g_all": 2 * 2 * 2})
    sites = Counter(s.attrs["site"] for s in recs.spans if s.name == "sync")
    assert sites == Counter({**syncs, "polyroots._dk": 2,
                             "quadrature.gl_tensors": 5,
                             "driver.render_rays": 2})
    assert names == Counter(run=1, trace=1, vals=1, convert=2, render=2,
                            march=4, sync=sum(sites.values()),
                            gather=1 + 2 * 2 * 2)
    blocks = math.ceil((cfg.nn[2] - 1) / BLK)
    assert [c.n for c in recs.counts if c.name == "march.blocks"] == \
        [blocks] * 4
    assert all(s.attrs == {"blocks": blocks} for s in recs.spans
               if s.name == "march")


def test_the_image_and_the_profile_are_the_same_with_recording(model,
                                                               monkeypatch):
    """Recording changes neither the image nor the profiler's trace: the
    same events with the program's spans on and with them switched off,
    and none of the program's span names among them."""
    off, _, _ = grtrans_run(flagship(), model, device="cpu")
    (on, _, _), events_on = profiled(
        lambda: grtrans_run(flagship(), model, device="cpu"))
    assert torch.equal(on, off)
    monkeypatch.setattr(obs, "span", lambda name, **attrs: obs._NO_SPAN)
    monkeypatch.setattr(obs, "count", lambda name, n=1: None)
    (quiet, _, _), events_off = profiled(
        lambda: grtrans_run(flagship(), model, device="cpu"))
    assert torch.equal(quiet, off)
    names_on = Counter(e.name() for e in events_on)
    assert names_on == Counter(e.name() for e in events_off)
    assert not SPAN_NAMES & set(names_on)


def test_clear_keeps_the_counters_and_refuses_inside_a_span():
    obs.count("test_obs.probe", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("probe"):
            with pytest.raises(RuntimeError):
                obs.clear()
    obs.clear()
    assert obs.records() == obs.Records([], [])
    assert obs.counters()["test_obs.probe"] >= 3


def test_the_first_call_and_the_set_up_are_kept_in_a_fresh_process(
        tmp_path):
    """Without a profiler: the model's construction and every span of the
    process's first grtrans_run call (with the POLSYNCHPL tables built on
    first use inside it) are kept; the second call keeps nothing."""
    code = f"""
from grtrans_tpu_torch import convert, obs
from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.fluid.ffjet import load_ffjet_file
from grtrans_tpu_torch.orchestrator import grtrans_run
from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump
import torch
assert not torch.autograd._profiler_enabled()
write_ffjet_dump({str(tmp_path / 'f.bin')!r}, nx=32)
m = convert.ffjet_from_arrays(*load_ffjet_file({str(tmp_path / 'f.bin')!r}),
                              device="cpu")
cfg = GrtransConfig(fname="FFJET", ename="POLSYNCHPL", nn=(4, 4, 24),
                    uout=0.01, mbh=3.4e9, spin=0.998, mumin=0.906,
                    mumax=0.906, fmin=3.45e11, fmax=3.45e11,
                    gridvals=(-40.0, 20.0, -20.0, 40.0), iname="lsoda")
grtrans_run(cfg, m, device="cpu")
spans = obs.records().spans
names = [s.name for s in spans]
assert names[0] == "setup.model" and spans[0].attrs == {{"model": "FFJet"}}
assert spans[0].call == 0 and names[1] == "run" and spans[1].call == 1
assert {{"trace", "vals", "convert", "render", "march", "gather", "sync",
        "setup.tables"}} <= set(names), names
assert all(s.call == 1 for s in spans[1:])
counts = len(obs.records().counts)
grtrans_run(cfg, m, device="cpu")
assert len(obs.records().spans) == len(spans)
assert len(obs.records().counts) == counts
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
