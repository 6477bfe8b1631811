"""A cell, a configuration and a per-layer metric are added by new files
and new BENCHMARK.json entries alone: the harness finds them by name."""

import json
import shutil

import pytest

from benchmark import cells, harness
from benchmark.tests.conftest import tiny


@pytest.fixture
def added(tmp_path):
    """A checkout's copy of BENCHMARK.json with one more configuration
    (the FFJET flagship with a wider camera), one more traffic mix and
    one more cell, each in files of its own."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "checks"):
        shutil.copytree(cells.HERE / sub, bench / sub)
    m = cells.load_manifest()
    cfg = json.loads((cells.HERE / "configs" / "ffjet_m87.json").read_text())
    cfg.update(name="ffjet_wide")
    cfg["grtrans"]["gridvals"] = [-60.0, 30.0, -30.0, 60.0]
    (bench / "configs" / "ffjet_wide.json").write_text(json.dumps(cfg))
    m["configs"].append(dict(m["configs"][0], name="ffjet_wide",
                             file="benchmark/configs/ffjet_wide.json"))
    (bench / "traffic" / "incl-050-060.json").write_text(json.dumps(
        {"mu0_min": 0.5, "mu0_max": 0.6, "nmdot": 1, "mdot_min": 1e15,
         "mdot_max": 1e15, "trace_calls": 1}))
    (bench / "checks" / "ffjet-wide-incl.json").write_text(json.dumps(
        {"calls": 1, "pixels": 100, "limits": {"image_err": 1e-9}}))
    m["workloads"].append({"name": "ffjet-wide-incl", "config": "ffjet_wide",
                           "traffic": "incl-050-060", "chips": 1,
                           "why": "added by files alone"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path


def test_an_added_cell_runs_without_an_edit(added):
    cell = tiny(cells.Cell("ffjet-wide-incl", root=added))
    assert cell.config["grtrans"]["gridvals"][0] == -60.0
    assert cell.traffic["mu0_max"] == 0.6
    r = harness.run(cell, 2 ** 31 + 3, 0.2, 0, "cpu",
                    harness.time.perf_counter(), log=lambda msg: None)
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"mrays_per_s", "peak_mem_gib", "setup_s"}


def test_an_added_metric_reader_is_found(tmp_path, monkeypatch):
    from benchmark import metrics
    (tmp_path / "renders_traced.py").write_text(
        "def read(trace):\n    return float(trace.frames) or None\n")
    monkeypatch.setattr(metrics, "__path__", [*metrics.__path__,
                                              str(tmp_path)])
    reader = cells.reader("renders_traced")

    class T:
        frames = 3
    assert reader.read(T()) == 3.0


def test_every_declared_metric_and_generator_is_found():
    m = cells.load_manifest()
    for metric in m["per_layer"]:
        assert callable(cells.reader(metric["name"]).read)
    for w in m["workloads"]:
        gen = cells.Cell(w["name"]).data_gen
        assert all(callable(getattr(gen, f)) for f in
                   ("make", "program_model", "reference_model"))
