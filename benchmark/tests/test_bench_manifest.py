"""BENCHMARK.json against the benchmark's contract: its keys, names,
units and limits, and every file it names or implies."""

import importlib
import json
import re

import pytest

from benchmark import cells

M = cells.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51
    assert isinstance(M["run_seconds"], int)
    assert len(json.dumps(M).encode()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (cells.ROOT / p).is_dir()
    assert 1 <= len(M["command"]) <= 32
    for word in M["command"]:
        assert line(word) and not word.startswith("/") and ".." not in word
    assert (cells.ROOT / M["command"][1]).is_file()
    assert M["command"][1].startswith(tuple(p + "/" for p in M["paths"]))


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries(section):
    entries = M[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key])
    all_metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(all_metrics) == len(set(all_metrics))


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        cfg = json.loads((cells.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        importlib.import_module(f"benchmark.data.{cfg['data']['generator']}")


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["traffic"])
        cell = cells.Cell(w["name"])
        assert {"mu0_min", "mu0_max", "nmdot", "mdot_min", "mdot_max",
                "trace_calls"} <= set(cell.traffic)
        assert cell.check["limits"]["image_err"] > 0
        names = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer()


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and line(m["layer"])
        assert hasattr(cells.reader(m["name"]), "read")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
