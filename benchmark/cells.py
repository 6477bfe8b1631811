"""What a cell is made of, found by the names in BENCHMARK.json: the cell's
entry, its configuration file, its traffic file (traffic/<name>.json), its
check file (checks/<cell>.json), the data generator the configuration
names (data/<generator>.py) and the metric readers (metrics/<name>.py).
Adding a cell, a configuration or a per-layer metric adds files and
entries; no file here names one."""

import importlib
import json
import math
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def load_manifest(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


class Cell:
    """One entry of `workloads` with everything it names."""

    def __init__(self, name, root=ROOT):
        self.root = Path(root)
        self.manifest = load_manifest(root)
        self.entry = _named(self.manifest["workloads"], name, "workload")
        self.name = name
        self.chips = self.entry["chips"]
        cfg_entry = _named(self.manifest["configs"], self.entry["config"],
                           "configuration")
        self.config = json.loads((self.root / cfg_entry["file"]).read_text())
        bench = self.root / HERE.name
        self.traffic = json.loads(
            (bench / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.check = json.loads(
            (bench / "checks" / f"{name}.json").read_text())
        self.data_gen = importlib.import_module(
            f"benchmark.data.{self.config['data']['generator']}")

    def grtrans(self):
        """The configuration's renderer parameters; nn as a list."""
        return dict(self.config["grtrans"])

    def end_to_end(self):
        """The end-to-end metrics: every cell reports each."""
        return self.manifest["end_to_end"]

    def per_layer(self):
        """The per-layer metrics: every cell reports each its trace has."""
        return self.manifest["per_layer"]


def reader(metric_name):
    """The reader module of a per-layer metric (metrics/<name>.py, dots
    in the name as underscores)."""
    mod = metric_name.replace(".", "_").replace("-", "_")
    return importlib.import_module(f"benchmark.metrics.{mod}")


def calls(traffic, seed):
    """The calls of a run, without end: (mu0, mdots) of call i.  mu0 runs
    through [mu0_min, mu0_max] by the golden-ratio sequence from a start
    drawn from the seed, so that every prefix is spread evenly, no two
    calls share a camera, and each seed has the same mix in another order;
    mdots are the traffic's nmdot rates, log-spaced over [mdot_min,
    mdot_max] (one rate: mdot_min)."""
    lo, hi = traffic["mu0_min"], traffic["mu0_max"]
    start = np.random.default_rng([seed, 0]).random()
    n = traffic["nmdot"]
    if n == 1:
        mdots = [float(traffic["mdot_min"])]
    else:
        mdots = [float(m) for m in np.logspace(
            np.log10(traffic["mdot_min"]), np.log10(traffic["mdot_max"]),
            n)]
    i = 0
    while True:
        yield lo + (hi - lo) * ((start + i * GOLDEN) % 1.0), mdots
        i += 1


def warm_call(traffic):
    """The set-up's warm-up call: the middle of the mu0 range, one rate."""
    return 0.5 * (traffic["mu0_min"] + traffic["mu0_max"]), \
        [float(traffic["mdot_min"])]
