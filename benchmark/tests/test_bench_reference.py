"""The comparison that decides `correct`, at a size a CPU test run holds:
the reference agrees with the program; the control (the program in the
precision below the configuration's) fails the limit; a run whose timed
path is broken underneath reads `correct` false, once for each fault a
cell can have; and nothing the benchmark runs imports JAX or the JAX
package, nor the reference anything of the program."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import cells, harness, limits
from benchmark.tests.conftest import ROOT, tiny

CELLS = [w["name"] for w in cells.load_manifest()["workloads"]]
SEED = 2 ** 31 + 101


def quiet(msg):
    pass


def run(cell, seconds=0.3):
    return harness.run(cell, SEED, seconds, 0, "cpu",
                       harness.time.perf_counter(), log=quiet)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program(name):
    r = run(tiny(cells.Cell(name)))
    assert r["correct"] and r["failed"] == 0
    assert r["check"]["image_err"]["value"] <= 1e-12
    assert list(r["check"]) == ["image_err", "nonfinite_values"]
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limit(name):
    cell = tiny(cells.Cell(name))
    (_, _, sound), (prec, control, lower) = limits.readings(cell, SEED, 1,
                                                            "cpu")
    assert control and prec == "mixed"
    limit = cell.check["limits"]["image_err"]
    assert sound["image_err"][0] <= limit < lower["image_err"][0]


def _altered(render_rays):
    """One answer altered where it is produced: the first pixel's I."""
    def wrong(*a, **k):
        out = render_rays(*a, **k).clone()
        out[..., 0, 0] *= 1.0 + 1e-6
        return out
    return wrong


def _half_left_out(render_rays):
    """Half of the batch left out: the second half of the pixels."""
    def wrong(*a, **k):
        out = render_rays(*a, **k).clone()
        out[:, out.shape[1] // 2:] = 0.0
        return out
    return wrong


def _state_unchanged(observed_stokes):
    """A step that returns its state unchanged: the march gives back the
    Stokes vector it starts from (zero) for every ray."""
    def wrong(lam, j, K, *a, **k):
        return torch.zeros(j.shape[0], 4, dtype=j.dtype, device=j.device)
    return wrong


FAULTS = {"answer_altered": ("grtrans_tpu_torch.driver", "render_rays",
                             _altered),
          "half_left_out": ("grtrans_tpu_torch.driver", "render_rays",
                            _half_left_out),
          "state_unchanged": ("grtrans_tpu_torch.integrate.solvers",
                              "observed_stokes", _state_unchanged)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    module, attr, breaker = FAULTS[fault]
    mod = __import__(module, fromlist=[attr])
    monkeypatch.setattr(mod, attr, breaker(getattr(mod, attr)))
    r = run(tiny(cells.Cell(name)))
    assert not r["correct"] and r["failed"] > 0


FORBIDDEN = ("jax", "jaxlib", "flax", "grtrans_tpu")
PROBE = """
import json, sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(2)
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(body):
    """The top-level names of the modules a fresh process holds after
    `body`."""
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_neither_jax_nor_the_jax_package():
    names = loaded(
        "from benchmark import cells, harness, limits\n"
        "from benchmark.tests.conftest import tiny\n"
        "for w in cells.load_manifest()['workloads']:\n"
        "    c = tiny(cells.Cell(w['name']))\n"
        "    harness.run(c, 7, 0.1, 0, 'cpu', 0.0, log=lambda m: None)\n"
        "import benchmark.tracing\n")
    assert "grtrans_tpu_torch" in names       # the program ran
    assert not names & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    names = loaded(
        "import importlib, pkgutil, benchmark.reference as r\n"
        "for m in pkgutil.iter_modules(r.__path__):\n"
        "    importlib.import_module('benchmark.reference.' + m.name)\n"
        "from benchmark.data import ffjet_table, harm3d_snapshot\n"
        "for g, p in ((ffjet_table, dict(nx=16, a=0.998, ntscl=2.0, "
        "nrscl=70.0)), (harm3d_snapshot, dict(nx1=8, nx2=6, nx3=4, "
        "a=0.9375, mdot_code=0.003))):\n"
        "    g.reference_model(g.make(p, 3, 'cpu'), 'cpu')\n")
    assert not names & set(FORBIDDEN + ("grtrans_tpu_torch",))
