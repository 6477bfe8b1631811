"""The harness on a card at a small size: the program's kernels there
against the plain reference, and the control failing the limit.  Skips
without a CUDA device.

    python -m pytest -m cuda benchmark/tests -q
"""

import pytest

from benchmark import cells, harness, limits
from benchmark.tests.conftest import tiny

CELLS = [w["name"] for w in cells.load_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_on_the_card(card, name):
    cell = tiny(cells.Cell(name))
    cell.config["grtrans"]["nn"] = [32, 32, 128]
    r = harness.run(cell, 2 ** 31 + 17, 1.0, 1, card,
                    harness.time.perf_counter(), log=lambda msg: None)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0.0
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(card, name):
    cell = tiny(cells.Cell(name))
    cell.config["grtrans"]["nn"] = [32, 32, 128]
    cell.check["pixels"] = 1024
    (_, _, sound), (_, _, lower) = limits.readings(cell, 2 ** 31 + 19, 1,
                                                   card)
    limit = cell.check["limits"]["image_err"]
    assert sound["image_err"][0] <= limit < lower["image_err"][0]
