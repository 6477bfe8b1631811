"""The benchmark's own tests: on the CPU at tiny sizes, and (marked
`cuda`) on a card.  Run from the repository's root:

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)


def tiny(cell):
    """Shrink a cell to a size a CPU test run holds: 10 x 10 pixels of 48
    points, a 24 x 16 x 8 snapshot, every pixel checked."""
    cell.config["grtrans"]["nn"] = [10, 10, 48]
    if "nx1" in cell.config["data"]:
        cell.config["data"].update(nx1=24, nx2=16, nx3=8)
    cell.check["pixels"] = 100
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)
