"""CPU tests of the benchmark (``python -m pytest picbench/tests``); the
tests marked ``cuda`` run on the card and skip elsewhere."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# each cell at a size a CPU test run holds: the same decks and traffic
SMALL = {
    "fan_run.steps": {"nx": 8, "ny": 8, "nz": 8, "ppc": 8},
    "trecon.steps": {"nx": 8, "ny": 4, "nz": 8, "ppc": 8},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on an NVIDIA GPU; skipped where "
        "torch.cuda.is_available() is false")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return "cuda"
