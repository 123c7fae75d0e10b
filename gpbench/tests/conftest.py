"""CPU tests of the benchmark (run with ``python3 -m pytest gpbench/tests``).

A test that needs the card carries the ``card`` marker and decides inside
the test, never at import, whether a card is present."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the control's TF32 products exist only there)")
    return "cuda"


@pytest.fixture
def cpu_program():
    """The program's raw inputs on the CPU for the test, restored after."""
    from stheno_torch import config

    prev = config.default_device
    config.set_default_device("cpu")
    yield "cpu"
    config.set_default_device(prev)
