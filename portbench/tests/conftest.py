"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests marked ``card`` run on a CUDA card at the cells' own sizes and skip
without one; whether there is a card is decided inside the ``card``
fixture, when a test runs."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell at its own size "
                    "on the card")
    return torch.device("cuda", 0)

