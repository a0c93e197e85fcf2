"""The benchmark's own tests: ``python -m pytest portbench/tests``.

Nothing here imports JAX or the JAX package. Tests that need the card
take the ``card`` fixture, which decides at run time, never at import.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
