"""The benchmark's own tests. Run from the root of the repository:

    python -m pytest benchmark/tests -q

Tests marked `card` need an NVIDIA card and skip here without one; the
decision is taken inside the `card` fixture, never while a module is
imported."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this sandbox has none")
    return torch.device("cuda", 0)
