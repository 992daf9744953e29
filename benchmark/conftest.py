"""Pytest set-up of the benchmark's own tests (``benchmark/tests``, run
apart from the repository's suite: ``python -m pytest benchmark/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where no card is present; the
decision is made inside the fixture, never at import or collection.
"""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
