"""The benchmark's own tests (``python3 -m pytest ltrbench/tests``); the
ones that need a CUDA card carry the ``card`` marker and run with
``python3 -m pytest ltrbench/tests -m card`` on a machine that has one.
Whether there is a card is decided in the ``card`` fixture, never while
a module is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)
