"""The ``card`` marker of the benchmark's tests that need a CUDA card
(they skip without one, deciding inside the test), and its fixture."""

from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA card, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda", 0)
