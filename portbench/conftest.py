"""pytest settings of the benchmark's own tests
(``python -m pytest portbench/tests -q``): the ``card`` marker, for tests
that need a CUDA device, and the fixture that decides it when the test
runs (never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The first CUDA device; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")
    return "cuda:0"
