"""Pytest settings of the benchmark's tests: the ``card`` marker, and the
``card`` fixture that skips a test where no CUDA card is present (decided
when the test runs, never when a module is imported)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the machine with the card")
    return torch.device("cuda", 0)
