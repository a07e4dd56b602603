"""The benchmark's tests.  Those that need the CUDA card carry the
``card`` marker and take the ``card`` fixture, which skips without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda")
