"""Settings of the benchmark's own tests (``python3 -m pytest lhbench/tests``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (runs the port on it); skips without one")


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is there, decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
