"""pytest settings of the benchmark's own tests (``python -m pytest
portbench``): the ``card`` marker, and the fixture that decides, when a
test asks for it, whether a CUDA card is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda:0")
