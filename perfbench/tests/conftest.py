"""The benchmark's own tests: run with ``python -m pytest perfbench/tests``.

Tests that need a CUDA card take the ``card`` fixture, which skips them
where there is none (decided when the test runs, never at import). On the
card: ``python -m pytest perfbench/tests -m card``.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: tiny tensors under several workers run faster so."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
