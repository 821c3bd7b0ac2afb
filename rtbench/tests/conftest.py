"""The benchmark's own tests (`python -m pytest rtbench/tests`), apart
from the repository's suite. Tests that need a CUDA card carry the
`card` marker and its fixture, which skips them where there is none;
the decision is made in the fixture, never at import."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)
