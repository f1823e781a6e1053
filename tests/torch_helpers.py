"""Shared fixtures of the port's tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture
def cuda_device():
    """The CUDA device; the test skips where there is none.  Decided inside
    the fixture, so every test process collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")
