"""The benchmark's tests hold PyTorch to the f32 the configurations state,
as perfbench/run.py does."""

import pytest
import torch


@pytest.fixture(autouse=True)
def f32_without_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
