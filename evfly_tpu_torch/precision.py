"""The float32 precision of the port's convolutions and matmuls on the card.

The JAX package computes its convolutions and matmuls at
``Precision.HIGHEST`` (full f32).  PyTorch's defaults differ on the card:
cuDNN convolutions run in TF32 (``torch.backends.cudnn.allow_tf32`` is True)
while matmuls run in f32.  The port's entry points (``LSTMNetVIT.forward``,
``OrigUNet_w_VITFLY_ViTLSTM.forward``, ``StreamingPipeline.step_*``,
``BatchedStreamingPipeline.step_frames``, ``event_histogram_scaled_resized``)
run their work under ``precision_scope``, which sets both flags from
``set_precision`` and restores the caller's flags on exit.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

PRECISIONS = ("highest", "tf32")
_precision = "highest"


def set_precision(precision: str) -> None:
    """"highest" (the default: full f32, as the JAX package) or "tf32"
    (TF32 tensor cores for f32 convolutions and matmuls)."""
    global _precision
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    _precision = precision


def get_precision() -> str:
    return _precision


@contextlib.contextmanager
def precision_scope(precision: Optional[str] = None):
    """Set cuDNN's and the matmuls' TF32 flags from ``set_precision`` (or
    from ``precision`` where given, for work that runs at one precision
    whatever the setting) for the block; restore the global flags as they
    were on exit."""
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    tf32 = (precision or _precision) == "tf32"
    cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def with_precision(fn):
    """Run ``fn`` (an entry point) under ``precision_scope``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with precision_scope():
            return fn(*args, **kwargs)

    return wrapped
