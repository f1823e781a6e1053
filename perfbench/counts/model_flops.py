"""Operations of a model step, counted over the plain reference at the cell's
shapes, so that the count reads the same whatever implements the step.

``count(fn)`` runs ``fn`` once under ``torch.utils.flop_counter.FlopCounterMode``
(every matmul and convolution, forward and backward) and under a dispatch
mode of its own that lists each convolution's direct-method operations and
the bytes of its inputs and outputs, for the convolution kernels' roofline.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from . import kernels

aten = torch.ops.aten


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> int:
    """2 x (multiply-adds of the direct method): each output (or, for a
    transposed convolution, each input) element against its C_in / groups
    x k_h x k_w weights."""
    per = math.prod(w_shape[1:])
    return 2 * math.prod(x_shape if transposed else out_shape) * per


class ConvCounter(TorchDispatchMode):
    """Lists (operations, bytes) of every convolution, forward and backward."""

    def __init__(self):
        super().__init__()
        self.calls: List[Tuple[int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is aten.convolution.default:
            x, w, b, transposed = args[0], args[1], args[2], args[6]
            flops = conv_flops(x.shape, w.shape, out.shape, transposed)
            self.calls.append((flops, _nbytes(x) + _nbytes(w) + _nbytes(b) + _nbytes(out)))
        elif func is aten.convolution_backward.default:
            grad, x, w, transposed, mask = args[0], args[1], args[2], args[7], args[10]
            y_shape = grad.shape
            one = conv_flops(x.shape, w.shape, y_shape, transposed)
            flops = one * (int(mask[0]) + int(mask[1]))
            moved = _nbytes(grad) + _nbytes(x) + _nbytes(w) + sum(_nbytes(o) for o in out)
            self.calls.append((flops, moved))
        return out


def count(fn: Callable[[], object]) -> Dict[str, float]:
    """{"flops": every counted operation, "conv_flops", "conv_least_s": the
    sum over convolutions of each one's least time} of one call of ``fn``."""
    convs = ConvCounter()
    with FlopCounterMode(display=False) as fc, convs:
        fn()
    return {"flops": float(fc.get_total_flops()),
            "conv_flops": float(sum(f for f, _ in convs.calls)),
            "conv_least_s": sum(kernels.least_s(b, f) for f, b in convs.calls)}
