"""Per-frame q-quantile of |frame| by value-axis bisection.

Port of ``evfly_tpu/ops/percentile.py``: the same 18-step f32 bisection on
[0, max|x|], the same order statistic k = floor(q * (n - 1)) + 1 and the
same exact-zero snap, so on the CPU the result is bit for bit the JAX one.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def bisect_abs_quantile(flat_abs: torch.Tensor, kth: int, iters: int) -> torch.Tensor:
    """k-th smallest value (1-indexed) of each row of ``flat_abs`` (B, n),
    narrowed to the bisection's upper bound after ``iters`` halvings; 0 when
    at least ``kth`` values are exactly 0."""
    lo = torch.zeros(flat_abs.shape[0], dtype=flat_abs.dtype, device=flat_abs.device)
    hi = flat_abs.amax(dim=1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = (flat_abs <= mid[:, None]).sum(dim=1)
        go_right = cnt < kth
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    n_zero = (flat_abs <= 0.0).sum(dim=1)
    return torch.where(n_zero >= kth, torch.zeros_like(hi), hi)


def approx_abs_quantile(frames: torch.Tensor, q: float = 0.97, iters: int = 18) -> torch.Tensor:
    """(B, ...) -> (B,) approximate q-quantile of |frames| over the trailing
    dims (``percentile.approx_abs_quantile``)."""
    B = frames.shape[0]
    flat = frames.reshape(B, -1).abs()
    n = flat.shape[1]
    # the JAX code floors q*(n-1) as an f32 array: round to f32 first
    kth = int(math.floor(np.float32(q * (n - 1)))) + 1
    return bisect_abs_quantile(flat, kth, iters)
