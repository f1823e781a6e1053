"""Profiling: stage timers, CUDA-event timing and ``torch.profiler`` traces.

Port of ``evfly_tpu/utils/profiling.py``.  Named stage timers with p50/p95
summaries (the drivers time their stages with ``StageTimer``), a
synchronizing timer of a device function (CUDA events around the calls,
``torch.cuda.synchronize`` before the clock starts), and a context manager
around ``torch.profiler`` that writes a Chrome trace (chrome://tracing,
Perfetto) where the JAX package writes a ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _synchronize(value) -> None:
    """Wait for the device work behind ``value``: a CUDA tensor, a
    ``torch.device``, or a tuple or list of them."""
    if isinstance(value, (tuple, list)):
        for v in value:
            _synchronize(v)
        return
    dev = value.device if isinstance(value, torch.Tensor) else torch.device(value)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates wall-clock samples per named stage; reports percentiles."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None) -> Iterator[None]:
        """Time a block; pass a tensor (or a device) as ``sync_value`` to
        wait for the device's work before stopping the clock."""
        t0 = time.perf_counter()
        yield
        if sync_value is not None:
            _synchronize(sync_value)
        self.samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.samples.items():
            arr = np.array(vals)
            out[name] = {
                "count": len(arr),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "total_s": float(arr.sum()),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<28}{'count':>7}{'mean':>10}{'p50':>10}{'p95':>10}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<28}{s['count']:>7}{s['mean_ms']:>9.2f}m{s['p50_ms']:>9.2f}m{s['p95_ms']:>9.2f}m"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: str, device: DeviceLike = None):
    """Profile the block with ``torch.profiler`` (the CPU, and the CUDA
    device unless the caller names the CPU) and write its Chrome trace to
    ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed_device_fn(fn, *args, n_iters: int = 10, warmup: int = 1,
                    device: DeviceLike = None) -> float:
    """Steady-state seconds per call of ``fn(*args)`` on ``device`` (CUDA
    unless the caller names another): ``warmup`` calls, then ``n_iters``
    chained calls between two CUDA events, synchronized once (on the CPU,
    the host clock around the calls)."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n_iters):
            fn(*args)
        return (time.perf_counter() - t0) / n_iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n_iters
