"""The traced stretch: ``torch.profiler`` over a fixed number of steps after
the measured window, reduced to what the per-layer readers need.

* ``busy_s``: the union of the intervals in which an operation (a kernel, a
  copy or a fill) ran on the device, so that operations that overlap count
  once (``metrics/device_idle.py`` sets it against the measured window).
* ``window_s``: the host clock from the first step's start to the
  synchronization after the last.
* device seconds by kernel class (``kernel_classes.json``: a class is a list
  of substrings of kernel names; inside a CUDA graph replay only the names
  say what ran), each the union of its kernels' intervals.
* ``breakdown``: the device operations that took the most time, and the
  longest idle gaps by the host operation that was running through them
  (the innermost span of the main thread; the benchmark's own spans are
  ``perfbench.*``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

CLASSES = json.loads((pathlib.Path(__file__).resolve().parent / "kernel_classes.json").read_text())
TOP = 10

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The disjoint union of [start, end) intervals, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def kernel_class(name: str) -> Optional[str]:
    for cls, subs in CLASSES.items():
        if any(sub in name for sub in subs):
            return cls
    return None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def host_at(points: Sequence[float], spans: Sequence[Tuple[float, float, str]]) -> List[str]:
    """For each time in ``points`` (ascending), the name of the innermost of
    the nested ``spans`` (start, end, name) that covers it, or "host"."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack: List[Tuple[float, float, str]] = []
    names, i = [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][2] if stack else "host")
    return names


@dataclasses.dataclass
class Summary:
    steps: int
    busy_s: float
    window_s: float
    kernels: int
    class_s: Dict[str, float]
    least_s: Dict[str, float]
    breakdown: dict


def reduce(device_ops: Sequence[Tuple[float, float, str]],
           host_spans: Sequence[Tuple[float, float, str]], steps: int, window_s: float,
           least_s: Dict[str, float]) -> Summary:
    """device_ops and host_spans as (start, end, name) in seconds."""
    busy = union([(s, e) for s, e, _ in device_ops])
    by_class: Dict[str, List[Interval]] = collections.defaultdict(list)
    by_name: Dict[str, float] = collections.defaultdict(float)
    kernels = 0
    for s, e, name in device_ops:
        by_name[name] += e - s
        if not is_copy(name):
            kernels += 1
            cls = kernel_class(name)
            if cls is not None:
                by_class[cls].append((s, e))
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    owners = host_at([(s + e) / 2 for s, e in gaps], host_spans)
    idle: Dict[str, float] = collections.defaultdict(float)
    for (s, e), owner in zip(gaps, owners):
        idle[owner] += e - s
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Summary(steps, sum(e - s for s, e in busy), window_s, kernels,
                   {c: covered(iv) for c, iv in by_class.items()}, dict(least_s),
                   {"device_ops": top(by_name), "idle_gaps": top(idle)})


def profile(driver, steps: int) -> Summary:
    """``steps`` steps of the driver under torch.profiler, after the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    first = driver.steps_done
    driver.sync()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            with record_function("perfbench.step"):
                driver.step(first + i, False)
        driver.sync()
        window_s = time.perf_counter() - t0
    events = prof.events()
    device, host = [], collections.defaultdict(list)
    for e in events:
        span = (e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append(span)
        else:
            host[e.thread].append(span)
    main = max(host.values(), key=len) if host else []
    least: Dict[str, float] = collections.defaultdict(float)
    for i in range(steps):
        for cls, s in driver.least_s(first + i).items():
            least[cls] += s
    return reduce(device, main, steps, window_s, least)


class Context:
    """What a per-layer reader reads: the traced stretch's ``summary``, the
    window's steps, seconds and step times, the peaks, and the model's
    FLOPs per step (``model_flops``, set after the check)."""

    def __init__(self, summary: Summary, steps: int, seconds: float,
                 step_times: List[float], peaks: dict):
        self.summary = summary
        self.steps, self.seconds, self.step_times = steps, seconds, step_times
        self.peaks = peaks
        self.model_flops: Optional[float] = None
