"""Profiling: the program's spans, stage timers, CUDA-event timing and
``torch.profiler`` traces.

Port of ``evfly_tpu/utils/profiling.py``, with spans added.

* ``span(name, **counts)`` marks a layer of the program (the streaming
  step's fill, replay and capture, the frame, D(theta) and V(phi), RVT's
  and E-RAFT's layers, the train step's phases; every name starts
  ``evfly.``).  It does nothing
  unless a ``torch.profiler`` is recording: then it is a
  ``record_function`` range in the profiler's timeline, and a ``Record``
  kept in memory with its host interval, its device interval on a CUDA
  device (timing events on the current stream), its parent and its step
  (the root span), read back by ``spans()``.  Inside a CUDA graph capture
  opened by ``capture_marks()`` a span becomes a pair of timing events
  captured into the graph, whose device interval each traced replay adds
  to its step (``Marks.replay``).
* ``StageTimer``: named stage timers with p50/p95 summaries, for callers'
  own host timing.
* ``timed_device_fn``: a synchronizing timer of a device function (CUDA
  events around the calls, ``torch.cuda.synchronize`` before the clock
  starts).
* ``profiler_trace``: ``torch.profiler`` around a block, written as a
  Chrome trace (chrome://tracing, Perfetto) where the JAX package writes a
  ``jax.profiler`` trace; the operator's way to see the spans of any
  driver (their ``record_function`` ranges are in the trace).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

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


# ------------------------------------------------------------------ spans

# records kept in memory; past this many the oldest go first
MAX_RECORDS = 1 << 16


@dataclasses.dataclass
class Record:
    """One span of one step.  ``root`` is the id of the step's outermost
    span (its own id for a root).  ``host`` is (start, end) on the host's
    ``time.perf_counter`` in seconds, None for a graph mark; ``device`` is
    (start, end) in ms from the root span's device start, None where the
    span was not timed on a device (the CPU) or until it is resolved."""
    id: int
    name: str
    parent: Optional[int]
    root: int
    host: Optional[Tuple[float, float]]
    counts: Dict[str, int]
    device: Optional[Tuple[float, float]] = None
    # (the root's start event, start, end) until the device interval is read
    _events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.host is None else 1e3 * (self.host[1] - self.host[0])

    @property
    def device_ms(self) -> Optional[float]:
        return None if self.device is None else self.device[1] - self.device[0]


class _State(threading.local):
    """Per thread: the open spans (innermost last, each (record, its start
    event, its root's start event)), and the graph capture's marks."""

    def __init__(self):
        self.stack: List[tuple] = []
        self.marks: Optional["Marks"] = None


_state = _State()
_records: "collections.deque[Record]" = collections.deque(maxlen=MAX_RECORDS)
_pending: "collections.deque[Record]" = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count()
_OFF = contextlib.nullcontext()


def _timing_event() -> "torch.cuda.Event":
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _resolve(record: Record) -> None:
    """Read a record's device interval from its events (waiting for the
    end event, which a caller that read the step's outputs has passed)."""
    if record._events is None:
        return
    root_start, start, end = record._events
    end.synchronize()
    record.device = (root_start.elapsed_time(start), root_start.elapsed_time(end))
    record._events = None


class _Span:
    """A span while a profiler records: a ``record_function`` range, and a
    ``Record`` with the host interval inside that range and, where CUDA is
    in use, the current stream is not capturing and the root is timed,
    timing events on the current stream."""

    __slots__ = ("name", "counts", "fn")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts

    def __enter__(self) -> Record:
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        stack = _state.stack
        rid = next(_ids)
        parent, _, root_start = stack[-1] if stack else (None, None, None)
        start = None
        if ((parent is None or root_start is not None) and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            start = _timing_event()
            if parent is None:
                root_start = start
        record = Record(rid, self.name, None if parent is None else parent.id,
                        rid if parent is None else parent.root,
                        (time.perf_counter(), 0.0), self.counts)
        stack.append((record, start, root_start if start is not None else None))
        return record

    def __exit__(self, *exc):
        end = time.perf_counter()
        record, start, root_start = _state.stack.pop()
        record.host = (record.host[0], end)
        if start is not None:
            record._events = (root_start, start, _timing_event())
            _pending.append(record)
        _records.append(record)
        self.fn.__exit__(*exc)
        return False


def span(name: str, **counts: int):
    """A context manager marking one layer of the program; ``counts`` (whole
    numbers, such as the real events of a step) go into its record.

    With no profiler recording it is one shared no-op context: the check
    is one C call.  While a ``torch.profiler`` records, it is a
    ``record_function`` range and a ``Record`` (see ``spans``).  Inside a
    graph capture opened by ``capture_marks`` it is a pair of timing
    events captured into the graph, profiler or not."""
    marks = _state.marks
    if marks is not None:
        return marks.mark(name, counts)
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, counts)


class Marks:
    """The spans of one captured CUDA graph as timing events captured into
    it (``torch.cuda.Event(enable_timing=True, external=True)``: event
    nodes, recorded on every replay), each with its span's counts.
    ``replay`` replays the graph and, while a profiler records and a span
    is open, adds each mark's device interval of that replay to the open
    span's step (each a child of that span, with the mark's counts); they are read before the graph's next replay records the events
    again, or by ``spans()``."""

    def __init__(self):
        self.marks: List[tuple] = []   # (name, start event, end event, counts)
        self._pending: List[Record] = []

    @contextlib.contextmanager
    def mark(self, name: str, counts: Optional[Dict[str, int]] = None) -> Iterator[None]:
        start = torch.cuda.Event(enable_timing=True, external=True)
        end = torch.cuda.Event(enable_timing=True, external=True)
        start.record()
        self.marks.append((name, start, end, dict(counts or {})))
        try:
            yield
        finally:
            end.record()

    def replay(self, graph: "torch.cuda.CUDAGraph", name: str) -> None:
        """``graph.replay()`` inside ``span(name)``, the marks of this
        replay added to the open step's records while a profiler records."""
        for record in self._pending:
            _resolve(record)
        self._pending = []
        with span(name):
            graph.replay()
        stack = _state.stack
        if not (self.marks and stack and torch.autograd._profiler_enabled()):
            return
        parent, _, root_start = stack[-1]
        if root_start is None:
            return
        for mark, start, end, counts in self.marks:
            record = Record(next(_ids), mark, parent.id, parent.root, None, counts,
                            _events=(root_start, start, end))
            self._pending.append(record)
            _pending.append(record)
            _records.append(record)


@contextlib.contextmanager
def capture_marks() -> Iterator[Marks]:
    """Open inside a CUDA graph capture (``with torch.cuda.graph(g),
    capture_marks() as marks``): every span of the captured work becomes a
    mark of ``marks``; replay the graph with ``marks.replay``."""
    marks, saved = Marks(), _state.marks
    _state.marks = marks
    try:
        yield marks
    finally:
        _state.marks = saved


def spans() -> List[Record]:
    """The records kept since the last ``clear()`` (at most
    ``MAX_RECORDS``, oldest first), every pending device interval read
    first.  A reader of a layer's time a step divides by the steps whose
    root holds that layer's records."""
    while _pending:
        _resolve(_pending.popleft())
    return list(_records)


def clear() -> None:
    """Drop every record."""
    _records.clear()
    _pending.clear()
