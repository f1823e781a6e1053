"""Steps replayed as CUDA graphs: the step of the streaming pipelines
(``stream.pipeline``) and V(phi)'s served forward (``models.vitfly``).

A caller keeps a step's inputs, and any state the step carries, in static
device buffers.  ``Steps.run`` takes the step's key (everything the step
depends on beyond its buffers' addresses: the pipelines' ``GraphKey``,
V(phi)'s ``ServeKey``), a maker of its ``Slot`` (the buffers, and the step
over them as a ``body`` of no arguments that writes any new state in place
and returns the outputs) and a ``fill`` that copies the call's inputs into
the buffers.  Eagerly (``graph=False``, and every ``Steps`` on the CPU) a
step is the fill and the body.

With graphs, the first step of a key captures the body as one
``torch.cuda.CUDAGraph``, and every step after it is the fill, outside the
graph, and one replay; the outputs come back as clones, since the next
replay overwrites the graph's.  A capture first runs ``WARMUP_STEPS``
eager steps on a side stream, one per device, then puts the carried state
(``Steps.state``) back as it found it, so a capture changes no result.
The warm-up and the capture run under cuDNN's timed algorithm search
(``torch.backends.cudnn.benchmark``, the caller's flag restored after), so
each convolution of the graph takes the algorithm that ran fastest at its
own shape on the card at hand; on the H100 cuDNN's heuristic runs some of
D(theta)'s 3x3 convolutions as FFTs, 3.5 to 40 times slower.  The search
times its candidates in the first warm-up step, which a capture could not,
and the capture finds each plan in PyTorch's cache.  That cache does not
key on the flag: a shape that already ran under the heuristic in the
process keeps the heuristic's plan.  A capture that fails raises; there
is no fallback to the eager step.  A capture, with its warm-up and the
search, stalls the step that takes it: in a deployment's 15 Hz loop, a
missed tick.

``Steps.stats`` (``StepStats``) counts, always, the steps, the captures
and the captures taken under the search per key.  While a
``torch.profiler`` records (``utils.profiling``), each step has the spans
``<spans>.fill`` (with the caller's counts), ``<spans>.capture``
(``searched`` 1) and ``<spans>.replay``: ``evfly.stream.*`` for the
pipelines, ``evfly.serve.*`` for V(phi).  The spans inside a body are
captured into its graph as timing events, so a traced replay gives the
device time of each.  A copy of a ``Steps`` (``copy.deepcopy``, pickle)
keeps the counters and no slot: a graph replays the buffers it was
captured on.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from .utils import profiling

# eager steps before a capture: they build the kernels' library, set their
# shared-memory attributes, pack the LSTM weights, let cuDNN's search time
# and pick each convolution's algorithm, and let cuBLAS and cuDNN allocate
# their workspaces, none of which a graph may do
WARMUP_STEPS = 2


class Slot:
    """One step's static input buffers, the step over them (``body``: no
    arguments, writes the new state in place, returns the outputs) and,
    once captured, its graph, the graph's output buffers and the body's
    spans as timing marks in the graph."""

    def __init__(self, inputs: Dict[str, torch.Tensor], body: Callable[[], tuple]):
        self.inputs = inputs
        self.body = body
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[tuple] = None
        self.marks: Optional[profiling.Marks] = None


# the side stream of every capture's warm-up, one per device: cuBLAS keeps
# a workspace (32 MiB on Hopper) for each stream it has run on, and each
# can pin a cached segment of up to 2 GiB that empty_cache cannot return
_WARMUP_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _warmup_stream(device: torch.device) -> "torch.cuda.Stream":
    stream = _WARMUP_STREAMS.get(device)
    if stream is None:
        stream = _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
    return stream


@contextlib.contextmanager
def _cudnn_search():
    """cuDNN's timed algorithm search on for the block, the caller's
    ``benchmark`` flag restored on exit.  Nothing else is touched:
    ``torch.backends.cudnn.flags`` would also set ``enabled`` and
    ``allow_tf32`` from its own defaults, against ``set_precision``."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


@dataclasses.dataclass
class StepStats:
    """The counters of a ``Steps``, kept whether or not anything traces:
    ``steps``, ``captures`` and ``searched`` (the captures whose warm-up
    ran cuDNN's search: every capture, its set-up grown by the search
    once per new shape in a process) per key; and, for a streaming
    pipeline, ``events`` the real events handed to ``step_events`` and
    ``padded_events`` the events its kernels took (each window padded to
    ``stream.pipeline.event_bucket``)."""
    steps: "collections.Counter[tuple]" = dataclasses.field(default_factory=collections.Counter)
    captures: "collections.Counter[tuple]" = dataclasses.field(
        default_factory=collections.Counter)
    searched: "collections.Counter[tuple]" = dataclasses.field(
        default_factory=collections.Counter)
    events: int = 0
    padded_events: int = 0


class Steps:
    """A caller's steps: one ``Slot`` for each key, run eagerly or, with
    ``graph`` on a CUDA device, as replays of the slot's graph.  ``state``
    holds the static tensors the steps carry, which a capture's warm-up
    leaves as it found them; ``spans`` prefixes the steps' span names."""

    def __init__(self, device: torch.device, graph: bool, state: List[torch.Tensor],
                 spans: str = "evfly.stream"):
        self.device = device
        self.graph = graph and device.type == "cuda"
        self.state = state
        self.slots: Dict[tuple, Slot] = {}
        self.stats = StepStats()
        self._spans = tuple(f"{spans}.{name}" for name in ("fill", "capture", "replay"))

    def __getstate__(self):
        return {**self.__dict__, "slots": {}}

    def run(self, key: tuple, make: Callable[[], Slot],
            fill: Callable[[Dict[str, torch.Tensor]], None], **counts: int) -> tuple:
        """One step; ``counts`` go into its fill span."""
        fill_span, capture_span, replay_span = self._spans
        slot = self.slots.get(key)
        if slot is None:
            slot = self.slots[key] = make()
        self.stats.steps[key] += 1
        with profiling.span(fill_span, **counts):
            fill(slot.inputs)
        if not self.graph:
            return slot.body()
        if slot.graph is None:
            with profiling.span(capture_span, searched=1):
                self._capture(slot)
            self.stats.captures[key] += 1
            self.stats.searched[key] += 1
        slot.marks.replay(slot.graph, replay_span)
        return tuple(None if o is None else o.clone() for o in slot.outputs)

    def _capture(self, slot: Slot) -> None:
        """Warm up on the side stream under cuDNN's search, put the state
        back, capture."""
        saved = [t.clone() for t in self.state]
        current = torch.cuda.current_stream(self.device)
        side = _warmup_stream(self.device)
        with _cudnn_search():
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    slot.body()
            current.wait_stream(side)
            for t, s in zip(self.state, saved):
                t.copy_(s)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph), profiling.capture_marks() as marks:
                outputs = slot.body()
        slot.graph, slot.outputs, slot.marks = graph, outputs, marks
