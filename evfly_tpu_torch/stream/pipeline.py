"""Streaming inference: a window of events -> depth -> velocity, state carried.

Port of ``evfly_tpu/stream/pipeline.py``.  The reference deployment loop
(evfly_ros/run.py:244-414) quantile-scales each event frame, runs the joint
model with its hidden state carried from frame to frame, and scales the
velocity by the desired speed.  One step is ``stream_step``: raw events ->
``event_histogram`` (kernel K1 on CUDA) -> 97th-percentile scaling -> a
model with the composite convention: the joint model, ``OrigUNet`` with its
ConvLSTM -> ``LSTMNetVIT``, or ``OrigUNet`` -> ``ConvNet_w_VelPred`` (each
head's LSTM through K4, or K5 in the wavefront mode) -> velocity and depth,
under
``torch.inference_mode()`` and at the precision of
``evfly_tpu_torch.set_precision`` (full f32 by default).
``BatchedStreamingPipeline`` steps G streams in one forward, each with its
own state, where the JAX package vmaps the single-stream step.

The JAX package runs each step as one jitted program with the state
donated.  Here a pipeline keeps its inputs and its hidden state in static
device buffers, and on CUDA each step replays one captured
``torch.cuda.CUDAGraph`` (``graph=True``, the default): the step writes
the new state back into the same buffers inside the graph, and only the
copies of the inputs into their buffers run outside it.  A window of N
events is padded with pol-0 events, which K1 drops, to ``event_bucket(N)``
events, one graph for each size.  A graph is captured at the first step
of its key (``graph_key``: everything that picks a kernel or an algorithm
at capture), after ``WARMUP_STEPS`` eager steps whose state is discarded.
The warm-up and the capture run under cuDNN's timed algorithm search
(``torch.backends.cudnn.benchmark``), so each convolution of the graph
takes the algorithm that ran fastest at its own shape (batch 1, or G
streams) on the card at hand; on the H100 cuDNN's heuristic runs some of
the UNet's 3x3 convolutions as FFTs, 3.5 to 40 times slower.  The search
happens in the warm-up, the capture reuses its plans.  PyTorch's plan
cache does not key on the flag: a shape that already ran under the
heuristic in the process keeps the heuristic's plan.
``graph=False``, and every pipeline on the CPU, runs the same step on the
same buffers eagerly.

A pipeline's ``stats`` (``StepStats``) counts, always: steps, captures
and captures taken under the search per ``GraphKey`` (a capture, with its
warm-up steps and the search, stalls the step that takes it: in a
deployment's 15 Hz loop, a missed tick), and the real events handed to
``step_events`` against the padded events its kernels took.  While a
``torch.profiler`` records, each step is a span ``evfly.stream.step``
(``utils.profiling``) holding ``evfly.stream.fill`` (the copies into the
buffers; ``events`` and ``bucket`` on ``step_events``),
``evfly.stream.replay`` or the eager body, and ``evfly.stream.capture``
(``searched`` 1); the body's ``evfly.frame`` (histogram and percentile
scaling), ``evfly.depth`` and ``evfly.head`` are captured into each graph
as timing events, so a traced replay gives the device time of each.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from ..models import recurrent
from ..ops import lstm_fused, voxelizer
from ..ops.percentile import approx_abs_quantile
from ..precision import get_precision, with_precision
from ..utils import profiling

# windows of events are padded to a power of two of at least this many
EVENT_BUCKET_MIN = 1024
# eager steps before a capture: they build the kernels' library, set their
# shared-memory attributes, pack the LSTM weights, let cuDNN's search time
# and pick each convolution's algorithm, and let cuBLAS and cuDNN allocate
# their workspaces, none of which a graph may do
WARMUP_STEPS = 2


def event_bucket(n: int) -> int:
    """The static size a window of ``n`` events is padded to: the next
    power of two of at least ``EVENT_BUCKET_MIN``."""
    return max(EVENT_BUCKET_MIN, 1 << max(n - 1, 0).bit_length())


def _quantile_scale(frame: torch.Tensor, do_events: bool = True, fast: bool = False
                    ) -> torch.Tensor:
    """clip(frame / quantile(|frame|, 0.97), +-1) per (H, W) frame of
    ``frame`` (..., H, W) -- run.py:250-253.

    fast=True takes the bisection percentile (``ops.percentile``) instead
    of ``torch.quantile``'s sort and linear interpolation, the exact path.
    """
    flat = frame.reshape(-1, frame.shape[-2] * frame.shape[-1])
    if fast:
        q = approx_abs_quantile(flat, 0.97)
    else:
        q = torch.quantile(flat.abs(), 0.97, dim=1)
    q = torch.where(q > 0, q, 1.0).reshape(*frame.shape[:-2], 1, 1)
    return torch.clamp(frame / q, -1.0 if do_events else 0.0, 1.0)


def _model_device(model: torch.nn.Module, device: DeviceLike) -> torch.device:
    """The resolved device, which must be where the model's tensors are."""
    dev = resolve_device(device)
    for p in model.parameters():
        if p.device.type != dev.type or dev.index not in (None, p.device.index):
            raise ValueError(f"the model's tensors are on {p.device}, not {dev}")
    return dev


def _leaves(hidden) -> List[torch.Tensor]:
    """The tensors of a hidden-state nest (tuples and lists, None skipped)."""
    if hidden is None:
        return []
    if isinstance(hidden, (tuple, list)):
        return [t for h in hidden for t in _leaves(h)]
    return [hidden]


def stream_step(model: torch.nn.Module, frame: torch.Tensor, desvel: torch.Tensor, hidden,
                quantile_scale: bool = True, fast_percentile: bool = False):
    """One streaming step of the joint model, a function of its inputs:
    frame (H, W) with desvel (1,) and one stream's hidden state, or
    (G, H, W) with desvel (G,) and the state of G streams.  Returns
    (velocity scaled by desvel, (3,) or (G, 3); depth, (H, W) or
    (G, H, W), or None; the new hidden state)."""
    batched = frame.dim() == 3
    if quantile_scale:
        frame = _quantile_scale(frame, fast=fast_percentile)
    H, W = frame.shape[-2:]
    if batched:
        G = frame.shape[0]
        vel, (depth, _upconv, new_hidden) = model(
            frame.reshape(G, 1, 1, H, W), desvel.reshape(G, 1, 1), *hidden)
        return vel[:, 0] * desvel[:, None], depth[:, 0, 0], new_hidden
    vel, (depth, _upconv, new_hidden) = model(frame.reshape(1, 1, H, W), desvel.reshape(1, 1),
                                             *hidden)
    return vel[0] * desvel, (depth[0, 0] if depth is not None else None), new_hidden


def _signs(pol) -> torch.Tensor:
    """pol's sign as the kernels take it: int32 as given, anything else
    mapped to -1, 0 or 1."""
    pol = torch.as_tensor(pol)
    if pol.dtype == torch.int32:
        return pol
    return torch.where(pol > 0, 1, torch.where(pol < 0, -1, 0))


class _Slot:
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


class GraphKey(NamedTuple):
    """What a captured step depends on beyond its buffers' addresses."""
    kind: str                 # "frame", "events" or "frames"
    size: int                 # the event bucket, or G for the batched step
    precision: str            # set_precision
    quantile: Tuple[bool, bool]  # (quantile_scale, fast_percentile)
    fused_lstm: bool          # set_fused_lstm
    lstm: Tuple[Tuple[str, str], ...]  # (mode, route) of each LSTM module
    k1_route: Optional[Tuple[str, int]]  # K1's route (kind, CTAs), for the events step


def _step_body(model, hidden, input_hw, quantile_scale: bool, fast_percentile: bool,
               frame: Optional[torch.Tensor], desvel: torch.Tensor, events=None):
    """The step over static buffers: the frame (or the histogram of the
    events (x, y, pol)), the model, the new state copied into ``hidden``.
    It holds no reference to its pipeline, so that a pipeline and its
    graphs are freed as soon as the last reference to the pipeline goes."""
    device = desvel.device

    def body():
        with profiling.span("evfly.frame"):
            x = frame
            if events is not None:
                x = voxelizer.event_histogram(*events, *input_hw, device=device)
            if quantile_scale:
                x = _quantile_scale(x, fast=fast_percentile)
        vel, depth, new_hidden = stream_step(model, x, desvel, hidden, quantile_scale=False)
        for dst, src in zip(_leaves(hidden), _leaves(new_hidden)):
            dst.copy_(src)
        return vel, depth

    return body


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
    """A pipeline's counters, kept whether or not anything traces.

    ``steps``, ``captures`` and ``searched`` per ``GraphKey``: on a graph
    pipeline each step replays its key's graph, and the first step of a
    key captures it after ``WARMUP_STEPS`` eager steps; ``searched`` counts
    the captures whose warm-up ran cuDNN's algorithm search (every capture:
    its set-up grows by the search, once per new shape in a process);
    ``events`` the real events handed to ``step_events``,
    ``padded_events`` the events its kernels took (each window padded to
    ``event_bucket``)."""
    steps: "collections.Counter[GraphKey]" = dataclasses.field(default_factory=collections.Counter)
    captures: "collections.Counter[GraphKey]" = dataclasses.field(
        default_factory=collections.Counter)
    searched: "collections.Counter[GraphKey]" = dataclasses.field(
        default_factory=collections.Counter)
    events: int = 0
    padded_events: int = 0


class _Steps:
    """A pipeline's steps: one ``_Slot`` for each ``GraphKey``, run eagerly
    or, with ``graph``, as replays of the slot's CUDA graph.  ``state``
    holds the static hidden-state tensors, which the warm-up steps before a
    capture leave as they found them."""

    def __init__(self, device: torch.device, graph: bool, state: List[torch.Tensor]):
        self.device = device
        self.graph = graph and device.type == "cuda"
        self.state = state
        self.slots: Dict[GraphKey, _Slot] = {}
        self.stats = StepStats()

    def run(self, key: GraphKey, make: Callable[[], _Slot],
            fill: Callable[[Dict[str, torch.Tensor]], None], **counts: int) -> tuple:
        """One step; ``counts`` go into its fill span."""
        slot = self.slots.get(key)
        if slot is None:
            slot = self.slots[key] = make()
        self.stats.steps[key] += 1
        with profiling.span("evfly.stream.fill", **counts):
            fill(slot.inputs)
        if not self.graph:
            return slot.body()
        if slot.graph is None:
            with profiling.span("evfly.stream.capture", searched=1):
                self._capture(slot)
            self.stats.captures[key] += 1
            self.stats.searched[key] += 1
        slot.marks.replay(slot.graph, "evfly.stream.replay")
        # the next replay overwrites the graph's outputs
        return tuple(None if o is None else o.clone() for o in slot.outputs)

    def _capture(self, slot: _Slot) -> None:
        """Warm up on a side stream under cuDNN's search, put the state
        back, capture.  The search times its candidates in the first
        warm-up step, which a capture could not; the capture finds each
        convolution's plan in PyTorch's cache.  A capture that fails
        raises; there is no fallback to the eager step."""
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


class _Pipeline:
    """What the single-stream and the batched pipeline share: the model on
    its device, the hidden state in static buffers, and the steps."""

    def __init__(self, model, input_hw, quantile_scale, fast_percentile, device, graph,
                 streams: Optional[int]):
        self.device = _model_device(model, device)
        self.model = model.eval()
        self.input_hw = input_hw
        self.quantile_scale = quantile_scale
        self.fast_percentile = fast_percentile
        self._lstms = [m for m in model.modules() if isinstance(m, recurrent.LSTM)]
        with torch.inference_mode():
            self.hidden = model.init_hidden(streams=streams)
        self._steps = _Steps(self.device, graph, _leaves(self.hidden))
        self.stats = self._steps.stats

    @property
    def graph(self) -> bool:
        """Whether the steps replay CUDA graphs (always False on the CPU)."""
        return self._steps.graph

    def graph_key(self, kind: str, size: int) -> GraphKey:
        """The key of a step of ``kind`` at ``size`` under the current
        settings: a change to any of them captures anew."""
        H, W = self.input_hw
        return GraphKey(
            kind, size, get_precision(), (self.quantile_scale, self.fast_percentile),
            recurrent.fused_lstm_enabled(),
            tuple((m.mode or lstm_fused.FUSED_LSTM_MODE,
                   lstm_fused.choose_route(m.hidden_size, m.num_layers)) for m in self._lstms),
            voxelizer.k1_route(H, W, False) if kind == "events" else None,
        )

    def _body(self, frame: Optional[torch.Tensor], desvel: torch.Tensor, events=None):
        return _step_body(self.model, self.hidden, self.input_hw, self.quantile_scale,
                          self.fast_percentile, frame, desvel, events)

    def reset(self):
        """Zero the recurrent carry in place (sim resets when pos.x < 0.5,
        run_competition.py:500-520; never in real deployment)."""
        with torch.inference_mode():
            for t in _leaves(self.hidden):
                t.zero_()


class StreamingPipeline(_Pipeline):
    """Stateful streaming runner around a two-stage model of
    ``models.composites``: the joint ``OrigUNet_w_VITFLY_ViTLSTM`` or
    ``OrigUNet_w_ConvNet_w_VelPred``.  Its forward takes (frames, desvel,
    hidden_unet, hidden_head) with the composite hidden convention
    ((h_unet, h_velpred), h_head), h_head the ViTLSTM's or the
    ConvNet_w_VelPred LSTM's (h, c), and it has ``init_hidden(streams)``.
    ``hidden`` holds the state in static buffers, which each step and
    ``reset`` write in place; every ``recurrent.LSTM`` of the model is
    packed for its kernel outside the capture and keys the graph by its
    mode and route.  ``desvel`` may change between steps.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        desvel: float = 4.0,
        input_hw: Tuple[int, int] = (260, 346),
        quantile_scale: bool = True,
        fast_percentile: bool = False,
        device: DeviceLike = None,
        graph: bool = True,
    ):
        super().__init__(model, input_hw, quantile_scale, fast_percentile, device, graph, None)
        self.desvel = desvel
        self._desvel = torch.zeros(1, device=self.device)
        self._desvel_set = None

    def _run(self, kind: str, size: int, buffers: Callable[[], Dict[str, torch.Tensor]], fill,
             **counts: int):
        """Step through the slot of ``graph_key(kind, size)``; ``buffers()``
        makes a new slot's inputs: a "frame", or the events "x", "y",
        "pol"; ``counts`` go into the fill span."""
        if self._desvel_set != self.desvel:
            with torch.inference_mode():
                self._desvel.fill_(self.desvel)
            self._desvel_set = self.desvel

        def make():
            bufs = buffers()
            events = (bufs["x"], bufs["y"], bufs["pol"]) if "x" in bufs else None
            return _Slot(bufs, self._body(bufs.get("frame"), self._desvel, events))

        with torch.inference_mode():
            return self._steps.run(self.graph_key(kind, size), make, fill, **counts)

    @with_precision
    def step_frame(self, frame):
        """One event frame (H, W), an array or a tensor on any device ->
        (velocity (3,), depth (H, W)) on the pipeline's device."""
        H, W = self.input_hw

        def fill(bufs):
            bufs["frame"].copy_(torch.as_tensor(frame, dtype=torch.float32).reshape(H, W))

        with profiling.span("evfly.stream.step"):
            return self._run("frame", H * W, lambda: {
                "frame": torch.zeros(H, W, device=self.device)}, fill)

    @with_precision
    def step_events(self, ex, ey, ep):
        """One window of raw events (N,) each, arrays or tensors on any
        device -> (velocity (3,), depth (H, W)).  The frame is
        ``event_histogram`` of the window (K1 on CUDA), the window padded
        to ``event_bucket(N)`` events with pol 0."""
        with profiling.span("evfly.stream.step"):
            ex, ey, ep = (torch.as_tensor(v) for v in (ex, ey, ep))
            if ex.dim() != 1 or ey.shape != ex.shape or ep.shape != ex.shape:
                raise ValueError(f"step_events takes one window of (N,) events, got "
                                 f"{tuple(ex.shape)}, {tuple(ey.shape)}, {tuple(ep.shape)}")
            n = ex.shape[0]
            size = event_bucket(n)
            self.stats.events += n
            self.stats.padded_events += size

            def buffers():
                f32 = dict(dtype=torch.float32, device=self.device)
                return {"x": torch.zeros(size, **f32), "y": torch.zeros(size, **f32),
                        "pol": torch.zeros(size, dtype=torch.int32, device=self.device)}

            def fill(bufs):
                for name, v in (("x", ex), ("y", ey), ("pol", _signs(ep))):
                    bufs[name][:n].copy_(v)
                    bufs[name][n:].zero_()

            return self._run("events", size, buffers, fill, events=n, bucket=size)


class BatchedStreamingPipeline(_Pipeline):
    """G independent event streams stepped in lockstep on one device.

    Every stream carries its own recurrent state; one forward takes the G
    frames with the stream axis leading, so the ConvLSTM runs with batch G
    and the head's LSTM is one launch for all G streams.  ``desvel`` is
    fixed at construction, as in the JAX package.

    Per-stream hidden reset is a mask argument (sim resets a stream when its
    quad re-enters pos.x < 0.5, run_competition.py:500-520), applied BEFORE
    the forward like ``StreamingPipeline.reset``: the masked streams' state
    is zeroed in place.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        num_streams: int,
        desvel: Union[float, Sequence[float], torch.Tensor] = 4.0,
        input_hw: Tuple[int, int] = (260, 346),
        quantile_scale: bool = True,
        fast_percentile: bool = False,
        device: DeviceLike = None,
        graph: bool = True,
    ):
        super().__init__(model, input_hw, quantile_scale, fast_percentile, device, graph,
                         num_streams)
        self.G = num_streams
        self.desvel = torch.broadcast_to(
            torch.as_tensor(desvel, dtype=torch.float32, device=self.device), (num_streams,)
        ).clone()

    def init_hidden(self):
        return self.model.init_hidden(streams=self.G)

    @with_precision
    def step_frames(self, frames, reset_mask=None):
        """frames (G, H, W) -> (velocities (G, 3) scaled by desvel, depths
        (G, H, W)).  ``reset_mask`` (G,) bool zeroes those streams'
        recurrent state before the forward."""
        G, (H, W) = self.G, self.input_hw
        with profiling.span("evfly.stream.step"), torch.inference_mode():
            if reset_mask is not None:
                mask = torch.as_tensor(reset_mask, dtype=torch.bool, device=self.device)
                for t in _leaves(self.hidden):
                    t.masked_fill_(mask.reshape(-1, *(1,) * (t.dim() - 1)), 0.0)

            def make():
                bufs = {"frame": torch.zeros(G, H, W, device=self.device)}
                return _Slot(bufs, self._body(bufs["frame"], self.desvel))

            def fill(bufs):
                bufs["frame"].copy_(torch.as_tensor(frames, dtype=torch.float32)
                                    .reshape(G, H, W))

            return self._steps.run(self.graph_key("frames", G), make, fill)
