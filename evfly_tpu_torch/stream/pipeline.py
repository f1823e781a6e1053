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

Every streaming model steps as ``model.stream(frame, hidden, desvel) ->
(outputs, new hidden)`` and declares its input as ``stream_io``
(``models.common.StreamIO``; the composites' ``COMPOSITE_IO`` where it
declares none): the composites take the frame above and give (velocity,
depth); ``models.rvt.RVT`` takes a stacked histogram of the window's events
with their timestamps (``voxelizer.stacked_histogram``: time bins, a
megapixel sensor halved, counts clipped, no scaling) and gives its
detections, with four LSTM states carried.

The JAX package runs each step as one jitted program with the state
donated.  Here a pipeline keeps its inputs and its hidden state in static
device buffers, and on CUDA each step replays one captured CUDA graph
(``graph=True``, the default) that writes the new state back into the same
buffers; ``graph=False``, and every pipeline on the CPU, runs the same step
on the same buffers eagerly.  The capture, its warm-up and cuDNN's search,
the replay and the counters are ``graphs.Steps``'s (see ``graphs``).  A
graph is captured at the first step of its key (``graph_key``: everything
that picks a kernel or an algorithm at capture).  A window of N events is
padded with pol-0 events, which K1 drops, to ``event_bucket(N)`` events,
one graph for each size.

A pipeline's ``stats`` (``graphs.StepStats``) counts the steps and
captures per ``GraphKey``, and the real events handed to ``step_events``
against the padded events its kernels took.  While a ``torch.profiler``
records, each step is a span ``evfly.stream.step`` holding the steps'
``evfly.stream.fill`` (``events`` and ``bucket`` on ``step_events``),
``evfly.stream.replay`` or the eager body, and ``evfly.stream.capture``;
the body's ``evfly.frame`` (histogram and percentile scaling),
``evfly.depth`` and ``evfly.head`` are timed inside each graph.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from ..graphs import Slot, Steps
from ..models import recurrent
from ..models.common import COMPOSITE_IO, StreamIO
from ..ops import voxelizer
from ..ops.percentile import approx_abs_quantile
from ..precision import get_precision, with_precision
from ..utils import profiling

# windows of events are padded to a power of two of at least this many
EVENT_BUCKET_MIN = 1024


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


class GraphKey(NamedTuple):
    """What a captured step depends on beyond its buffers' addresses."""
    kind: str                 # "frame", "events" or "frames"
    size: int                 # the event bucket, or G for the batched step
    precision: str            # set_precision
    quantile: Tuple[bool, bool]  # (quantile_scale, fast_percentile)
    fused_lstm: bool          # set_fused_lstm
    lstm: Tuple[Tuple[str, str], ...]  # (mode, route) of each LSTM module
    k1_route: Optional[Tuple[str, int]]  # K1's route (kind, CTAs), for the events step


def stream_io(model: torch.nn.Module) -> StreamIO:
    """The model's declared streaming input and output (the composites'
    where it declares none)."""
    return getattr(model, "stream_io", COMPOSITE_IO)


def _events_frame(io: StreamIO, events, input_hw, device) -> torch.Tensor:
    """The frame of a window of events as the model takes it: K1's
    histogram of (x, y, pol), or the stacked histogram of (x, y, pol, t, n)."""
    if io.time_bins:
        return voxelizer.stacked_histogram(*events, io.time_bins, io.frame_hw, io.downsample,
                                           io.clip)
    return voxelizer.event_histogram(*events, *input_hw, device=device)


# the buffers of a window's event columns: K1's (float coordinates, int32
# signs, padding of pol 0), or, for a stacked histogram, a camera's types
# (16-bit coordinates, 8-bit polarity, 64-bit microseconds), with the count
# of real events ``n`` by which the histogram leaves the padding out
_K1_COLUMNS = {"x": torch.float32, "y": torch.float32, "pol": torch.int32}
_CAMERA_COLUMNS = {"x": torch.int16, "y": torch.int16, "pol": torch.int8, "t": torch.int64}


def _step_body(model, hidden, input_hw, quantile_scale: bool, fast_percentile: bool,
               frame: Optional[torch.Tensor], desvel: torch.Tensor, events=None):
    """The step over static buffers: the frame (or the histogram of the
    events), the model, the new state copied into ``hidden``.  It holds no
    reference to its pipeline, so that a pipeline and its graphs are freed
    as soon as the last reference to the pipeline goes."""
    device = desvel.device
    io = stream_io(model)

    def body():
        with profiling.span("evfly.frame"):
            x = frame
            if events is not None:
                x = _events_frame(io, events, input_hw, device)
            if quantile_scale:
                x = _quantile_scale(x, fast=fast_percentile)
        outputs, new_hidden = model.stream(x, hidden, desvel)
        for dst, src in zip(_leaves(hidden), _leaves(new_hidden)):
            dst.copy_(src)
        return outputs

    return body


class _Pipeline:
    """What the single-stream and the batched pipeline share: the model on
    its device, the hidden state in static buffers, and the steps."""

    def __init__(self, model, input_hw, quantile_scale, fast_percentile, device, graph,
                 streams: Optional[int]):
        self.device = _model_device(model, device)
        self.model = model.eval()
        self.io = stream_io(model)
        # the events' sensor: the model's where the caller names none
        self.input_hw = tuple(input_hw or self.io.sensor_hw or (260, 346))
        self.quantile_scale = quantile_scale and self.io.quantile_scale
        self.fast_percentile = fast_percentile
        self._lstms = [m for m in model.modules() if isinstance(m, recurrent.LSTM)]
        with torch.inference_mode():
            self.hidden = model.init_hidden(streams=streams)
        self._steps = Steps(self.device, graph, _leaves(self.hidden))
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
            recurrent.fused_lstm_enabled(), tuple(m.kernel() for m in self._lstms),
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
    """Stateful streaming runner around a model that declares its
    streaming input and output (``stream_io``), or a two-stage model of
    ``models.composites``: the joint ``OrigUNet_w_VITFLY_ViTLSTM`` or
    ``OrigUNet_w_ConvNet_w_VelPred``, whose forward takes (frames, desvel,
    hidden_unet, hidden_head) with the composite hidden convention
    ((h_unet, h_velpred), h_head), h_head the ViTLSTM's or the
    ConvNet_w_VelPred LSTM's (h, c); ``models.rvt.RVT``, whose ``stream``
    takes a stacked histogram and its four stages' (h, c).  The model has
    ``init_hidden(streams)``.  ``hidden`` holds the state in static
    buffers, which each step and ``reset`` write in place; every
    ``recurrent.LSTM`` of the model is packed for its kernel outside the
    capture and keys the graph by its mode and route.  ``desvel`` (read by
    the composites only) may change between steps.  ``input_hw`` is the
    events' sensor (None: the model's declared ``sensor_hw``, else 260x346);
    ``quantile_scale`` applies to the composites' frames.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        desvel: float = 4.0,
        input_hw: Optional[Tuple[int, int]] = None,
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
            events = (tuple(bufs[k] for k in ("x", "y", "pol", "t", "n") if k in bufs)
                      if "x" in bufs else None)
            return Slot(bufs, self._body(bufs.get("frame"), self._desvel, events))

        with torch.inference_mode():
            return self._steps.run(self.graph_key(kind, size), make, fill, **counts)

    def frame_shape(self) -> Tuple[int, ...]:
        """The shape of the frame ``step_frame`` takes: (H, W), or the
        stacked histogram's (2 T, H, W)."""
        if self.io.time_bins:
            return (2 * self.io.time_bins, *self.io.frame_hw)
        return tuple(self.input_hw)

    @with_precision
    def step_frame(self, frame):
        """One event frame (``frame_shape()``), an array or a tensor on any
        device -> the model's outputs on the pipeline's device: (velocity
        (3,), depth (H, W)) for the composites."""
        shape = self.frame_shape()

        def fill(bufs):
            bufs["frame"].copy_(torch.as_tensor(frame, dtype=torch.float32).reshape(shape))

        with profiling.span("evfly.stream.step"):
            return self._run("frame", math.prod(shape), lambda: {
                "frame": torch.zeros(shape, device=self.device)}, fill)

    @with_precision
    def step_events(self, ex, ey, ep, et=None):
        """One window of raw events (N,) each, arrays or tensors on any
        device -> the model's outputs: (velocity (3,), depth (H, W)) for
        the composites, whose frame is ``event_histogram`` of (ex, ey, ep)
        (K1 on CUDA), the window padded to ``event_bucket(N)`` events with
        pol 0; for a model of time bins (``stream_io``) the stacked
        histogram of (ex, ey, ep, et), ``et`` the integer timestamps (the
        window's order), the window padded to ``event_bucket(N)`` events
        that the histogram leaves out by their index."""
        binned = bool(self.io.time_bins)
        columns = _CAMERA_COLUMNS if binned else _K1_COLUMNS
        with profiling.span("evfly.stream.step"):
            if binned and et is None:
                raise ValueError("this model bins events by time: step_events needs et")
            cols = tuple(torch.as_tensor(v) for v in (ex, ey, ep, et)[:len(columns)])
            n = cols[0].shape[0]
            if cols[0].dim() != 1 or any(v.shape != cols[0].shape for v in cols):
                raise ValueError(f"step_events takes one window of (N,) events, got "
                                 f"{[tuple(v.shape) for v in cols]}")
            if not binned:
                cols = cols[:2] + (_signs(cols[2]),)
            size = event_bucket(n)
            self.stats.events += n
            self.stats.padded_events += size

            def buffers():
                bufs = {name: torch.zeros(size, dtype=dtype, device=self.device)
                        for name, dtype in columns.items()}
                if binned:
                    bufs["n"] = torch.zeros((), dtype=torch.int64, device=self.device)
                return bufs

            def fill(bufs):
                for name, v in zip(columns, cols):
                    bufs[name][:n].copy_(v)
                    bufs[name][n:].zero_()
                if binned:
                    bufs["n"].fill_(n)

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
        if self.io.time_bins:
            raise NotImplementedError("BatchedStreamingPipeline steps the composites' frames; "
                                      "a model of time bins streams one camera "
                                      "(StreamingPipeline.step_events)")
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
                return Slot(bufs, self._body(bufs["frame"], self.desvel))

            def fill(bufs):
                bufs["frame"].copy_(torch.as_tensor(frames, dtype=torch.float32)
                                    .reshape(G, H, W))

            return self._steps.run(self.graph_key("frames", G), make, fill)
