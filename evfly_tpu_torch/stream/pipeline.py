"""Streaming inference: a window of events -> depth -> velocity, state carried.

Port of ``evfly_tpu/stream/pipeline.py``.  The reference deployment loop
(evfly_ros/run.py:244-414) quantile-scales each event frame, runs the joint
model with its hidden state carried from frame to frame, and scales the
velocity by the desired speed.  Here each step runs eagerly under
``torch.inference_mode()``, at the precision of
``evfly_tpu_torch.set_precision`` (full f32 by default), with the hidden
state kept on the device: raw
events -> ``event_histogram`` (kernel K1 on CUDA) -> 97th-percentile scaling
-> ``OrigUNet`` with its ConvLSTM -> ``LSTMNetVIT`` (its LSTM through K4, or
K5 in the wavefront mode) -> velocity and depth.
``BatchedStreamingPipeline`` steps G streams in one forward, each with its
own state, where the JAX package vmaps the single-stream step.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from ..ops.percentile import approx_abs_quantile
from ..ops.voxelizer import event_histogram
from ..precision import with_precision


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


def _zero_streams(hidden, mask: torch.Tensor):
    """hidden (a nest of tuples and lists of (G, ...) tensors, or None) with
    the streams where ``mask`` (G,) is True set to 0."""
    if hidden is None:
        return None
    if isinstance(hidden, (tuple, list)):
        return type(hidden)(_zero_streams(h, mask) for h in hidden)
    return torch.where(mask.reshape(-1, *(1,) * (hidden.dim() - 1)), 0.0, hidden)


class StreamingPipeline:
    """Stateful streaming runner around the joint model
    (``models.composites.OrigUNet_w_VITFLY_ViTLSTM``): its forward takes
    (frames, desvel, hidden_unet, hidden_vit) with the composite hidden
    convention ((h_unet, h_velpred), h_vitlstm), and it has ``init_hidden()``.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        desvel: float = 4.0,
        input_hw: Tuple[int, int] = (260, 346),
        quantile_scale: bool = True,
        fast_percentile: bool = False,
        device: DeviceLike = None,
    ):
        self.device = _model_device(model, device)
        self.model = model.eval()
        self.desvel = desvel
        self.input_hw = input_hw
        self.quantile_scale = quantile_scale
        self.fast_percentile = fast_percentile
        self.hidden = model.init_hidden()

    def reset(self):
        """Zero the recurrent carry (sim resets when pos.x < 0.5,
        run_competition.py:500-520; never in real deployment)."""
        self.hidden = self.model.init_hidden()

    @torch.inference_mode()
    def _step(self, frame: torch.Tensor):
        if self.quantile_scale:
            frame = _quantile_scale(frame, fast=self.fast_percentile)
        x = frame.reshape(1, 1, *self.input_hw)
        desvel = torch.full((1, 1), self.desvel, dtype=torch.float32, device=self.device)
        vel, (depth, _upconv, self.hidden) = self.model(x, desvel, *self.hidden)
        return vel[0] * self.desvel, (depth[0, 0] if depth is not None else None)

    @with_precision
    def step_frame(self, frame):
        """One event frame (H, W) -> (velocity (3,), depth (H, W))."""
        return self._step(torch.as_tensor(frame, dtype=torch.float32, device=self.device))

    @with_precision
    def step_events(self, ex, ey, ep):
        """One window of raw events (N,) each -> (velocity (3,), depth (H, W)).
        The frame is ``event_histogram`` of the window (K1 on CUDA)."""
        with torch.inference_mode():
            frame = event_histogram(ex, ey, ep, *self.input_hw, device=self.device)
        return self._step(frame)


class BatchedStreamingPipeline:
    """G independent event streams stepped in lockstep on one device.

    Every stream carries its own recurrent state; one forward takes the G
    frames with the stream axis leading, so the ConvLSTM runs with batch G
    and the ViTLSTM's LSTM is one launch for all G streams.

    Per-stream hidden reset is a mask argument (sim resets a stream when its
    quad re-enters pos.x < 0.5, run_competition.py:500-520), applied BEFORE
    the forward like ``StreamingPipeline.reset``.
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
    ):
        self.device = _model_device(model, device)
        self.model = model.eval()
        self.G = num_streams
        self.input_hw = input_hw
        self.quantile_scale = quantile_scale
        self.fast_percentile = fast_percentile
        self.desvel = torch.broadcast_to(
            torch.as_tensor(desvel, dtype=torch.float32, device=self.device), (num_streams,)
        ).clone()
        self.hidden = self.init_hidden()

    def init_hidden(self):
        return self.model.init_hidden(streams=self.G)

    def reset(self):
        self.hidden = self.init_hidden()

    @with_precision
    @torch.inference_mode()
    def step_frames(self, frames, reset_mask=None):
        """frames (G, H, W) -> (velocities (G, 3) scaled by desvel, depths
        (G, H, W)).  ``reset_mask`` (G,) bool zeroes those streams'
        recurrent state before the forward."""
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        hidden = self.hidden
        if reset_mask is not None:
            mask = torch.as_tensor(reset_mask, dtype=torch.bool, device=self.device)
            hidden = _zero_streams(hidden, mask)
        if self.quantile_scale:
            frames = _quantile_scale(frames, fast=self.fast_percentile)
        x = frames.reshape(self.G, 1, 1, *self.input_hw)
        vel, (depth, _upconv, self.hidden) = self.model(
            x, self.desvel.reshape(self.G, 1, 1), *hidden
        )
        return vel[:, 0] * self.desvel[:, None], depth[:, 0, 0]
