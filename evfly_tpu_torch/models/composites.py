"""Two-stage models: D(theta) events -> depth, then a depth -> velocity head.

Port of ``evfly_tpu/models/composites.py``:

* ``OrigUNet_w_VITFLY_ViTLSTM``, the joint model (reference
  learner_models.py:618-636): the UNet's interpolated depth is scaled
  ``clip(depth * 2, 0, 1)`` before it feeds the ViTLSTM (the depth scale
  V(phi) was trained on), and the hidden state is
  ``((h_unet, h_velpred), h_vitlstm)``.  Its state_dict keys are those of
  the reference (``origunet.*``, ``vitfly_vitlstm.*``), so
  ``policy_best.pth`` loads as it is.
* ``ConvNet_w_VelPred``: ``DynamicConvNet`` -> an optional LSTM over the
  frames -> ``VelPredictor`` (keys ``convnet.*``, ``lstm.*``,
  ``velpred_head.*``).  The reference names this class and never defines
  it (learner_models.py:638-658); this is the JAX package's working
  stand-in, which the port follows.
* ``OrigUNet_w_ConvNet_w_VelPred``: the UNet's decoder output ``y_upconv``
  (1, 68, 148 at 260x346) through a ``ConvNet_w_VelPred``; the hidden state
  is ``((h_unet, None), h_cv)``.

The two composites stream as ``stream(frame, hidden, desvel)`` (the
pipelines' step protocol), which is ``stream.pipeline.stream_step`` on a
frame already scaled.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..precision import with_precision
from ..utils import profiling
from .common import Params
from .layers import VelPredictor, dynamic_convnet, head_features
from .origunet import OrigUNet
from .recurrent import LSTM
from .vitfly import LSTMNetVIT


class _Streamed:
    def stream(self, frame: torch.Tensor, hidden, desvel: torch.Tensor):
        """One streaming step of a scaled frame (H, W), or (G, H, W) for G
        streams -> ((velocity scaled by desvel, depth), the new hidden
        state)."""
        from ..stream import pipeline  # the pipeline imports the models
        vel, depth, new_hidden = pipeline.stream_step(self, frame, desvel, hidden,
                                                      quantile_scale=False)
        return (vel, depth), new_hidden


class OrigUNet_w_VITFLY_ViTLSTM(_Streamed, nn.Module):
    def __init__(self, generator: Optional[torch.Generator] = None, device: DeviceLike = None,
                 **origunet_kwargs):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.origunet = OrigUNet(generator=gen, device=dev, **origunet_kwargs)
        self.vitfly_vitlstm = LSTMNetVIT(generator=gen, device=dev)

    def load_params(self, params: Params) -> "OrigUNet_w_VITFLY_ViTLSTM":
        """Load a state_dict (a checkpoint, or ``port.from_jax_params``);
        every key must match."""
        self.load_state_dict(params, strict=True)
        return self

    def init_hidden(self, streams: Optional[int] = None):
        """Zero ((h_unet, h_velpred), (h, c) of the ViTLSTM) on the module's
        device, for one stream or with a leading axis of ``streams``."""
        shape = (3, 128) if streams is None else (streams, 3, 128)
        dev = self.vitfly_vitlstm.nn_fc2.weight_orig.device
        h_vit = (torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
        return (self.origunet.init_hidden(streams), h_vit)

    @with_precision
    def forward(self, x: torch.Tensor, desvel: torch.Tensor, hidden_unet=None, hidden_vit=None,
                generator: Optional[torch.Generator] = None,
                frame_mask: Optional[torch.Tensor] = None):
        """x: event frames (N, 1, H, W), or (G, N, 1, H, W) for G streams;
        desvel (N, 1) or (G, N, 1); hidden_unet (h_unet, h_velpred) and
        hidden_vit (h, c), None for zeros.  ``generator`` draws the ViTLSTM's
        dropout in training, as the JAX package's ``rng``; without one there
        is no dropout.  ``frame_mask`` reaches D(theta)'s head, if it has one.

        Returns (velocity, (depth, y_upconv, ((h_unet, h_velpred), h_vitlstm))).
        D(theta) is the span ``evfly.depth``, V(phi) ``evfly.head``
        (``utils.profiling``).
        """
        with profiling.span("evfly.depth"):
            _, (x_depth, y_upconv, h_unet_pair) = self.origunet(x, hidden_unet, generator,
                                                                frame_mask)
        x_vel, h_vit = self.vitfly_vitlstm(
            torch.clamp(x_depth * 2.0, 0.0, 1.0), desvel, None, hidden_vit, generator
        )
        return x_vel, (x_depth, y_upconv, (h_unet_pair, h_vit))


class ConvNet_w_VelPred(nn.Module):
    def __init__(self, num_in_channels: int = 1, num_recurrent: int = 0, num_outputs: int = 1,
                 enc_params: Optional[dict] = None, fc_params: Optional[dict] = None,
                 input_shape=(1, 1, 68, 148), generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_recurrent = num_recurrent
        self.convnet = dynamic_convnet(num_in_channels, enc_params, gen, dev)
        c, h, w = self.convnet.output_shape((input_shape[-2], input_shape[-1]))
        self.feat_size = c * h * w
        if num_recurrent > 0:
            self.lstm = LSTM(self.feat_size, self.feat_size, num_recurrent, gen, dev, dropout=0.1)
        self.velpred_head = VelPredictor(self.feat_size, num_outputs, fc_params, gen, dev)

    def init_hidden(self, streams: Optional[int] = None):
        """Zero (h, c) of the LSTM, each (L, F) or (streams, L, F), on the
        module's device; None without an LSTM."""
        if self.num_recurrent == 0:
            return None
        shape = (self.num_recurrent, self.feat_size)
        shape = shape if streams is None else (streams, *shape)
        dev = self.velpred_head.fcnet.layers.fc_0.weight.device
        return (torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))

    @with_precision
    def forward(self, x: torch.Tensor, desvel: Optional[torch.Tensor] = None, hidden=None,
                generator: Optional[torch.Generator] = None,
                frame_mask: Optional[torch.Tensor] = None):
        """x: frames (N, C, H, W), a sequence whose N axis is the LSTM's time
        axis, or (G, N, C, H, W), G streams; hidden (h, c) or None for
        zeros; desvel is not read.  ``generator`` draws the dropout in
        training; ``frame_mask`` (N,) marks the valid frames of a padded
        chunk for the BatchNorm statistics, (G, N) with G streams: each
        chunk's statistics its own.

        Returns (velocity (..., 3), the LSTM's (h, c) or None)."""
        lead = x.shape[:-3]
        feats = self.convnet(x.reshape(-1, *x.shape[-3:]), frame_mask)
        feats = feats.reshape(feats.shape[0], -1)
        h = None
        if self.num_recurrent > 0:
            seq, h = self.lstm(head_features(feats, lead), hidden, generator)
            feats = seq.reshape(feats.shape)
        vel = self.velpred_head(feats, generator)
        return vel.reshape(*lead, vel.shape[-1]), h


class OrigUNet_w_ConvNet_w_VelPred(_Streamed, nn.Module):
    def __init__(self, num_outputs: int = 1, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, **origunet_kwargs):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        # the head reads the decoder's output, (1, 68, 148) at 260x346 (the
        # JAX composite's fixed input_shape), so D(theta) decodes when
        # deploying too (the JAX composite has no y_upconv there at velpred 0)
        self.origunet = OrigUNet(generator=gen, device=dev,
                                 **{**origunet_kwargs, "is_deployment": False})
        nr = self.origunet.num_recurrent
        self.convnet_w_velpred = ConvNet_w_VelPred(
            1, nr[1] if len(nr) > 1 else 0, num_outputs, origunet_kwargs.get("enc_params"),
            origunet_kwargs.get("fc_params"), (1, 1, *self.origunet.decoded_hw), gen, dev)

    def load_params(self, params: Params) -> "OrigUNet_w_ConvNet_w_VelPred":
        """Load a state_dict; every key must match."""
        self.load_state_dict(params, strict=True)
        return self

    def init_hidden(self, streams: Optional[int] = None):
        """Zero ((h_unet, h_velpred), h_cv) on the module's device, for one
        stream or with a leading axis of ``streams``."""
        return (self.origunet.init_hidden(streams), self.convnet_w_velpred.init_hidden(streams))

    @with_precision
    def forward(self, x: torch.Tensor, desvel: Optional[torch.Tensor] = None, hidden_unet=None,
                hidden_cv=None, generator: Optional[torch.Generator] = None,
                frame_mask: Optional[torch.Tensor] = None):
        """x: event frames (N, 1, H, W), or (G, N, 1, H, W) for G streams;
        hidden_unet (h_unet, h_velpred) and hidden_cv (h, c), None for
        zeros; desvel is not read.  ``generator`` and ``frame_mask`` as in
        ``ConvNet_w_VelPred``.

        Returns (velocity, (depth, y_upconv, ((h_unet, None), h_cv))).
        """
        _, (x_depth, y_upconv, (h_unet, _)) = self.origunet(x, hidden_unet, generator,
                                                            frame_mask)
        x_vel, h_cv = self.convnet_w_velpred(y_upconv, None, hidden_cv, generator, frame_mask)
        return x_vel, (x_depth, y_upconv, ((h_unet, None), h_cv))
