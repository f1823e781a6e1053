"""The joint model: D(theta) events -> depth, then V(phi) depth -> velocity.

Port of ``OrigUNet_w_VITFLY_ViTLSTM`` of ``evfly_tpu/models/composites.py``
(reference learner_models.py:618-636): the UNet's interpolated depth is
scaled ``clip(depth * 2, 0, 1)`` before it feeds the ViTLSTM (the depth
scale V(phi) was trained on), and the hidden state is
``((h_unet, h_velpred), h_vitlstm)``.  Its state_dict keys are those of the
reference (``origunet.*``, ``vitfly_vitlstm.*``), so ``policy_best.pth``
loads as it is.  The other composites are not ported yet (ROADMAP §1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..precision import with_precision
from .common import Params
from .origunet import OrigUNet
from .vitfly import LSTMNetVIT


class OrigUNet_w_VITFLY_ViTLSTM(nn.Module):
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
    def forward(self, x: torch.Tensor, desvel: torch.Tensor, hidden_unet=None, hidden_vit=None):
        """x: event frames (N, 1, H, W), or (G, N, 1, H, W) for G streams;
        desvel (N, 1) or (G, N, 1); hidden_unet (h_unet, h_velpred) and
        hidden_vit (h, c), None for zeros.

        Returns (velocity, (depth, y_upconv, ((h_unet, h_velpred), h_vitlstm))).
        """
        _, (x_depth, y_upconv, h_unet_pair) = self.origunet(x, hidden_unet)
        x_vel, h_vit = self.vitfly_vitlstm(
            torch.clamp(x_depth * 2.0, 0.0, 1.0), desvel, None, hidden_vit
        )
        return x_vel, (x_depth, y_upconv, (h_unet_pair, h_vit))
