"""V(phi): the paper's ViT + LSTM velocity policy, ``LSTMNetVIT``.

Port of ``LSTMNetVIT`` and ``refine_inputs`` of ``evfly_tpu/models/vitfly.py``
(3,563,663 params); its ``_speclin`` layers are ``common.SpectralLinear``.
The model takes a depth (or event) image (N, 1, H, W), the desired velocity
(N, 1) and an optional attitude quaternion (N, 4), and returns velocity
commands (N, 3) with the LSTM's (h, c).  The LSTM runs over the N axis as
its time axis (unbatched nn.LSTM semantics), so hidden states are (3, 128);
with a leading stream axis G (the batched streaming pipeline) they are
(G, 3, 128).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import imageops
from ..precision import with_precision
from .common import Conv2d, Params, SpectralLinear
from .recurrent import LSTM
from .vit import MixTransformerEncoderLayer


def refine_inputs(img: torch.Tensor, quat: Optional[torch.Tensor]):
    """Resize the image to 60x90 and default the quaternion to identity
    (vitfly_models.py:18-31)."""
    if quat is None:
        quat = img.new_zeros(img.shape[0], 4, dtype=torch.float32)
        quat[:, 0] = 1.0
    if img.shape[-2] != 60 or img.shape[-1] != 90:
        img = imageops.interpolate_bilinear(img, (60, 90), align_corners=False)
    return img, quat


class LSTMNetVIT(nn.Module):
    """ViT + LSTM, the paper's V(phi): 3,563,663 params."""

    def __init__(self, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.encoder_blocks = nn.ModuleList([
            MixTransformerEncoderLayer(1, 32, patch_size=7, stride=4, padding=3, n_layers=2,
                                       reduction_ratio=8, num_heads=1, expansion_factor=8,
                                       gen=gen, device=dev),
            MixTransformerEncoderLayer(32, 64, patch_size=3, stride=2, padding=1, n_layers=2,
                                       reduction_ratio=4, num_heads=2, expansion_factor=8,
                                       gen=gen, device=dev),
        ])
        self.decoder = SpectralLinear(4608, 512, gen, dev)
        self.lstm = LSTM(517, 128, 3, gen, dev, bias=True, dropout=0.1)
        self.nn_fc2 = SpectralLinear(128, 3, gen, dev)
        self.down_sample = Conv2d(48, 12, 3, gen, dev, padding=1)

    def load_params(self, params: Params) -> "LSTMNetVIT":
        """Load a state_dict (a checkpoint, or ``port.from_jax_params``);
        every key must match."""
        self.load_state_dict(params, strict=True)
        return self

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.encoder_blocks[0](x)   # (B, 32, 15, 23)
        e2 = self.encoder_blocks[1](e1)  # (B, 64, 8, 12)
        fused = torch.cat(
            [
                imageops.pixel_shuffle(e2, 2),                                    # (B, 16, 16, 24)
                imageops.interpolate_bilinear(e1, (16, 24), align_corners=True),  # (B, 32, 16, 24)
            ],
            dim=1,
        )
        fused = self.down_sample(fused)
        return self.decoder(fused.reshape(fused.shape[0], -1))

    @with_precision
    def forward(
        self,
        img: torch.Tensor,
        desvel: torch.Tensor,
        quat: Optional[torch.Tensor] = None,
        hidden: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """img (N, 1, H, W), desvel (N, 1), quat (N, 4) or None: the LSTM
        runs over N as its time axis, hidden (3, 128) each.  With a leading
        stream axis, img (G, N, 1, H, W), desvel (G, N, 1), quat (G, N, 4):
        G sequences through one LSTM launch, hidden (G, 3, 128) each.
        ``generator`` draws the LSTM's inter-layer dropout in training, as
        the JAX package's ``rng``; without one there is no dropout.  Runs at
        the precision of ``evfly_tpu_torch.set_precision``.
        Returns (velocity (..., 3), (h, c))."""
        lead = img.shape[:-3]
        img = img.reshape(-1, *img.shape[-3:])
        desvel = desvel.reshape(-1, desvel.shape[-1])
        if quat is not None:
            quat = quat.reshape(-1, quat.shape[-1])
        img, quat = refine_inputs(img, quat)
        out = torch.cat([self._encode(img), desvel / 10.0, quat], dim=1)
        out, h = self.lstm(out.reshape(*lead, out.shape[-1]), hidden, generator)
        return self.nn_fc2(out), h
