"""SegFormer-style MixTransformer blocks (efficient spatial-reduction attention).

Port of ``evfly_tpu/models/vit.py``: OverlapPatchMerging ->
[EfficientSelfAttention + MixFFN + LayerNorm] x n.  The attention is
within-frame spatial attention over <= 345 tokens against spatially reduced
keys and values; as in the JAX package (plain einsums there) it is written
out with ``torch.matmul`` and ``softmax``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import imageops
from .common import Conv2d, LayerNorm, Linear


class OverlapPatchMerging(nn.Module):
    def __init__(self, in_channels, out_channels, patch_size, stride, padding, gen, device):
        super().__init__()
        self.cn1 = Conv2d(in_channels, out_channels, patch_size, gen, device,
                          stride=stride, padding=padding)
        self.layerNorm = LayerNorm(out_channels, device)

    def forward(self, x):
        x = self.cn1(x)
        B, C, H, W = x.shape
        x = x.reshape(B, C, H * W).transpose(1, 2)  # (B, N, C)
        return self.layerNorm(x), H, W


class EfficientSelfAttention(nn.Module):
    def __init__(self, channels, reduction_ratio, num_heads, gen, device):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"channels {channels} not divisible by heads {num_heads}")
        self.heads = num_heads
        self.cn1 = Conv2d(channels, channels, reduction_ratio, gen, device, stride=reduction_ratio)
        self.ln1 = LayerNorm(channels, device)
        self.keyValueExtractor = Linear(channels, channels * 2, gen, device)
        self.query = Linear(channels, channels, gen, device)
        self.finalLayer = Linear(channels, channels, gen, device)

    def forward(self, x, H: int, W: int):
        B, N, C = x.shape
        heads, dh = self.heads, C // self.heads
        # spatial reduction of the key/value tokens
        x1 = self.cn1(x.transpose(1, 2).reshape(B, C, H, W))
        x1 = self.ln1(x1.reshape(B, C, -1).transpose(1, 2))  # (B, N', C)
        kv = self.keyValueExtractor(x1)
        n_red = kv.shape[1]
        kv = kv.reshape(B, n_red, 2, heads, dh).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]  # (B, heads, N', dh)
        q = self.query(x).reshape(B, N, heads, dh).transpose(1, 2)  # (B, heads, N, dh)
        scale = math.sqrt(C / heads)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / scale, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return self.finalLayer(out)


class MixFFN(nn.Module):
    def __init__(self, channels, expansion_factor, gen, device):
        super().__init__()
        expanded = channels * expansion_factor
        self.mlp1 = Linear(channels, expanded, gen, device)
        # groups = channels, NOT the expanded width (the reference's quirk)
        self.depthwise = Conv2d(expanded, expanded, 3, gen, device, padding="same",
                                groups=channels)
        self.mlp2 = Linear(expanded, channels, gen, device)

    def forward(self, x, H: int, W: int):
        x = self.mlp1(x)
        B, N, C = x.shape
        x = self.depthwise(x.transpose(1, 2).reshape(B, C, H, W))
        x = imageops.gelu_exact(x.reshape(B, C, N).transpose(1, 2))
        return self.mlp2(x)


class MixTransformerEncoderLayer(nn.Module):
    def __init__(self, in_channels, out_channels, patch_size, stride, padding, n_layers,
                 reduction_ratio, num_heads, expansion_factor, gen, device):
        super().__init__()
        self.patchMerge = OverlapPatchMerging(in_channels, out_channels, patch_size, stride,
                                              padding, gen, device)
        self._attn = nn.ModuleList(
            EfficientSelfAttention(out_channels, reduction_ratio, num_heads, gen, device)
            for _ in range(n_layers)
        )
        self._ffn = nn.ModuleList(
            MixFFN(out_channels, expansion_factor, gen, device) for _ in range(n_layers)
        )
        self._lNorm = nn.ModuleList(LayerNorm(out_channels, device) for _ in range(n_layers))

    def forward(self, x):
        B = x.shape[0]
        x, H, W = self.patchMerge(x)
        for attn, ffn, norm in zip(self._attn, self._ffn, self._lNorm):
            x = x + attn(x, H, W)
            x = x + ffn(x, H, W)
            x = norm(x)
        return x.reshape(B, H, W, -1).permute(0, 3, 1, 2)
