"""The legacy competition-era ViT (the reference's envtest/ros/network.py).

Port of ``evfly_tpu/models/legacy_vit.py``: PatchEmbed -> cls token +
learned positional embedding -> N TransformerBlocks -> LayerNorm -> a
3-vector head on the cls token, with the state_dict keys of the torch
module (``patch_embed.proj.weight``, ``layers.0.attention.values.weight``,
``layers.0.feed_forward.2.bias``, ...).  The JAX package keeps the
reference's quirks as its parity contract, and so does this port:

* the attention scales by ``embed_size ** 0.5``, not ``head_dim ** 0.5``;
* the mask, when one is given, is applied after the softmax;
* ``layer(value, key, query)`` routes its first argument to the queries'
  projection, the third to the values' projection, and the residual adds
  the third;
* the forward returns ``out[0]``, the first batch element only, shape (3,).

Dropout is omitted (the reference's eval mode), as in the JAX package.  The
attention is plain ``torch.matmul`` and ``softmax``:
``scaled_dot_product_attention`` computes another function here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import imageops
from ..precision import with_precision
from .common import Conv2d, LayerNorm, Linear, Params


class _CrossAttention(nn.Module):
    """network.py:39-74 ``CrossAttention``."""

    def __init__(self, embed_size: int, heads: int, gen, dev):
        super().__init__()
        self.embed_size, self.heads = embed_size, heads
        self.values = Linear(embed_size, embed_size, gen, dev, bias=False)
        self.keys = Linear(embed_size, embed_size, gen, dev, bias=False)
        self.queries = Linear(embed_size, embed_size, gen, dev, bias=False)
        self.fc_out = Linear(embed_size, embed_size, gen, dev)

    def forward(self, value, key, query, mask):
        N, qlen, E = value.shape
        klen = key.shape[1]
        h, dh = self.heads, E // self.heads
        values = self.values(query).reshape(N, klen, h, dh).transpose(1, 2)   # (N, h, k, dh)
        keys = self.keys(key).reshape(N, klen, h, dh).transpose(1, 2)
        queries = self.queries(value).reshape(N, qlen, h, dh).transpose(1, 2)  # (N, h, q, dh)
        energy = torch.matmul(queries, keys.transpose(-1, -2))                # (N, h, q, k)
        attention = torch.softmax(energy / math.sqrt(E), dim=3)
        if mask is not None:  # after the softmax, as the reference
            attention = torch.where(mask == 0, torch.full_like(attention, -1e20), attention)
        out = torch.matmul(attention, values).transpose(1, 2).reshape(N, qlen, h * dh)
        return self.fc_out(out)


class _TransformerBlock(nn.Module):
    """network.py:135-152 ``TransformerBlock`` (no dropout)."""

    def __init__(self, embed_size: int, heads: int, forward_expansion: int, gen, dev):
        super().__init__()
        self.attention = _CrossAttention(embed_size, heads, gen, dev)
        self.norm1 = LayerNorm(embed_size, dev)
        self.norm2 = LayerNorm(embed_size, dev)
        self.feed_forward = nn.ModuleDict({
            "0": Linear(embed_size, forward_expansion * embed_size, gen, dev),
            "2": Linear(forward_expansion * embed_size, embed_size, gen, dev),
        })

    def forward(self, value, key, query, mask):
        x = self.norm1(self.attention(value, key, query, mask) + query)
        ff = self.feed_forward["2"](torch.relu(self.feed_forward["0"](x)))
        return self.norm2(ff + x)


class LegacyTransformer(nn.Module):
    """network.py:157-210 ``Transformer``: an encoder-only ViT with a
    3-vector head.  cls_token and pos_embed start at zero, as in torch."""

    def __init__(self, img_size=(60, 90), patch_size: int = 6, in_chans: int = 1,
                 embed_size: int = 96, num_layers: int = 3, heads: int = 4,
                 forward_expansion: int = 4, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        if embed_size % heads:
            raise ValueError("Embed size needs to be div by heads")
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.patch_size, self.embed_size = patch_size, embed_size
        n_patches = (img_size[0] // patch_size) * (img_size[1] // patch_size)
        self.patch_embed = nn.ModuleDict({
            "proj": Conv2d(in_chans, embed_size, patch_size, gen, dev, stride=patch_size)})
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_size, device=dev))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + n_patches, embed_size, device=dev))
        self.layers = nn.ModuleList(
            _TransformerBlock(embed_size, heads, forward_expansion, gen, dev)
            for _ in range(num_layers))
        self.norm = LayerNorm(embed_size, dev)
        self.fc_out = Linear(embed_size, 3, gen, dev)

    def load_params(self, params: Params) -> "LegacyTransformer":
        """Load a state_dict (a checkpoint, or ``port.from_jax_params``);
        every key must match."""
        self.load_state_dict(params, strict=True)
        return self

    @with_precision
    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, C, H, W) -> (3,): the head's output for batch element 0,
        as the reference returns it.  Runs at the precision of
        ``evfly_tpu_torch.set_precision``."""
        N, E = x.shape[0], self.embed_size
        x = self.patch_embed["proj"](x)
        x = x.reshape(N, E, -1).transpose(1, 2)
        out = torch.cat([self.cls_token.expand(N, 1, E), x], dim=1) + self.pos_embed
        for layer in self.layers:
            out = layer(out, out, out, mask)
        out = self.norm(out)
        return imageops.linear(out[:, 0], self.fc_out.weight, self.fc_out.bias)[0]
