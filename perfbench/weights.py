"""Seeded weights, made on the device in a few large calls.

Each tensor follows the reference modules' initialisation (PyTorch's
defaults): U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for a conv or linear weight
and its bias (fan_in the product of the weight's trailing dims), U(-1/sqrt(H),
1/sqrt(H)) for every LSTM tensor, ones and zeros for a LayerNorm.  The
spectral-norm vectors u and v start from normal draws and take
``POWER_STEPS`` power iterations, as the training forward would have taken
them, so that sigma is the weight's spectral norm and not a random
projection of it.  Both the program and the reference load the result.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

POWER_STEPS = 30


def _bounds(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, float]:
    """key -> half-width of its uniform draw; None for a LayerNorm's
    tensors and the spectral-norm vectors."""
    bounds = {}
    for key, shape in shapes.items():
        base, leaf = key.rsplit(".", 1)
        if leaf.startswith(("weight_ih_l", "weight_hh_l", "bias_ih_l", "bias_hh_l")):
            bounds[key] = 1.0 / math.sqrt(shape[0] // 4)
        elif leaf in ("weight", "weight_orig") and len(shape) >= 2:
            bounds[key] = 1.0 / math.sqrt(math.prod(shape[1:]))
        elif leaf == "bias":
            w = shapes.get(base + ".weight", shapes.get(base + ".weight_orig"))
            bounds[key] = None if len(w) == 1 else 1.0 / math.sqrt(math.prod(w[1:]))
        else:
            bounds[key] = None
    return bounds


def init_state_dict(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """The state_dict of ``shapes`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bounds = _bounds(shapes)
    drawn = [k for k in shapes if bounds[k] is not None]
    sizes = [math.prod(shapes[k]) for k in drawn]
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    sd = {}
    for k, chunk in zip(drawn, torch.split(flat, sizes)):
        sd[k] = chunk.reshape(shapes[k]).mul_(bounds[k])
    for k, shape in shapes.items():
        if k in sd:
            continue
        if k.endswith((".weight_u", ".weight_v")):
            sd[k] = torch.randn(shape, generator=gen, device=device)
        else:  # LayerNorm
            sd[k] = (torch.ones if k.endswith(".weight") else torch.zeros)(shape, device=device)
    for k in shapes:
        if k.endswith(".weight_orig"):
            base = k[: -len(".weight_orig")]
            w, u = sd[k], sd[base + ".weight_u"]
            for _ in range(POWER_STEPS):
                v = torch.mv(w.t(), u)
                v = v / (v.norm() + 1e-12)
                u = torch.mv(w, v)
                u = u / (u.norm() + 1e-12)
            sd[base + ".weight_u"], sd[base + ".weight_v"] = u, v
    return {k: sd[k] for k in shapes}
