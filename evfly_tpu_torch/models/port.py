"""Weights into the port: torch checkpoints and the JAX package's params.

Both use the reference's state_dict keys and torch layouts, so carrying
them across is a cast and a move to the device: no transposes, no gate
reordering.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch ``.pth`` state_dict onto the CPU (``weights_only``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def from_jax_params(params: Mapping[str, np.ndarray], device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's flat param dict (numpy arrays) as tensors on
    ``device``; floating values become f32."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        t = torch.from_numpy(np.array(v))
        if t.is_floating_point():
            t = t.to(torch.float32)
        out[k] = t.to(dev)
    return out
