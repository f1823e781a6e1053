"""Weights into and out of the port: torch checkpoints, the JAX package's
params, and the reference's checkpoint semantics.

Both packages use the reference's state_dict keys and torch layouts, so
carrying weights across is a cast and a move to the device: no transposes,
no gate reordering.  A file ``save_state_dict`` writes loads with the JAX
package's ``port.load_state_dict``, and a file the JAX package saves loads
here.  Also the reference's checkpoint surgery (learner.py:435-494):
``combine_state_dicts`` with first-dict precedence and per-model prefixes,
``load_into`` with ``strict=False`` partial loads, and the epoch parsed from
the file name's characters [-10:-4].
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch ``.pth`` state_dict onto the CPU (``weights_only``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_state_dict(params: Mapping[str, torch.Tensor], path: str) -> None:
    """Write params as a ``.pth`` state_dict: detached CPU tensors, in the
    order of ``params``."""
    torch.save({k: v.detach().to("cpu").clone() for k, v in params.items()}, path)


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


def combine_state_dicts(
    state_dicts: Sequence[Mapping[str, torch.Tensor]],
    model_names: Optional[Sequence[str]] = None,
) -> Dict[str, torch.Tensor]:
    """Merge state dicts, each key prefixed with its model's name when
    ``model_names`` is given; the first dict wins a conflict
    (learner.py:435-454)."""
    combined: Dict[str, torch.Tensor] = {}
    for i, sd in enumerate(state_dicts):
        for key, value in sd.items():
            if model_names is not None:
                key = f"{model_names[i]}.{key}"
            if key not in combined:
                combined[key] = value
    return combined


def load_into(params: Mapping[str, torch.Tensor], state_dict: Mapping[str, torch.Tensor],
              strict: bool = False, prefix: str = "") -> Params:
    """``params`` with the values of ``state_dict`` where it has the key
    (``prefix`` stripped from the key of params), cast to each param's dtype
    and device.  strict=False keeps the values of missing keys and ignores
    unexpected ones, as torch's ``load_state_dict(strict=False)``; a shape
    mismatch raises either way."""
    new = dict(params)
    missing = []
    for k, cur in params.items():
        sk = k[len(prefix):] if prefix and k.startswith(prefix) else k
        if sk in state_dict:
            v = torch.as_tensor(state_dict[sk])
            if v.is_floating_point():
                v = v.to(cur.dtype)
            if tuple(v.shape) != tuple(cur.shape):
                raise ValueError(f"shape mismatch for {k}: {tuple(v.shape)} vs {tuple(cur.shape)}")
            new[k] = v.to(cur.device)
        else:
            missing.append(k)
    if strict:
        unexpected = [k for k in state_dict if prefix + k not in params]
        if missing or unexpected:
            raise KeyError(f"missing={missing[:5]}... unexpected={unexpected[:5]}...")
    return new


def parse_epoch_from_path(checkpoint_path: str) -> int:
    """The epoch count in the file name's characters [-10:-4]
    (``model_ep000012.pth`` -> 12; learner.py:464-468), 0 if there is none."""
    try:
        return int(checkpoint_path[-10:-4])
    except (ValueError, TypeError):
        return 0
