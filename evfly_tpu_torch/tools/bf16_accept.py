"""bf16-encoder serving-rung acceptance A/B.

Port of ``tools/bf16_accept.py``: runs the ViTLSTM forward on identical
inputs with f32 weights and with the serving bf16 cast (every f32 tensor
of the model outside ``lstm.*`` in bf16, the spectral-norm u and v
included, and the input frames in bf16), and prints one JSON line with the
velocity deltas.  The serving tolerance is the deployment contract scale:
commands are vel*desvel with desvel~4 m/s and the sim quantizes nothing
finer than ~1e-2 m/s, so max|dvel| <= 5e-3 (normalized) is acceptable.

Each op of the bf16 arm computes in the dtype JAX's promotion gives it:
the encoder and its decoder in bf16; the concatenation with desvel / 10
and the identity quaternion in f32; the 3-layer LSTM in f32 (on the card
kernel K4 over the 256 frames, T = 256); ``nn_fc2``, an f32 input times its
bf16-rounded weights, in f32 (``ops.imageops.linear`` promotes).  Both arms
run at ``set_precision("tf32")``, where the JAX tool sets "default".  The
weights are ``LSTMNetVIT``'s initial ones from its ``torch.Generator``
(seed 0), not ``jax.random.PRNGKey(0)``'s, so the numbers are not the JAX
tool's.

  python -m evfly_tpu_torch.tools.bf16_accept [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json

import numpy as np
import torch

from ..device import resolve_device
from ..precision import set_precision
from .train_policy import PRECISION

WINDOWS = 256
TOLERANCE = 5e-3


def bf16enc(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` with every f32 parameter and buffer whose name
    does not start with ``lstm.`` cast to bf16."""
    out = copy.deepcopy(model)
    for name, t in itertools.chain(out.named_parameters(), out.named_buffers()):
        if t.dtype == torch.float32 and not name.startswith("lstm."):
            t.data = t.data.to(torch.bfloat16)
    return out


def inputs(n: int = WINDOWS, device=None):
    """(frames (n, 1, 60, 90) uniform from numpy seed 0, desvel (n, 1) of 4)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    small = torch.as_tensor(rng.uniform(0, 1, (n, 1, 60, 90)), dtype=torch.float32, device=dev)
    return small, torch.full((n, 1), 4.0, dtype=torch.float32, device=dev)


def arms(model: torch.nn.Module, small: torch.Tensor, desvel: torch.Tensor):
    """The velocities (n, 3) of the f32 arm and of the bf16 arm."""
    model = model.eval()
    b16 = bf16enc(model)
    with torch.inference_mode():
        vf = model(small, desvel)[0]
        vb = b16(small.to(torch.bfloat16), desvel)[0]
    return vf, vb


def accept_report(vf: torch.Tensor, vb: torch.Tensor) -> dict:
    """The JAX tool's JSON line of the two arms' velocities."""
    dv = np.abs(vf.float().cpu().numpy() - vb.float().cpu().numpy())
    return {
        "windows": int(dv.shape[0]),
        "max_abs_dvel_normalized": float(dv.max()),
        "mean_abs_dvel_normalized": float(dv.mean()),
        "max_abs_dvel_mps_at_desvel4": float(dv.max() * 4.0),
        "tolerance_normalized": TOLERANCE,
        "accept": bool(dv.max() <= TOLERANCE),
    }


def main(argv=None) -> dict:
    from ..models.vitfly import LSTMNetVIT

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    set_precision(PRECISION)
    dev = resolve_device(args.device)
    out = accept_report(*arms(LSTMNetVIT(device=dev), *inputs(WINDOWS, dev)))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
