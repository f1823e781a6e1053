"""Plain PyTorch reference of the joint model's per-chunk train step.

evfly's learner (learner.py:1047-1144) for ``OrigUNet_w_VITFLY_ViTLSTM``:
one power iteration of every spectral-norm layer, the forward in training
mode without dropout, the velocity's z set to 0, the loss 10 * (MSE of the
normalized velocity, 5x on frames with a y or z command) + 1 * (MSE of the
depth weighted by 1 / (gt + 0.1)), the backward, then Adam (lr 1e-4,
betas 0.9 and 0.999, eps 1e-8) over every trained tensor.  A step over G
chunks (chunk-level data parallelism) takes the mean of the chunks' losses,
each chunk a stream of its own from a zero state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import models

LOSS_WEIGHTS = (10.0, 1.0)
OPTIONAL_LOSS = (5.0, -1.0)


def decode_chunks(data: Dict[str, torch.Tensor], starts, B: int):
    """G chunks of B frames from the device-resident arrays, each with a
    leading (G,): events int8 / 127 (the input), depths uint8 / 255 (the
    target), desvel, velocity."""
    rows = torch.as_tensor([list(range(s, s + B)) for s in starts], device=data["evs"].device)
    inp = data["evs"][rows][:, :, None].to(torch.float32) / 127.0
    depth = data["depths"][rows][:, :, None].to(torch.float32) / 255.0
    return inp, depth, data["desvel"][rows][..., None], data["velcmd"][rows]


def loss(sd, inp, gt_depth, desvel, gt_vel):
    """The mean over G chunks of each full chunk's loss: chunks (G, B, ...)
    through the model at once, each chunk a stream from a zero state."""
    vel, depth, _, _ = models.joint(sd, inp, desvel)
    vel = torch.cat([vel[..., :2], torch.zeros_like(vel[..., 2:])], dim=-1)
    gt = gt_vel / desvel
    err = (gt - vel) ** 2
    yz = (gt[..., 1].abs() > 0) | (gt[..., 2].abs() > 0)
    v_term = (err * torch.where(yz, OPTIONAL_LOSS[0], 1.0)[..., None]).mean(dim=(1, 2))
    d_term = ((gt_depth - depth) ** 2 / (gt_depth + 0.1)).mean(dim=(1, 2, 3, 4))
    return (LOSS_WEIGHTS[0] * v_term + LOSS_WEIGHTS[1] * d_term).mean()


def trained_keys(sd) -> list:
    return [k for k in sd if not k.endswith((".weight_u", ".weight_v"))]


class Adam:
    """torch.optim.Adam's update, written out."""

    def __init__(self, keys, lr: float = 1e-4, betas=(0.9, 0.999), eps: float = 1e-8):
        self.keys, self.lr, self.b1, self.b2, self.eps = list(keys), lr, betas[0], betas[1], eps
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, sd, grads) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        with torch.no_grad():
            for k in self.keys:
                g = grads[k]
                m = self.m[k] = self.b1 * self.m.get(k, torch.zeros_like(g)) + (1 - self.b1) * g
                v = self.v[k] = self.b2 * self.v.get(k, torch.zeros_like(g)) + (1 - self.b2) * g * g
                sd[k].sub_(self.lr / bc1 * m / (v.sqrt() / bc2 ** 0.5 + self.eps))


def train_step(sd, adam: Adam, chunk) -> Tuple[float, Dict[str, torch.Tensor]]:
    """One step on ``sd`` in place over ``chunk`` (``decode_chunks``'s) ->
    (loss, gradient of each trained key)."""
    for name in models.spectral_names(sd):
        models.power_iteration(sd, name)
    params = {k: sd[k].detach().requires_grad_(True) for k in adam.keys}
    total = loss({**sd, **params}, *chunk)
    grads = dict(zip(adam.keys, torch.autograd.grad(total, [params[k] for k in adam.keys])))
    adam.step(sd, grads)
    return float(total.detach()), grads
