"""The train and eval steps: ``evfly_tpu/train/stepfn.py`` on torch modules.

The reference's per-model-type dispatch (learner.py:1047-1083): which
outputs feed which loss term, and which models have their z velocity set to
0; the spectral-norm power iteration before each training forward; the
chunk gather from device-resident data.  These are plain functions on
tensors and ``nn.Module``s, run eagerly.

Padding is inert: the loss is exactly masked, the recurrences are causal,
so a padded chunk's tail never reaches its real frames, and in training the
chunk's frame mask reaches every BatchNorm (the velocity heads'), whose
batch statistics and running-stat updates then cover the valid frames only.
A padded chunk's step is the step of its valid frames alone, the
reference's ragged chunk.  The BatchNorms write their running stats and
counters into their buffers during the forward, where the JAX package
merges its ``updates`` after the optimizer step; Adam never sees buffers.
Each chunk starts from a zero recurrent state, as the reference's
``hidden=None`` per chunk.

In a train step the model is in training mode, so its LSTM runs the plain
loop (a gradient is needed, ``recurrent.fused_wanted``) with its dropout
drawn from the step's generator; an eval step runs in eval mode under
``torch.no_grad``, so on the card the LSTM is one launch of kernel K4 (or
K5) over the chunk as its time axis.  Both run at the precision of
``evfly_tpu_torch.set_precision``.

``make_chunk_gather`` and ``make_chunked_forward_loss`` are the G-chunk
forms that chunk-level data parallelism (``parallel/``) runs: G chunks
gathered at once and forwarded as the models' stream axis, a loss per
chunk.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from ..data.augment import augment_chunk
from ..models.common import Params
from ..ops.imageops import spectral_norm_power_iteration
from ..precision import precision_scope
from ..utils import profiling
from .losses import combined_loss

Batch = Dict[str, torch.Tensor]


def _zero_z(vel: torch.Tensor) -> torch.Tensor:
    """vel (..., 3) with its z column set to 0 (no gradient reaches it)."""
    return torch.cat([vel[..., :2], torch.zeros_like(vel[..., 2:])], dim=-1)


def apply_for_loss(model, kind: str, inp: torch.Tensor, desvel: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   frame_mask: Optional[torch.Tensor] = None):
    """Run the model per the reference dispatch -> (pred_vel, pred_vision or
    None).  ``generator`` draws dropout in training; None means none.
    ``frame_mask`` (N,) marks the valid frames of a padded chunk for every
    BatchNorm; None in eval.  With G chunks, inp (G, N, 1, H, W), desvel
    (G, N, 1) and ``frame_mask`` (G, N): the chunks are the models' stream
    axis, each from a zero recurrent state with its own BatchNorm
    statistics, and the outputs keep the leading (G, N)."""
    if kind == "origunet":
        vel, (y_interp, _up, _h) = model(inp, None, generator, frame_mask)
        return vel, y_interp
    if kind == "vitfly":
        vel, _h = model(inp, desvel, None, None, generator, frame_mask)
        return _zero_z(vel), None
    if kind == "joint_vitlstm":
        vel, (depth, _up, _h) = model(inp, desvel, None, None, generator, frame_mask)
        return _zero_z(vel), depth
    if kind == "joint_convnet":
        vel, (depth, _up, _h) = model(inp, desvel, None, None, generator, frame_mask)
        return vel, depth
    if kind == "convnet_velpred":
        vel, _h = model(inp, desvel, None, generator, frame_mask)
        return vel, None
    raise ValueError(kind)


def make_forward_loss(model, kind: str, loss_weights: Optional[Sequence[float]],
                      optional_loss_param: Optional[Sequence[float]],
                      data_augmentation: bool = False, num_out_channels: int = 1,
                      train: bool = True, input_frame_scale: float = 1.0) -> Callable:
    """batch = {input, desvel, gt_vel, gt_frames, mask} ->
    (loss, values (n_terms,), pred_vel, pred_vision).

    ``input_frame_scale != 1`` maps inputs through clip(scale x, 0, 1), the
    V(phi)-pretraining transform matching the composite's clip(2 depth, 0, 1)
    hand-off (learner_models.py:634).  Augmentation runs only in training,
    its draws from the generator, which must then be given.
    """

    def forward_loss(batch: Batch, generator: Optional[torch.Generator]):
        inp, desvel = batch["input"], batch["desvel"]
        if input_frame_scale != 1.0:
            inp = torch.clamp(inp * input_frame_scale, 0.0, 1.0)
        gt_norm_vel = batch["gt_vel"] / desvel
        gt_frames = batch["gt_frames"]
        mask = batch["mask"]
        if train and data_augmentation:
            if generator is None:
                raise ValueError("data augmentation draws from a generator; none was given")
            inp, gt_norm_vel, gt_frames = augment_chunk(
                generator, inp, gt_norm_vel, gt_frames, num_out_channels)
        pred_vel, pred_vision = apply_for_loss(
            model, kind, inp, desvel, generator if train else None, mask if train else None)
        preds = [pred_vel, pred_vision if pred_vision is not None else torch.zeros_like(gt_frames)]
        batch_loss, values = combined_loss([gt_norm_vel, gt_frames], preds, mask,
                                           loss_weights, optional_loss_param)
        return batch_loss, torch.stack(values), pred_vel, pred_vision

    return forward_loss


def spectral_updates(params: Mapping[str, torch.Tensor]) -> Params:
    """One power iteration of every spectral-norm layer of ``params`` (a
    state_dict) -> its new ``weight_u`` and ``weight_v``."""
    out: Params = {}
    for k, w in params.items():
        if k.endswith(".weight_orig"):
            base = k[: -len(".weight_orig")]
            u, v = spectral_norm_power_iteration(
                w, params[base + ".weight_u"], params[base + ".weight_v"])
            out[base + ".weight_u"] = u
            out[base + ".weight_v"] = v
    return out


def spectral_update_(model: torch.nn.Module) -> None:
    """``spectral_updates`` of the model, written into its u and v buffers
    in place, outside autograd."""
    with torch.no_grad():
        state = model.state_dict(keep_vars=True)
        for k, t in spectral_updates({k: v.detach() for k, v in state.items()}).items():
            state[k].copy_(t)


def _decode(a: torch.Tensor) -> torch.Tensor:
    """The residency dtype back to f32: int8 / 127, uint8 / 255, bf16 cast."""
    if a.dtype == torch.int8:
        return a.to(torch.float32) / 127.0
    if a.dtype == torch.uint8:
        return a.to(torch.float32) / 255.0
    return a.to(torch.float32)


def make_batch_slicer(B: int, num_in_channels: int, num_out_channels: int) -> Callable:
    """(data, idx) -> batch: one chunk gathered from device-resident arrays.

    data: {'depths' (N+B, H, W), 'evs' (M+B, H, W), 'desvel' (N+B,),
    'velcmd' (N+B, 3)}, padded with B trailing zero frames so a slice never
    runs off the end; idx: {'start', 'ev_start', 'n_valid'} ints.  Frames
    are dequantized (int8 / 127, uint8 / 255) or cast from bf16; padded
    frames get desvel 1 and mask 0.
    """

    def get_batch(data: Mapping[str, torch.Tensor], idx: Mapping[str, int]) -> Batch:
        s, e = int(idx["start"]), int(idx["ev_start"])
        ev_rows = data["evs"][e:e + B, None]
        depth_rows = data["depths"][s:s + B, None]
        inp = _decode(ev_rows if num_in_channels == 2 else depth_rows)
        gt_frames = _decode(ev_rows if num_out_channels == 2 else depth_rows)
        mask = (torch.arange(B, device=inp.device) < int(idx["n_valid"])).to(torch.float32)
        desvel = torch.where(mask[:, None] > 0, data["desvel"][s:s + B, None], 1.0)
        gt_vel = data["velcmd"][s:s + B]
        return {"input": inp, "desvel": desvel, "gt_vel": gt_vel, "gt_frames": gt_frames,
                "mask": mask}

    return get_batch


def make_chunk_gather(B: int, num_in_channels: int, num_out_channels: int) -> Callable:
    """(data, idxs) -> batch of G chunks: ``make_batch_slicer``'s chunk for
    each of idxs' (G,) ``start``, ``ev_start`` and ``n_valid`` (integer
    tensors on the data's device), each array read with one indexed gather
    of (G, B) rows: input and gt_frames (G, B, 1, H, W), desvel (G, B, 1)
    (1 on padded frames), gt_vel (G, B, 3), mask (G, B)."""

    def gather(data: Mapping[str, torch.Tensor], idxs: Mapping[str, torch.Tensor]) -> Batch:
        dev = data["depths"].device
        offs = torch.arange(B, device=dev)
        rows = idxs["start"].to(dev, torch.int64)[:, None] + offs
        ev_rows = idxs["ev_start"].to(dev, torch.int64)[:, None] + offs
        evs = data["evs"][ev_rows][:, :, None] if 2 in (num_in_channels, num_out_channels) else None
        depths = data["depths"][rows][:, :, None]
        inp = _decode(evs if num_in_channels == 2 else depths)
        gt_frames = _decode(evs if num_out_channels == 2 else depths)
        mask = (offs < idxs["n_valid"].to(dev)[:, None]).to(torch.float32)
        desvel = torch.where(mask[..., None] > 0, data["desvel"][rows][..., None], 1.0)
        return {"input": inp, "desvel": desvel, "gt_vel": data["velcmd"][rows],
                "gt_frames": gt_frames, "mask": mask}

    return gather


def make_chunked_forward_loss(model, kind: str, loss_weights: Optional[Sequence[float]],
                              optional_loss_param: Optional[Sequence[float]],
                              data_augmentation: bool = False, num_out_channels: int = 1,
                              input_frame_scale: float = 1.0) -> Callable:
    """The training forward over G chunks at once: batch (``make_chunk_
    gather``'s, leading (G, B)), generator -> (losses (G,), values
    (G, n_terms)).  The model runs once with the chunks as its stream axis;
    each chunk's loss and logged terms are ``combined_loss`` over that
    chunk's mask alone (a chunk with no valid frame gives 0), the JAX
    package's ``vmap`` of ``make_forward_loss`` over chunks.  Augmentation
    draws per chunk, in chunk order, from ``generator``, which must then be
    given; dropout draws from it too, and None means no dropout."""

    def forward_loss(batch: Batch, generator: Optional[torch.Generator]):
        inp, desvel, mask = batch["input"], batch["desvel"], batch["mask"]
        if input_frame_scale != 1.0:
            inp = torch.clamp(inp * input_frame_scale, 0.0, 1.0)
        gt_norm_vel = batch["gt_vel"] / desvel
        gt_frames = batch["gt_frames"]
        if data_augmentation:
            if generator is None:
                raise ValueError("data augmentation draws from a generator; none was given")
            chunks = [augment_chunk(generator, inp[g], gt_norm_vel[g], gt_frames[g],
                                    num_out_channels) for g in range(inp.shape[0])]
            inp, gt_norm_vel, gt_frames = (torch.stack(t) for t in zip(*chunks))
        pred_vel, pred_vision = apply_for_loss(model, kind, inp, desvel, generator, mask)
        if pred_vision is None:
            pred_vision = torch.zeros_like(gt_frames)
        losses, values = [], []
        for g in range(inp.shape[0]):
            loss, vals = combined_loss([gt_norm_vel[g], gt_frames[g]],
                                       [pred_vel[g], pred_vision[g]], mask[g], loss_weights,
                                       optional_loss_param)
            losses.append(loss)
            values.append(torch.stack(vals))
        return torch.stack(losses), torch.stack(values)

    return forward_loss


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm of all the tensors together (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def make_train_step(model, kind: str, optimizer: torch.optim.Optimizer,
                    loss_weights, optional_loss_param, data_augmentation: bool = False,
                    num_out_channels: int = 1, batch_fn: Optional[Callable] = None,
                    input_frame_scale: float = 1.0) -> Callable:
    """step(batch, generator) -> (loss, values, gradnorm), tensors on the
    model's device; with ``batch_fn`` the step takes (data, idx, generator)
    and gathers the chunk itself (``make_batch_slicer``).

    One step: a power iteration of every spectral-norm layer (kept in the
    model's u and v buffers); the forward in training mode and the
    backward; the global L2 norm of the gradients of every parameter,
    before the update; one step of ``optimizer`` (Adam over every
    parameter, as ``optax.masked(optax.adam)`` over the trainable keys).  A
    parameter the loss does not reach gets a zero gradient, so Adam steps it
    as optax steps every leaf.  Spans (``utils.profiling``):
    ``evfly.train.step`` holding ``evfly.train.forward`` (the power
    iteration and the forward), ``evfly.train.backward`` and
    ``evfly.train.update`` (the zero gradients, the norm and the
    optimizer's step).
    """
    forward_loss = make_forward_loss(model, kind, loss_weights, optional_loss_param,
                                     data_augmentation, num_out_channels, train=True,
                                     input_frame_scale=input_frame_scale)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Batch, generator: Optional[torch.Generator] = None):
        with profiling.span("evfly.train.step"), precision_scope():
            with profiling.span("evfly.train.forward"):
                model.train()
                spectral_update_(model)
                optimizer.zero_grad(set_to_none=True)
                loss, values, _pv, _pd = forward_loss(batch, generator)
            with profiling.span("evfly.train.backward"):
                loss.backward()
            with profiling.span("evfly.train.update"):
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                gradnorm = global_norm([p.grad for p in params])
                optimizer.step()
        return loss.detach(), values.detach(), gradnorm.detach()

    if batch_fn is None:
        return step

    def indexed_step(data, idx, generator: Optional[torch.Generator] = None):
        return step(batch_fn(data, idx), generator)

    return indexed_step


def make_eval_step(model, kind: str, loss_weights, optional_loss_param,
                   num_out_channels: int = 1, batch_fn: Optional[Callable] = None,
                   input_frame_scale: float = 1.0) -> Callable:
    """step(batch) -> (loss, values, pred_vel, pred_vision): the forward in
    eval mode under ``torch.no_grad``, without augmentation or dropout; with
    ``batch_fn`` the step takes (data, idx)."""
    forward_loss = make_forward_loss(model, kind, loss_weights, optional_loss_param,
                                     data_augmentation=False,
                                     num_out_channels=num_out_channels, train=False,
                                     input_frame_scale=input_frame_scale)

    def step(batch: Batch):
        with precision_scope(), torch.no_grad():
            model.eval()
            return forward_loss(batch, None)

    if batch_fn is None:
        return step

    def indexed_step(data, idx):
        return step(batch_fn(data, idx))

    return indexed_step
