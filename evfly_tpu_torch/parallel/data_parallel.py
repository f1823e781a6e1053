"""Chunk-level data parallelism: ``evfly_tpu/parallel/data_parallel.py`` on
torch modules and ``torch.distributed``.

Training starts every chunk from a zero recurrent state (the reference's
``hidden=None`` per chunk), so trajectory chunks are independent work
items, while the frames inside a chunk are time for the ConvLSTM and the
LSTMs.  The unit of data parallelism is therefore the chunk: a step takes G
chunks, runs them through one forward with the chunks as the models' stream
axis (each with its own BatchNorm statistics), averages the loss, the
gradients and the BatchNorm updates over the real (not padded) chunks, and
takes one Adam step.  On one card that is ``dp_devices = 1,
dp_chunks_per_device = G``; across processes (one per card, ``mesh``) each
rank runs its contiguous G / world of the chunks and one all-reduce sums
what the mean needs.

The JAX package's differences, and why: it vmaps the forward over chunks
and lets XLA insert the psum, here one batched forward and one explicit
all-reduce; its ``num_batches_tracked`` comes out of the average as an f32
old + 1, here int64 with that value; its chunks draw dropout and
augmentation from one key each, here from one ``torch.Generator`` per
process in chunk order (no stream matches; with ``generator=None`` neither
draws).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.common import BatchNorm2d
from ..precision import precision_scope
from ..train.stepfn import (
    global_norm,
    make_chunk_gather,
    make_chunked_forward_loss,
    make_train_step,
    spectral_update_,
)
from ..utils import profiling
from .mesh import Mesh, make_mesh, shard_batch, spawn_ranks


def make_dp_train_step(model, kind: str, optimizer: torch.optim.Optimizer, mesh: Mesh,
                       loss_weights: Optional[Sequence[float]] = None,
                       optional_loss_param: Optional[Sequence[float]] = None,
                       data_augmentation: bool = False, num_out_channels: int = 1):
    """Frame-level DP: ``stepfn.make_train_step`` on the whole batch,
    step(batch, generator) -> (loss, values, gradnorm).

    The frame axis of a batch is the recurrences' time axis, so it cannot be
    split across processes: every rank computes the whole batch, the
    1-device function, as the JAX package's step computes whatever its mesh
    (its frames are sharded and XLA gathers them for the scans).  Chunk-level
    DP (``make_dp_chunked_train_step``) is the one that divides the work."""
    del mesh
    return make_train_step(model, kind, optimizer, loss_weights, optional_loss_param,
                           data_augmentation, num_out_channels)


def make_dp_chunked_train_step(model, kind: str, optimizer: torch.optim.Optimizer, mesh: Mesh,
                               B: int, num_in_channels: int, num_out_channels: int = 1,
                               loss_weights: Optional[Sequence[float]] = None,
                               optional_loss_param: Optional[Sequence[float]] = None,
                               data_augmentation: bool = False,
                               input_frame_scale: float = 1.0):
    """step(data, idxs, generator) -> (loss_sum, values_sum, gradnorm,
    n_real): one optimizer step over G chunks of B frames gathered from the
    device-resident split ``data`` (``stepfn.make_batch_slicer``'s layout).

    idxs: ``start``, ``ev_start``, ``n_valid``, each (G,) integers (a list,
    numpy or a tensor), the same on every rank; a chunk with ``n_valid`` 0
    is padding.  A step: one power iteration of every spectral norm; the
    real chunks of this rank's G / world through one forward
    (``stepfn.make_chunked_forward_loss``; a padded chunk adds 0 to every
    sum, so it is left out, where the JAX package computes and zeroes it);
    n_real = max(the real chunks over all ranks, 1), all-reduced before the
    backward; the backward of the local loss sum / n_real; a zero gradient
    for every parameter the loss does not reach (as ``make_train_step``);
    one all-reduce (SUM) of the gradients, the loss and terms' sums and the
    BatchNorms' sums of their real chunks' updates; the gradient norm; one
    step of ``optimizer``; the BatchNorm buffers set to the mean of the
    real chunks' updates.  loss_sum and values_sum are sums over the real
    chunks; all four are tensors on the mesh's device.  Two terms (the
    velocity and vision losses of ``combined_loss``).  Spans
    (``utils.profiling``): ``evfly.train.step`` holding
    ``evfly.train.forward`` (the power iteration and the forward;
    ``chunks``, this rank's real chunks), ``evfly.train.backward`` and
    ``evfly.train.update`` (the zero gradients, the all-reduce, the norm,
    the optimizer's step and the BatchNorm update).
    """
    gather = make_chunk_gather(B, num_in_channels, num_out_channels)
    forward = make_chunked_forward_loss(model, kind, loss_weights, optional_loss_param,
                                        data_augmentation, num_out_channels, input_frame_scale)
    params = [p for p in model.parameters() if p.requires_grad]
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]

    def step(data: Dict[str, torch.Tensor], idxs, generator: Optional[torch.Generator] = None):
        with profiling.span("evfly.train.step"):
            return _step(data, idxs, generator)

    def _step(data, idxs, generator):
        dev = data["depths"].device
        local = shard_batch({k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v,
                                           np.int64) for k, v in idxs.items()}, mesh)
        real = local["n_valid"] > 0
        n_total = mesh.all_reduce_sum_(torch.tensor(float(real.sum()), device=dev))
        n_real = torch.clamp(n_total, min=1.0)
        with precision_scope():
            with profiling.span("evfly.train.forward", chunks=int(real.sum())):
                model.train()
                spectral_update_(model)
                optimizer.zero_grad(set_to_none=True)
                # only the real chunks run: a padded one's loss is 0, but its
                # degenerate BatchNorm statistics (mean 0, variance 0) can
                # saturate a tanh into the velocity head's sqrt(1 - y^2), whose
                # infinite derivative times that 0 is NaN
                dtype = params[0].dtype
                loss_sum = torch.zeros((), dtype=dtype, device=dev)
                values_sum = torch.zeros(2, dtype=dtype, device=dev)
                for m in norms:
                    m.chunk_update = None
                if real.any():
                    losses, values = forward(
                        gather(data, {k: torch.from_numpy(v[real]).to(dev)
                                      for k, v in local.items()}),
                        generator)
                    loss_sum = losses.sum()
            if real.any():
                with profiling.span("evfly.train.backward"):
                    (loss_sum / n_real).backward()
                loss_sum, values_sum = loss_sum.detach(), values.detach().sum(0)
            with profiling.span("evfly.train.update"):
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                with torch.no_grad():
                    # every BatchNorm's (mean sum, var sum, chunks seen), zeros
                    # where this rank's forward did not reach it
                    bn = [m.chunk_update or (torch.zeros_like(m.running_mean),
                                             torch.zeros_like(m.running_var),
                                             torch.zeros((), device=dev)) for m in norms]
                    parts = ([p.grad for p in params] + [loss_sum, values_sum]
                             + [t.reshape(-1).to(dtype) for sums in bn for t in sums])
                    if mesh.world_size > 1:
                        flat = mesh.all_reduce_sum_(torch.cat([t.reshape(-1) for t in parts]))
                        for t, got in zip(parts, torch.split(flat, [t.numel() for t in parts])):
                            t.copy_(got.view_as(t))
                        bn = [tuple(parts[len(params) + 2 + 3 * i + j].reshape(sums[j].shape)
                                    for j in range(3)) for i, sums in enumerate(bn)]
                    gradnorm = global_norm([p.grad for p in params])
                optimizer.step()
                for m, (mean_sum, var_sum, seen) in zip(norms, bn):
                    m.apply_chunk_update(mean_sum, var_sum, seen)
                    m.chunk_update = None
        return loss_sum, values_sum, gradnorm, n_real

    return step


# ------------------------------------------------------------------ demos

FLAGSHIP_ENC = {
    "num_layers": 2, "kernel_sizes": [5, 3], "kernel_strides": [2, 2],
    "out_channels": [8, 32], "activations": ["relu", "relu"],
    "pool_type": "max", "invert_pool_inputs": True,
    "pool_kernels": [2, 2], "pool_strides": [2, 2], "conv_function": "conv2d",
}
FLAGSHIP_FC = {
    "num_layers": 4, "layer_sizes": [1024, 128, 16, 1],
    "activations": ["leaky_relu", "leaky_relu", "leaky_relu", "tanh"],
    "dropout_p": 0.1,
}
DEMO_LOSS = dict(loss_weights=[10.0, 1.0], optional_loss_param=[5.0, -1.0])


def _flagship_model(input_hw, device=None, state_dict=None, seed: int = 0):
    """The flagship joint composite (OrigUNet with its ConvLSTM bottleneck,
    then the ViTLSTM) at ``input_hw`` (the UNet's 5 valid levels need about
    188 px a side), with ``state_dict``'s values or from ``seed``."""
    from ..models.composites import OrigUNet_w_VITFLY_ViTLSTM

    model = OrigUNet_w_VITFLY_ViTLSTM(
        generator=torch.Generator().manual_seed(seed), device=device,
        num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
        enc_params=FLAGSHIP_ENC, fc_params=FLAGSHIP_FC,
        input_shape=[1, 1, input_hw[0], input_hw[1]],
        velpred=0, form_BEV=2, evs_min_cutoff=0.0, skip_type="interp")
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()})
    return model


def dp_chunked_demo_step(n_devices: int, input_hw=(188, 196), B: int = 4, G: int = 8,
                         chunks_per_device: int = 1, device=None, state_dict=None):
    """One step of the training path of ``Learner._dp_train_epoch``
    (``make_dp_chunked_train_step``) on a mesh of ``n_devices`` processes
    (this process's part of it; more than 1 needs the group), the JAX demo's
    synthetic data: the flagship joint model, the quantized residency
    layout (uint8 depths, int8 events, B pad rows), G chunks of B frames,
    one partial and one padded, Adam at 1e-4.  G is fixed apart from the
    mesh, so every mesh takes the same optimizer step.  No dropout: the
    chunks' draws would depend on the mesh.

    Returns (loss_sum, values, gradnorm, n_real) as floats."""
    assert G % max(n_devices * chunks_per_device, 1) == 0
    mesh = make_mesh(n_devices, device)
    dev = mesh.device
    model = _flagship_model(input_hw, dev, state_dict)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)

    H, W = input_hw
    rng = np.random.default_rng(0)
    n_frames, n_ev = 16, 14
    data = {
        "depths": torch.from_numpy(rng.integers(0, 256, (n_frames + B, H, W)).astype(np.uint8)),
        "evs": torch.from_numpy(rng.integers(-127, 128, (n_ev + B, H, W)).astype(np.int8)),
        "desvel": torch.full((n_frames + B,), 4.0),
        "velcmd": torch.from_numpy(rng.standard_normal((n_frames + B, 3)).astype(np.float32)),
    }
    data = {k: v.to(dev) for k, v in data.items()}
    step = make_dp_chunked_train_step(model, "joint_vitlstm", optimizer, mesh, B,
                                      num_in_channels=2, num_out_channels=1, **DEMO_LOSS)
    n_valids = np.full(G, B, np.int64)
    n_valids[G // 2] = max(B - 2, 1)   # a partial chunk
    n_valids[G - 1] = 0                # a padded chunk
    idxs = {"start": rng.integers(0, n_frames - B, G), "ev_start": rng.integers(0, n_ev - B, G),
            "n_valid": n_valids}
    loss_sum, values_sum, gradnorm, n_real = step(data, idxs, None)
    return float(loss_sum), [float(v) for v in values_sum], float(gradnorm), float(n_real)


def dp_train_demo_step(n_devices: int, input_hw=(188, 196), batch: int = 8, device=None,
                       state_dict=None):
    """One frame-level step (``make_dp_train_step``) of the flagship model
    on ``batch`` synthetic frames, on a mesh of ``n_devices``: every rank
    computes the whole batch.  Returns (loss, values, gradnorm) as floats."""
    mesh = make_mesh(n_devices, device)
    dev = mesh.device
    model = _flagship_model(input_hw, dev, state_dict)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    H, W = input_hw
    rng = np.random.default_rng(0)
    batch_data = {
        "input": rng.standard_normal((batch, 1, H, W)).astype(np.float32),
        "desvel": np.full((batch, 1), 4.0, np.float32),
        "gt_vel": rng.standard_normal((batch, 3)).astype(np.float32),
        "gt_frames": rng.random((batch, 1, H, W)).astype(np.float32),
        "mask": np.ones((batch,), np.float32),
    }
    step = make_dp_train_step(model, "joint_vitlstm", optimizer, mesh, **DEMO_LOSS)
    loss, values, gradnorm = step({k: torch.from_numpy(v).to(dev) for k, v in batch_data.items()},
                                  None)
    return float(loss), [float(v) for v in values], float(gradnorm)


def _dryrun_rank(mesh: Mesh, G: int, out: str, input_hw) -> None:
    result = dp_chunked_demo_step(mesh.world_size, input_hw=input_hw, G=G,
                                  device=mesh.device)
    if mesh.rank == 0:
        with open(out, "w") as fh:
            json.dump(result, fh)


def dryrun_chunked(n_devices: int, device=None, input_hw=(188, 196)) -> dict:
    """The port's multi-chip dry run (``__graft_entry__.dryrun_multichip``):
    ``dp_chunked_demo_step`` with G = max(n_devices, 8) on ``n_devices``
    processes (spawned when more than 1: NCCL with a card each, gloo when
    they share one or run on the CPU), then the same step in this process
    alone; checks a finite loss and gradient norm, n_real == G - 1 (the
    padded chunk left out) and the two results equal (loss rtol 1e-4,
    gradient norm 1e-3).  Prints its lines; returns the numbers."""
    t0 = time.time()
    dev = resolve_device(device)
    G = max(n_devices, 8)
    print(f"dryrun_chunked({n_devices}): {n_devices} process(es) on {dev}, the chunk-DP "
          f"train step (G={G})...", flush=True)
    if n_devices > 1:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rank0.json")
            spawn_ranks(_dryrun_rank, n_devices, G, out, input_hw, device=dev,
                        init_dir=os.path.join(tmp, "init"))
            with open(out) as fh:
                loss, values, gradnorm, n_real = json.load(fh)
    else:
        loss, values, gradnorm, n_real = dp_chunked_demo_step(1, input_hw=input_hw, G=G,
                                                              device=dev)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert np.isfinite(gradnorm), f"non-finite gradnorm {gradnorm}"
    assert n_real == G - 1, f"padded-chunk guard miscounted: n_real={n_real}"
    print(f"dryrun_chunked({n_devices}): chunk-DP loss_sum={loss:.4f} terms={values} "
          f"gradnorm={gradnorm:.4f} n_real={n_real:.0f}", flush=True)
    loss1, _values1, gradnorm1, n_real1 = dp_chunked_demo_step(
        1, input_hw=input_hw, G=G, chunks_per_device=G, device=dev)
    np.testing.assert_allclose(loss, loss1, rtol=1e-4)
    np.testing.assert_allclose(gradnorm, gradnorm1, rtol=1e-3)
    assert n_real1 == n_real
    print(f"dryrun_chunked: {n_devices}-process chunk-DP step matches one process (loss "
          f"{loss:.6f} vs {loss1:.6f}, gradnorm {gradnorm:.4f} vs {gradnorm1:.4f})", flush=True)
    print(f"dryrun_chunked({n_devices}): PASS ({time.time() - t0:.0f}s)", flush=True)
    return dict(loss_sum=loss, values=values, gradnorm=gradnorm, n_real=n_real,
                loss_sum_1=loss1, gradnorm_1=gradnorm1, seconds=time.time() - t0)
