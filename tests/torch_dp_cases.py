"""Shared cases of the port's data-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_dp_joint.py, tests/test_torch_dp_learner.py).

This module imports neither JAX nor the JAX package: the ranks that
``parallel.mesh.spawn_ranks`` starts import it (``convnet_steps``), and they
must not load JAX.

The data is a device-resident split in ``stepfn.make_batch_slicer``'s
layout, made from a numpy seed, and chunk index lists with a partial chunk
and padded ones, as ``Learner._dp_train_epoch`` pads an epoch.
"""

import sys

import numpy as np
import torch

from evfly_tpu_torch.models.vitfly import ConvNet
from evfly_tpu_torch.parallel.data_parallel import make_dp_chunked_train_step

CONVNET_HW = (60, 90)   # ConvNet's own input size
CONVNET_LOSS = dict(loss_weights=[1.0, 0.0], optional_loss_param=[5.0, 0.0])
LR = 1e-5


def resident_split(seed: int, n_frames: int, n_ev: int, hw, B: int, depth_input: bool = False):
    """A split as the Learner keeps it on the device, as f32 numpy: depths
    (or event frames) padded with B zero rows, desvel 4 (1 on the pad
    rows), velocity commands with some zero y."""
    rng = np.random.default_rng(seed)
    depths = rng.random((n_frames + B, *hw)).astype(np.float32)
    evs = (rng.integers(-3, 4, (n_ev + B, *hw)) * (rng.random((n_ev + B, *hw)) < 0.2) * 0.3)
    depths[n_frames:] = 0.0
    evs[n_ev:] = 0.0
    velcmd = np.stack([np.full(n_frames + B, 4.0), rng.normal(size=n_frames + B) * 0.8,
                       np.zeros(n_frames + B)], 1)
    velcmd[::3, 1] = 0.0
    velcmd[n_frames:] = 0.0
    desvel = np.concatenate([np.full(n_frames, 4.0), np.ones(B)])
    return {"depths": depths, "evs": np.clip(evs, -1, 1).astype(np.float32),
            "desvel": desvel.astype(np.float32), "velcmd": velcmd.astype(np.float32)}


def chunk_idxs(seed: int, G: int, B: int, n_frames: int, n_ev: int, partial: int,
               padded: int):
    """(G,) start, ev_start and n_valid: chunk ``partial`` holds B - 2
    frames, the last ``padded`` chunks none (copies of chunk 0)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, n_frames - B, G)
    ev_starts = rng.integers(0, n_ev - B, G)
    n_valid = np.full(G, B)
    n_valid[partial] = B - 2
    if padded:
        n_valid[G - padded:] = 0
        starts[G - padded:] = starts[0]
        ev_starts[G - padded:] = ev_starts[0]
    return {"start": starts, "ev_start": ev_starts, "n_valid": n_valid}


def torch_split(split, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in split.items()}


# the ConvNet steps of the gloo test: G chunks of B frames, two steps
CONVNET_G, CONVNET_B, CONVNET_FRAMES = 4, 4, 24
CONVNET_STEPS = ((31, 1, 1), (32, 0, 2))   # (idx seed, partial chunk, padded chunks)


def convnet_steps(mesh, out_path=None):
    """Two chunk-DP steps of a seeded ``ConvNet`` (a BatchNorm, no dropout)
    on ``mesh``: [(loss_sum, values_sum, gradnorm, n_real)] and the state
    after; rank 0 saves both to ``out_path`` when given (a process of its
    own: it holds itself to 2 threads, as the test files' processes)."""
    if out_path is not None:
        torch.set_num_threads(2)
    model = ConvNet(generator=torch.Generator().manual_seed(3), device=mesh.device)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_dp_chunked_train_step(model, "vitfly", opt, mesh, CONVNET_B, 1, 1, **CONVNET_LOSS)
    data = torch_split(resident_split(30, CONVNET_FRAMES, CONVNET_FRAMES, CONVNET_HW, CONVNET_B,
                                      depth_input=True), mesh.device)
    results = []
    for seed, partial, padded in CONVNET_STEPS:
        idxs = chunk_idxs(seed, CONVNET_G, CONVNET_B, CONVNET_FRAMES, CONVNET_FRAMES, partial,
                          padded)
        loss, values, gn, n_real = step(data, idxs, None)
        results.append((loss.item(), values.cpu().numpy(), gn.item(), n_real.item()))
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    if out_path is not None and mesh.rank == 0:
        # what this process loaded of JAX or the JAX package: nothing
        jax_modules = [m for m in sys.modules if m.split(".")[0] in ("jax", "evfly_tpu")]
        torch.save({"results": results, "state": state, "jax_modules": jax_modules}, out_path)
    return results, state
