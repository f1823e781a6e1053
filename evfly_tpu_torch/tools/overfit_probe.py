"""Single-trajectory overfit probe.

Port of ``tools/overfit_probe.py``.  If the training path is sound, a
3.5M-param ViTLSTM MUST be able to memorize one trajectory's
depth->velocity mapping (vel MSE << the constant-output floor, and
per-frame vy predictions that track the expert's).  If it cannot, the
failure seen in every round (near-constant lateral output) is a framework
bug, not a data problem.

Uses the training building blocks (``train.stepfn.make_train_step`` with
the pretrain_v loss knobs) on frames from one trajectory, then runs the
trained model once over all its frames as one sequence (on the card one
launch of kernel K4).  Precision: ``set_precision("tf32")`` where the JAX
tool sets "default".  Dropout draws from a ``torch.Generator`` seeded 1
(the JAX tool's ``PRNGKey(1)``: other draws, the same distribution).

  python -m evfly_tpu_torch.tools.overfit_probe \\
      --h5 .data/evfly/data/datasets/simgen_forest_big.h5 --steps 150 [--device cpu]

``overfit`` takes a trajectory dict in the h5 schema (``data``,
``depths``, ``desvel``; ``sim.closed_loop.rollout_to_trajectory`` returns
one), so a caller without h5py drives the probe from memory.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..precision import set_precision
from .train_policy import PRECISION, require_h5py


def read_trajectory(h5: str, traj_idx: int = -1) -> Dict[str, np.ndarray]:
    """Trajectory ``traj_idx`` of the sorted keys of an h5 dataset:
    ``data``, ``depths`` and ``desvel`` (needs h5py)."""
    h5py = require_h5py("overfit_probe --h5")
    with h5py.File(h5, "r") as f:
        g = f[sorted(f.keys())[traj_idx]]
        return {"data": np.asarray(g["data"]),
                "depths": np.asarray(g["depths"], np.float32),
                "desvel": np.asarray(g["desvel"], np.float32)}


def probe_frames(traj: Mapping[str, np.ndarray], max_frames: int):
    """(frames (n, 1, H, W), gt_vel (n, 3), desvel (n, 1), gt vy / desvel
    (n,), the constant-(1, 0, 0) floor MSE): the pretrain_v input of frames
    1..n, n = min(max_frames, T - 1), as the JAX tool takes them."""
    depths = np.asarray(traj["depths"], np.float32)
    n = min(max_frames, depths.shape[0] - 1)
    frames = depths[1 : n + 1][:, None]
    gt_vel = np.asarray(traj["data"])[1 : n + 1, 13:16].astype(np.float32)
    dv = np.asarray(traj["desvel"], np.float32)[1 : n + 1][:, None]
    nvy = gt_vel[:, 1] / dv[:, 0]
    floor = float(np.mean((gt_vel / dv - np.array([1.0, 0.0, 0.0])) ** 2))
    return frames, gt_vel, dv, nvy, floor


def chunk_batches(frames: np.ndarray, dv: np.ndarray, gt_vel: np.ndarray, chunk: int,
                  device=None) -> List[Dict[str, torch.Tensor]]:
    """The probe's chunks of ``chunk`` frames as train-step batches on
    ``device``: the last one zero-padded, its desvel padded with 1.0, and
    the frame mask marking the real frames."""
    dev = resolve_device(device)
    n = frames.shape[0]
    batches = []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        m, pad = hi - lo, chunk - (hi - lo)
        batch = {
            "input": np.pad(frames[lo:hi], ((0, pad), (0, 0), (0, 0), (0, 0))),
            "desvel": np.pad(dv[lo:hi], ((0, pad), (0, 0)), constant_values=1.0),
            "gt_vel": np.pad(gt_vel[lo:hi], ((0, pad), (0, 0))),
            "gt_frames": np.zeros((chunk, 1) + frames.shape[2:], np.float32),
            "mask": (np.arange(chunk) < m).astype(np.float32),
        }
        batches.append({k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    return batches


def overfit(traj: Mapping[str, np.ndarray], steps: int = 150, frames: int = 192,
            chunk: int = 32, lr: float = 1e-3, device=None,
            params: Optional[Mapping[str, torch.Tensor]] = None,
            log: Callable[[str], None] = print) -> dict:
    """Train a fresh ``LSTMNetVIT`` (or one holding ``params``) on the
    trajectory's frames for ``steps`` steps, chunks cycled, then run it in
    eval mode over all the frames as one sequence -> the JAX tool's report,
    with the trained model under ``"model"`` and the final check's
    normalized velocities (n, 3) under ``"vel"`` (not printed)."""
    from ..models.vitfly import LSTMNetVIT
    from ..train.stepfn import apply_for_loss, make_train_step

    set_precision(PRECISION)
    dev = resolve_device(device)
    x, gt_vel, dv, nvy, floor = probe_frames(traj, frames)
    n = x.shape[0]
    log(f"[OVERFIT] {n} frames, gt |vy|/desvel mean {np.abs(nvy).mean():.4f}, "
        f"constant-(1,0,0) floor MSE {floor:.5f}")

    model = LSTMNetVIT(device=dev)
    if params is not None:
        model.load_params(params)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    # pretrain_v loss knobs (tools/train_policy.py::cmd_pretrain_v)
    step = make_train_step(model, "vitfly", opt, loss_weights=[1.0, 0.0],
                           optional_loss_param=[5.0, 0.0], data_augmentation=False,
                           num_out_channels=1, input_frame_scale=2.0)
    batches = chunk_batches(x, dv, gt_vel, chunk, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    hist = []
    for s in range(steps):
        _loss, values, gradnorm = step(batches[s % len(batches)], gen)
        if s % 10 == 0 or s == steps - 1:
            hist.append((s, float(values[0]), float(gradnorm)))
            log(f"[OVERFIT] step {s:4d} vel_mse {hist[-1][1]:.5f} gradnorm {hist[-1][2]:.3f}")

    # final open-loop check on the SAME frames (eval mode); inference mode,
    # or the trained parameters' requires_grad sends the LSTM to the plain loop
    model.eval()
    with torch.inference_mode():
        inp = torch.clamp(torch.as_tensor(x, device=dev) * 2.0, 0.0, 1.0)
        vel, _ = apply_for_loss(model, "vitfly", inp, torch.as_tensor(dv, device=dev))
    vel = vel.cpu().numpy()
    p = vel[:, 1]
    return {
        "floor_mse": floor,
        "final_vel_mse": hist[-1][1],
        "pred_vy_std": float(p.std()),
        "corr_vy": float(np.corrcoef(p, nvy)[0, 1]) if p.std() > 1e-8 else 0.0,
        "overfit_ok": bool(hist[-1][1] < 0.5 * floor),
        "model": model,
        "vel": vel,
    }


def report(out: Mapping) -> dict:
    """The printed keys of ``overfit``'s result."""
    return {k: out[k] for k in ("floor_mse", "final_vel_mse", "pred_vy_std", "corr_vy",
                                "overfit_ok")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h5", required=True)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--frames", type=int, default=192)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--traj-idx", type=int, default=-1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    out = report(overfit(read_trajectory(args.h5, args.traj_idx), args.steps, args.frames,
                         args.chunk, args.lr, args.device,
                         log=lambda m: print(m, flush=True)))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
