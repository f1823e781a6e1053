"""Open-loop dodge probe.

Port of ``tools/openloop_probe.py``.  Decides whether the closed-loop "no
dodge" failure (artifacts/eval_joint.json: every trial finishes at
commanded speed, mean 2.9 crashes, near-constant vy) is a COVARIATE-SHIFT
problem or a MODEL problem:

* feed the trained checkpoint the deployment input path
  (``stream.pipeline._quantile_scale`` -> composite forward, carried
  hidden) but on frames from EXPERT trajectories (the training
  distribution);
* if predicted vy tracks the expert's vy here, the model has learned the
  dodge mapping and the closed-loop failure is distribution shift -> DAgger
  is the right lever;
* if predicted vy is flat even here, the model ignores the events for vy and
  more epochs / DAgger cannot fix it.

Also reports the chunk-reset (training-semantics) variant to separate any
carried-hidden-state horizon effect, and depth-prediction quality (is
D(theta) good enough for V(phi) to see obstacles).

Each frame is one eager forward under ``torch.inference_mode()`` (desvel
changes per frame, so a ``StreamingPipeline`` with one desvel does not
fit); on the card its ViTLSTM runs kernel K4 at T = 1.  The velocities are
the model's normalized output, not x desvel.  Precision:
``set_precision("tf32")`` where the JAX tool sets "default".

  python -m evfly_tpu_torch.tools.openloop_probe --ckpt artifacts/joint_final.pth \\
      --h5 .data/evfly/data/datasets/simgen_forest_big.h5 --trajs 2 [--device cpu]

``probe_trajectory`` takes a trajectory dict in the h5 schema (``data``,
``depths``, ``desvel``, ``evs``), so a caller without h5py drives the probe
from memory.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..precision import set_precision
from .train_policy import ENC, FC, PRECISION, require_h5py

KINDS = ("joint", "vit_depth")


def build(ckpt: str, kind: str = "joint", device=None) -> torch.nn.Module:
    """The model of ``kind`` on ``device`` in eval mode, the values of
    ``ckpt`` loaded over its initial ones where the keys match."""
    from ..models import port
    from ..models.composites import OrigUNet_w_VITFLY_ViTLSTM
    from ..models.vitfly import LSTMNetVIT

    set_precision(PRECISION)
    dev = resolve_device(device)
    if kind == "vit_depth":
        # V(phi)-only probe: the pretrain_v stage (ViTLSTM on GT depth through
        # the clip(2*depth,0,1) hand-off transform, learner_models.py:634).
        # If THIS tracks vy while the joint model does not, the dodge failure
        # is localized to D(theta)'s predicted-depth quality.
        model = LSTMNetVIT(device=dev)
    elif kind == "joint":
        model = OrigUNet_w_VITFLY_ViTLSTM(
            device=dev, num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
            enc_params=ENC, fc_params=FC, input_shape=[1, 1, 260, 346],
            velpred=0, form_BEV=2, evs_min_cutoff=0.0, skip_type="interp",
        )
    else:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    params = port.load_into(model.state_dict(), port.load_state_dict(ckpt))
    return model.load_params(params).eval()


def _init_hidden(model, kind: str):
    if kind == "vit_depth":
        dev = model.nn_fc2.weight_orig.device
        return (torch.zeros(3, 128, device=dev), torch.zeros(3, 128, device=dev))
    return model.init_hidden()


def _step(model, kind: str, frame: torch.Tensor, dv: torch.Tensor, hidden):
    """One frame -> (normalized velocity (3,), depth (H, W) or 0, new hidden)."""
    from ..stream.pipeline import _quantile_scale

    if kind == "vit_depth":
        x = torch.clamp(frame * 2.0, 0.0, 1.0).reshape(1, 1, *frame.shape)
        vel, new_hidden = model(x, dv.reshape(1, 1), None, hidden)
        return vel[0], frame.new_zeros(()), new_hidden
    x = _quantile_scale(frame).reshape(1, 1, *frame.shape)
    vel, (depth, _up, new_hidden) = model(x, dv.reshape(1, 1), *hidden)
    return vel[0], depth[0, 0], new_hidden


def run_traj(model, evs: np.ndarray, desvel: np.ndarray, reset_every=None, kind: str = "joint"):
    """Sequential forward over a trajectory's frames -> (velocities (T, 3),
    depths (T, H, W) or (T,) zeros), numpy.

    reset_every=None -> carried hidden (deployment, run.py:259-262);
    reset_every=k    -> zero hidden every k frames (training chunk semantics).
    """
    dev = next(model.parameters()).device
    frames = torch.as_tensor(np.asarray(evs, np.float32), device=dev)
    dvs = torch.as_tensor(np.asarray(desvel, np.float32), device=dev)
    vels, depths = [], []
    with torch.inference_mode():
        hidden = _init_hidden(model, kind)
        for i in range(frames.shape[0]):
            if reset_every is not None and i % reset_every == 0:
                hidden = _init_hidden(model, kind)
            v, d, hidden = _step(model, kind, frames[i], dvs[i], hidden)
            vels.append(v)
            depths.append(d)
        return torch.stack(vels).cpu().numpy(), torch.stack(depths).cpu().numpy()


def stats(pred_vel, gt_vel, desvel):
    """pred_vel is normalized (model output); gt normalized by desvel."""
    gt = gt_vel / desvel[:, None]
    p, g = pred_vel[:, 1], gt[:, 1]
    act = np.abs(g) > 0.05  # frames where the expert actually dodges
    out = {
        "frames": int(len(g)),
        "frames_active": int(act.sum()),
        "corr_vy": float(np.corrcoef(p, g)[0, 1]) if np.std(p) > 1e-8 else 0.0,
        "mean_abs_vy_pred": float(np.abs(p).mean()),
        "mean_abs_vy_gt": float(np.abs(g).mean()),
        "p95_abs_vy_pred": float(np.percentile(np.abs(p), 95)),
        "p95_abs_vy_gt": float(np.percentile(np.abs(g), 95)),
        "sign_agree_active": float((np.sign(p[act]) == np.sign(g[act])).mean()) if act.any() else None,
        "mean_abs_vx_err": float(np.abs(pred_vel[:, 0] - gt[:, 0]).mean()),
    }
    return out


def probe_inputs(traj: Mapping[str, np.ndarray], kind: str, max_frames: int):
    """(frames, gt_vel (n, 3), desvel (n,), gt_depth) of a trajectory, as
    the JAX tool pairs them."""
    data = np.asarray(traj["data"])
    depths = np.asarray(traj["depths"], np.float32)
    desvel = np.asarray(traj["desvel"], np.float32)
    if kind == "vit_depth":
        # depth[i] pairs with meta row i, ids = 1..T-1 (learner.py)
        n = min(max_frames, depths.shape[0] - 1)
        frames = depths[1 : n + 1]
        return frames, data[1 : n + 1, 13:16].astype(np.float32), desvel[1 : n + 1], frames
    # evs[i] pairs with meta row i+1 (learner.py ids = 1..T-1)
    frames = np.asarray(traj["evs"], np.float32)[:max_frames]
    n = frames.shape[0]
    return (frames, data[1 : n + 1, 13:16].astype(np.float32), desvel[1 : n + 1],
            depths[1 : n + 1])


def probe_trajectory(model, traj: Mapping[str, np.ndarray], name: str, kind: str = "joint",
                     max_frames: int = 200, chunk: int = 16) -> Dict:
    """The JAX tool's report of one trajectory: carried and chunk-reset
    statistics, depth MAE (where the shapes agree) and seconds."""
    frames, gt_vel, dv, gt_depth = probe_inputs(traj, kind, max_frames)
    t0 = time.time()
    pv_carried, pd_carried = run_traj(model, frames, dv, kind=kind)
    pv_chunk, _ = run_traj(model, frames, dv, reset_every=chunk, kind=kind)
    dt = time.time() - t0
    return {
        "traj": name,
        "carried": stats(pv_carried, gt_vel, dv),
        "chunk_reset": stats(pv_chunk, gt_vel, dv),
        "depth_mae": (
            float(np.abs(pd_carried - gt_depth).mean())
            if pd_carried.ndim == gt_depth.ndim else None
        ),
        "gt_depth_mean": float(gt_depth.mean()),
        "sec": round(dt, 1),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--h5", required=True)
    ap.add_argument("--trajs", type=int, default=2)
    ap.add_argument("--max-frames", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--kind", choices=list(KINDS), default="joint")
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    h5py = require_h5py("openloop_probe --h5")
    model = build(args.ckpt, args.kind, args.device)
    reports = []
    with h5py.File(args.h5, "r") as f:
        keys = sorted(f.keys())
        # probe the LAST trajectories: with seed-7 val-fraction split these
        # are most likely val; either way expert-distribution inputs
        for k in keys[-args.trajs:]:
            g = f[k]
            traj = {name: np.asarray(g[name]) for name in ("data", "depths", "desvel")}
            if args.kind == "joint":
                traj["evs"] = np.asarray(g["evs"])
            rep = probe_trajectory(model, traj, k, args.kind, args.max_frames, args.chunk)
            reports.append(rep)
            print(json.dumps(rep, indent=2), flush=True)

    if args.out_json:
        with open(args.out_json, "w") as fh:
            json.dump({"ckpt": args.ckpt, "h5": args.h5, "trajs": reports}, fh, indent=2)
    return reports


if __name__ == "__main__":
    main()
