"""Scaled expert data generation via lockstep batched rollouts on the card.

Port of ``tools/datagen.py``: N expert trials in batches of G (one render +
difflog of the whole batch per sensor tick, ``sim/batched.py``), packaged
into the reference h5 trajectory schema.

  python -m evfly_tpu_torch.tools.datagen --out DIR --trials 120 --batch 24 \\
      --name simgen_forest_big [--mode state|planner] [--record-flow] [--device cpu]

``generate_trajectories`` returns the trajectory dicts; ``generate`` writes
them with ``write_h5_dataset``, which needs ``h5py`` (without it
``generate`` raises ImportError before flying; hand the dicts to
``data.dataloading.cache_dataset`` instead).  With ``record_flow`` each
kept trajectory carries its exact optical flow per frame (f16), rendered
from the logged camera states through ``render_rgbd_flow`` against the
trial's obstacles padded to ``obstacle_pad`` (plain tensors: nothing is
compiled per shape).
"""

from __future__ import annotations

import argparse
import os
import time
from os.path import join as opj

import numpy as np
import torch

from ..device import resolve_device
from .train_policy import OUT, require_h5py


def traj_flows(traj, field, obstacle_pad: int = 48, trees: bool = True, device=None):
    """Per-frame exact optical flow (T, H, W, 2) f16 of a kept trajectory —
    rendered post-hoc from the logged camera states (data.csv layout: pos
    at cols 7-9, vel at 10-12) and the trial's obstacle field.  The
    analytic camera is axis-aligned and the velocity-tracking quad carries
    no attitude, so omega=0."""
    from ..sim.batched import pad_fields
    from ..sim.render import render_rgbd_flow

    dev = resolve_device(device)
    H, W = traj["ims"].shape[1:]
    centers, radii = pad_fields([field], K_min=obstacle_pad, device=dev)
    centers, radii = centers[0], radii[0]
    meta = torch.as_tensor(np.asarray(traj["data"], np.float32), device=dev)
    omega = torch.zeros(3, device=dev)
    flows = [render_rgbd_flow(meta[t, 7:10], meta[t, 10:13], omega, centers, radii, H=H, W=W,
                              is_trees=trees, device=dev)[2] for t in range(len(meta))]
    return torch.stack(flows).cpu().numpy().astype(np.float16)


def generate_trajectories(
    n_trials: int,
    batch: int,
    mode: str = "state",
    seed: int = 0,
    policy_every: int = 6,
    command_every: int = 3,
    desvel_range=(3.0, 5.0),
    num_obstacles_range=(25, 41),
    obstacle_pad: int = 48,
    min_frames: int = 30,
    trees: bool = True,
    record_flow: bool = False,
    device=None,
):
    """Fly ``n_trials`` expert trials in batches of ``batch`` on ``device``
    (CUDA unless the caller names another) -> the trajectory dicts of the
    trials past ``min_frames`` frames."""
    from ..sim import generate_forest, rollout_to_trajectory
    from ..sim.batched import run_trials_batched

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    trajs = []
    n_done = 0
    while n_done < n_trials:
        G = min(batch, n_trials - n_done)
        fields = [
            generate_forest(
                rng, num_obstacles=int(rng.integers(*num_obstacles_range)), trees=trees
            )
            for _ in range(G)
        ]
        desvels = rng.uniform(*desvel_range, size=G)
        t0 = time.time()
        results = run_trials_batched(
            fields, mode=mode, desired_vels=desvels, policy_every=policy_every,
            command_every=command_every, max_steps=7000,
            seed=seed + 131 * n_done, obstacle_pad=obstacle_pad, device=dev,
        )
        dt = time.time() - t0
        n_ok = 0
        for i, res in enumerate(results):
            s = res["summary"]
            ok = s.get("Success", False)
            n_ok += int(bool(ok))
            if len(res["depths"]) > min_frames:
                traj = rollout_to_trajectory(res, f"rollout_{mode}_{n_done + i:04d}")
                if record_flow:
                    traj["flows"] = traj_flows(traj, fields[i], obstacle_pad, trees, dev)
                trajs.append(traj)
        print(
            f"[DATAGEN] batch of {G} in {dt:.1f}s ({dt/G:.1f}s/trial): "
            f"{n_ok}/{G} success, kept {len(trajs)} total",
            flush=True,
        )
        n_done += G
    return trajs


def generate(out_h5: str, n_trials: int, batch: int, **kwargs):
    """``generate_trajectories`` written to ``out_h5`` (needs h5py)."""
    from ..data.dataloading import write_h5_dataset

    require_h5py("datagen")
    t_start = time.time()
    trajs = generate_trajectories(n_trials, batch, **kwargs)
    os.makedirs(os.path.dirname(out_h5), exist_ok=True)
    write_h5_dataset(out_h5, trajs)
    n_frames = sum(len(t["ims"]) for t in trajs)
    print(
        f"[DATAGEN] wrote {len(trajs)} trajectories / {n_frames} frames to {out_h5} "
        f"in {(time.time() - t_start)/60:.1f} min",
        flush=True,
    )
    return out_h5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--name", type=str, default="simgen_forest_big")
    ap.add_argument("--trials", type=int, default=120)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--mode", type=str, default="state", choices=["state", "planner"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy-every", type=int, default=6)
    ap.add_argument(
        "--record-flow", action="store_true",
        help="store per-frame exact optical flow (f16) in the h5 for "
        "flow-upsampled event generation (to_events --scheme esim_flow); "
        "roughly doubles the dataset size",
    )
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    out_h5 = opj(args.out, "data/datasets", f"{args.name}.h5")
    return generate(
        out_h5, args.trials, args.batch, mode=args.mode, seed=args.seed,
        policy_every=args.policy_every, record_flow=args.record_flow,
        device=resolve_device(args.device),
    )


if __name__ == "__main__":
    main()
