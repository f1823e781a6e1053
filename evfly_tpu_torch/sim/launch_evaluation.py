"""N-trial evaluation runner: launch_evaluation.bash parity, in-process.

Port of ``evfly_tpu/sim/launch_evaluation.py``.  The reference drives N
sequential sim trials from bash: per-trial reset, evaluator + pilot nodes,
a 300 s watchdog that kills and relaunches the sim, and concatenation of
per-trial ``summary.yaml`` into ``evaluation.yaml``
(launch_evaluation.bash:43-151).  Here a trial is a function call, the
watchdog is a wall-clock bound around it, and "relaunch" is
re-instantiating the in-process state.

Per-trial artifacts mirror evaluation_node.py:176-244: ``path.csv``
(t,x,y,z), ``dist.csv`` (t, margin), ``static_obstacles.csv``, XYZ /
nearest-distance plots (with matplotlib, where it is installed), and a
``scalarMetrics.dat`` line (time, crashes); then ``evaluation.yaml`` (or
``evaluation.json`` without PyYAML).

Usage:
  python -m evfly_tpu_torch.sim.launch_evaluation --trials 3 --mode state
  python -m evfly_tpu_torch.sim.launch_evaluation --mode vision --device cuda
The vision mode flies the joint model of ``--checkpoint``
(``artifacts/policy_best.pth``) through a ``StreamingPipeline``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from os.path import join as opj
from typing import Callable, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from .closed_loop import run_trial
from .evaluator import TrialEvaluator
from .obstacles import generate_forest, save_obstacle_csv

# the trained joint model's configuration (tools/train_policy.py:238-241),
# which artifacts/policy_best.pth holds
POLICY_CONFIG = dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
                     input_shape=[1, 1, 260, 346], velpred=0, form_BEV=2,
                     evs_min_cutoff=0.0, skip_type="interp")
POLICY_CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "artifacts", "policy_best.pth")


def run_evaluation(
    n_trials: int,
    mode: str = "state",
    desired_vel: float = 4.0,
    policy_factory: Optional[Callable[[], object]] = None,
    out_dir: str = "evaluation_out",
    seed: int = 0,
    num_obstacles: int = 40,
    trees: bool = True,
    watchdog_s: float = 300.0,
    max_steps: int = 12000,
    make_plots: bool = True,
    device: DeviceLike = None,
) -> dict:
    """Run ``n_trials`` trials of ``run_trial`` on ``device`` (CUDA unless
    the caller names another), each in a new forest, and write the
    per-trial files and the summary under ``out_dir``."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    all_summaries = {}

    for trial in range(n_trials):
        trial_name = f"rollout_{trial:03d}"
        trial_dir = opj(out_dir, trial_name)
        os.makedirs(trial_dir, exist_ok=True)

        field = generate_forest(rng, num_obstacles=num_obstacles, trees=trees)
        save_obstacle_csv(opj(trial_dir, "static_obstacles.csv"), field)

        policy = policy_factory() if policy_factory is not None else None
        ev = TrialEvaluator()
        st = time.time()
        result = run_trial(
            field, mode=mode, desired_vel=desired_vel, policy=policy,
            evaluator=ev, max_steps=max_steps, log_images=False, device=dev,
        )
        wall = time.time() - st
        summary = result["summary"]
        if wall > watchdog_s:
            summary = {"Success": False, "watchdog_timeout_s": wall}
        all_summaries[trial_name] = summary

        # stored_metrics parity (evaluation_node.py:176-244)
        pos = np.array(ev.pos_log) if ev.pos_log else np.zeros((0, 4))
        np.savetxt(opj(trial_dir, "path.csv"), pos, delimiter=",", header="t,x,y,z")
        margins = np.array(ev.margin_log) if ev.margin_log else np.zeros((0, 2))
        np.savetxt(opj(trial_dir, "dist.csv"), margins, delimiter=",", header="t,margin")
        with open(opj(trial_dir, "scalarMetrics.dat"), "a") as f:
            ttf = summary.get("time_to_finish", -1.0)
            f.write(f"{ttf}, {summary.get('number_crashes', -1)}, {trial_name}\n")
        if make_plots and len(pos):
            _save_plots(trial_dir, pos, margins)

        print(f"[LAUNCH_EVALUATION] {trial_name}: {summary}")

    # evaluation.yaml concatenation (launch_evaluation.bash:149-151)
    eval_path = opj(out_dir, "evaluation.yaml")
    try:
        import yaml

        with open(eval_path, "w") as f:
            yaml.safe_dump(all_summaries, f)
    except ImportError:
        eval_path = opj(out_dir, "evaluation.json")
        with open(eval_path, "w") as f:
            json.dump(all_summaries, f, indent=2)

    n_success = sum(1 for s in all_summaries.values() if s.get("Success"))
    print(f"[LAUNCH_EVALUATION] {n_success}/{n_trials} successful trials -> {eval_path}")
    return all_summaries


def _save_plots(trial_dir: str, pos: np.ndarray, margins: np.ndarray):
    try:
        import matplotlib
    except ImportError:
        print(f"[LAUNCH_EVALUATION] matplotlib is not installed: no plots in {trial_dir}")
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(3, 1, figsize=(8, 8), sharex=True)
    for i, lbl in enumerate("XYZ"):
        axs[i].plot(pos[:, 0], pos[:, 1 + i])
        axs[i].set_ylabel(lbl)
    axs[-1].set_xlabel("t [s]")
    fig.savefig(opj(trial_dir, "XYZ Plots.png"))
    plt.close(fig)
    if len(margins):
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(margins[:, 0], margins[:, 1])
        ax.axhline(0.0, color="r", ls="--")
        ax.set_xlabel("t [s]")
        ax.set_ylabel("nearest margin [m]")
        fig.savefig(opj(trial_dir, "nearestDist.png"))
        plt.close(fig)


def policy_factory_from_checkpoint(path: str, desired_vel: float, device: DeviceLike = None):
    """A factory of ``StreamingPipeline``s (one per trial, each with its own
    state and CUDA graphs) around one joint model loaded from ``path``."""
    from ..models.composites import OrigUNet_w_VITFLY_ViTLSTM
    from ..models.port import load_state_dict
    from ..stream import StreamingPipeline

    dev = resolve_device(device)
    model = OrigUNet_w_VITFLY_ViTLSTM(device=dev, **POLICY_CONFIG).eval()
    model.load_params(load_state_dict(path))
    return lambda: StreamingPipeline(model, desvel=desired_vel, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--mode", type=str, default="state", choices=["state", "vision"])
    ap.add_argument("--desired_vel", type=float, default=4.0)
    ap.add_argument("--out_dir", type=str, default="evaluation_out")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_obstacles", type=int, default=40)
    ap.add_argument("--max_steps", type=int, default=12000)
    ap.add_argument("--checkpoint", type=str, default=POLICY_CHECKPOINT,
                    help="the joint model the vision mode flies")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    factory = None
    if args.mode == "vision":
        factory = policy_factory_from_checkpoint(args.checkpoint, args.desired_vel, dev)
    return run_evaluation(
        args.trials, mode=args.mode, desired_vel=args.desired_vel, policy_factory=factory,
        out_dir=args.out_dir, seed=args.seed, num_obstacles=args.num_obstacles,
        max_steps=args.max_steps, device=dev,
    )


if __name__ == "__main__":
    main()
