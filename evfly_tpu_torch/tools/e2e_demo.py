"""End-to-end demo on one card: sim data → joint training → vision eval.

Port of ``tools/e2e_demo.py``: expert rollouts in the ROS-free sim make a
dataset with difflog event frames; the joint OrigUNet+ViTLSTM trains on it
through the Learner (two-term weighted loss, velocity + depth); the trained
checkpoint then flies vision-mode closed-loop trials through the streaming
pipeline, scored by the reference evaluation protocol.  Everything runs on
the CUDA device unless ``--device cpu``.

One difference from the JAX driver, with the same result: ``phase_data``
hands the trajectories to ``data.dataloading.cache_dataset`` (the
dataloader's preprocessing of the in-memory trajectories into its cache,
under the ``simgen_forest.h5.stat.json`` stamp) where the JAX driver writes
``simgen_forest.h5``; the Learner's dataloader then takes the cache hit,
so no h5py is needed.  Trials fly one ``run_trial`` at a time, as in the
JAX driver.  Precision: ``set_precision("tf32")`` where the JAX driver sets
"default" (before the Learner and before the evaluation's pipelines).

Phases are resumable (skipped when their artifact exists):
  python -m evfly_tpu_torch.tools.e2e_demo [--out DIR] [--trials N] [--epochs E] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from os.path import join as opj

import numpy as np

from ..device import resolve_device
from ..precision import set_precision
from .train_policy import OUT, PRECISION, load_policy

DATASET = "simgen_forest"


def train_config(out: str, epochs: int):
    """The JAX driver's joint training configuration."""
    from ..configs import EvflyConfig

    return EvflyConfig(
        basedir=out,
        logdir="logs",
        datadir=opj(out, "data/datasets"),
        dataset=[DATASET],
        use_h5=True,
        events="evs_frames",
        keep_collisions=True,
        val_split=0.2,
        seed=7,
        batch_size=32,
        model_type=["OrigUNet", "VITFLY_ViTLSTM"],
        velpred=0,
        num_in_channels=2,
        bev=2,
        num_out_channels=1,
        num_recurrent=[1, 0],
        skip_type="interp",
        resize_input=[260, 346],
        rescale_depth=1.0,
        rescale_evs=-1.0,
        evs_min_cutoff=0.0,
        data_augmentation=1.0,
        N_eps=epochs,
        lr=1e-4,
        lr_warmup_epochs=1,
        save_model_freq=max(epochs // 2, 1),
        val_freq=max(epochs // 4, 1),
        print_trainprogress_freq=1,
        loss_weights=[10.0, 1.0],
        optional_loss_param=[5.0, -1.0],
        enc_num_layers=2, enc_kernel_sizes=[5, 3], enc_kernel_strides=[2, 2],
        enc_out_channels=[8, 32], enc_activations=["relu", "relu"],
        enc_pool_type="max", enc_invert_pool_inputs=True,
        enc_pool_kernels=[2, 2], enc_pool_strides=[2, 2],
        fc_num_layers=4, fc_layer_sizes=[1024, 128, 16, 1],
        fc_activations=["leaky_relu", "leaky_relu", "leaky_relu", "tanh"],
        fc_dropout_p=0.1,
    )


def data_trajectories(n_trials: int, seed: int = 0, device=None):
    """The JAX driver's expert trials, one ``run_trial`` at a time -> the
    trajectory dicts of those past 30 frames."""
    from ..sim import generate_forest, rollout_to_trajectory, run_trial

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    trajs = []
    for i in range(n_trials):
        desvel = float(rng.uniform(3.0, 5.0))
        field = generate_forest(rng, num_obstacles=30, trees=True)
        st = time.time()
        res = run_trial(field, mode="state", desired_vel=desvel, max_steps=7000, device=dev)
        print(
            f"[DATA] trial {i}: {res['summary'].get('Success')} "
            f"{len(res['depths'])} frames desvel={desvel:.1f} ({time.time()-st:.0f}s)"
        )
        if len(res["depths"]) > 30:
            trajs.append(rollout_to_trajectory(res, f"rollout_{i:03d}"))
    return trajs


def phase_data(out: str, n_trials: int, seed: int = 0, device=None) -> str:
    """The trials through ``cache_dataset`` under
    ``out/data/datasets/simgen_forest``, with the training configuration's
    dataloader arguments; returns the stamp's path."""
    from ..data.dataloading import cache_dataset
    from ..train.learner import dataloader_kwargs

    data_dir = opj(out, "data/datasets", DATASET)
    stamp = data_dir + ".h5.stat.json"
    if os.path.exists(stamp):
        print(f"[DATA] {stamp} exists, skipping generation")
        return stamp
    trajs = data_trajectories(n_trials, seed, device)
    # the splits depend on the config's dataloader arguments, not on N_eps
    cache_dataset(data_dir, trajs, logger=print, **dataloader_kwargs(train_config(out, 1)))
    print(f"[DATA] cached {len(trajs)} trajectories for the dataloader at {data_dir}")
    return stamp


def phase_train(out: str, epochs: int, device=None) -> str:
    from ..train.learner import Learner

    done = glob.glob(opj(out, "logs/*/model_ep*.pth"))
    if done:
        best = sorted(glob.glob(opj(out, "logs/*/model_best_ep*.pth")))
        pick = best[-1] if best else sorted(done)[-1]
        print(f"[TRAIN] checkpoint exists: {pick}")
        return pick

    set_precision(PRECISION)
    learner = Learner(train_config(out, epochs), device=device)
    learner.train_loop()
    best = sorted(glob.glob(opj(learner.workspace, "model_best_ep*.pth")))
    pick = best[-1] if best else sorted(glob.glob(opj(learner.workspace, "model_ep*.pth")))[-1]
    print(f"[TRAIN] done -> {pick}")
    return pick


def phase_eval(out: str, checkpoint: str, n_trials: int, seed: int = 100, device=None) -> dict:
    from ..sim import generate_forest, run_trial
    from ..stream.pipeline import StreamingPipeline

    set_precision(PRECISION)
    dev = resolve_device(device)
    model = load_policy(checkpoint, dev)

    rng = np.random.default_rng(seed)
    summaries = {}
    for i in range(n_trials):
        desvel = 4.0
        pipe = StreamingPipeline(model, desvel=desvel, device=dev)
        field = generate_forest(rng, num_obstacles=30, trees=True)
        st = time.time()
        res = run_trial(
            field, mode="vision", policy=pipe, desired_vel=desvel,
            max_steps=7000, log_images=False, device=dev,
        )
        summaries[f"vision_{i:03d}"] = res["summary"]
        print(f"[EVAL] vision trial {i}: {res['summary']} ({time.time()-st:.0f}s)")

    with open(opj(out, "vision_eval.json"), "w") as f:
        json.dump(summaries, f, indent=2)
    return summaries


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default=opj(OUT, "e2e_demo"))
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--eval_trials", type=int, default=3)
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    t0 = time.time()
    times = {}
    phase_data(args.out, args.trials, device=dev)
    times["data_s"] = time.time() - t0
    ckpt = phase_train(args.out, args.epochs, device=dev)
    times["train_s"] = time.time() - t0 - times["data_s"]
    summaries = phase_eval(args.out, ckpt, args.eval_trials, device=dev)
    times["eval_s"] = time.time() - t0 - times["data_s"] - times["train_s"]
    n_ok = sum(1 for s in summaries.values() if s.get("Success"))
    print(
        f"[E2E] complete in {(time.time()-t0)/60:.1f} min "
        f"({', '.join(f'{k} {v:.1f}' for k, v in times.items())}); "
        f"vision success {n_ok}/{len(summaries)}"
    )
    return dict(checkpoint=ckpt, summaries=summaries, **times)


if __name__ == "__main__":
    main()
