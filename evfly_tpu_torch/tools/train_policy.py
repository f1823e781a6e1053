"""Policy-quality pipeline driver on the port: train, evaluate and aggregate
with DAgger.

Port of ``tools/train_policy.py``: the same subcommands, arguments,
configurations and reports, over the port's Learner, simulator and
streaming pipeline, on the CUDA device unless ``--device cpu``.

Phases (subcommands, each resumable/artifact-gated):
  pretrain_v  V(φ): ViTLSTM depth→velocity on GT depth through
              clip(2·depth, 0, 1) — the composite's hand-off distribution
              (learner_models.py:634).
  pretrain_d  D(θ): OrigUNet events→depth (loss on the depth term only).
  joint       combine D(θ)+V(φ) state dicts and fine-tune jointly.
  scratch     plain joint training from scratch (baseline for comparison).
  eval        batched vision-mode protocol evaluation on held-out forests.
  dagger      fly the current policy, label every visited state with the
              privileged expert, write an aggregation dataset (Ross et al.
              2011), ready for a fine-tune round.

Precision: where the JAX driver calls ``set_precision("default")`` (one
bf16 pass on a TPU: ``_train`` and ``_build_pipeline``), this one calls
``set_precision("tf32")`` at the same place, before the Learner or the
pipeline is built, so that a pipeline's CUDA graph is captured in TF32.

``dagger`` writes an h5 file through ``write_h5_dataset`` and needs
``h5py``; without it it raises ImportError before flying
(``dagger_trajectories`` returns the trajectories, which
``data.dataloading.cache_dataset`` takes without h5py).  ``OUT`` and
``DATASETS`` are read from ``EVFLY_OUT`` and ``EVFLY_DATASETS`` at import;
``OUT`` defaults to ``.data/evfly_torch`` in the repo (git-ignored).

Typical sequence:
  python -m evfly_tpu_torch.tools.train_policy pretrain_v && ... pretrain_d && ... joint
  python -m evfly_tpu_torch.tools.train_policy eval --ckpt <best>
  python -m evfly_tpu_torch.tools.train_policy dagger --ckpt <best> && \\
      ... joint --extra-data dagger_r1 --resume <best>
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

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.environ.get("EVFLY_OUT", opj(REPO, ".data", "evfly_torch"))
DATASETS = os.environ.get("EVFLY_DATASETS", "simgen_forest_big,simgen_forest_planner").split(",")
# the precision of the JAX driver's set_precision("default") on the card
PRECISION = "tf32"

ENC = {
    "num_layers": 2, "kernel_sizes": [5, 3], "kernel_strides": [2, 2],
    "out_channels": [8, 32], "activations": ["relu", "relu"],
    "pool_type": "max", "invert_pool_inputs": True,
    "pool_kernels": [2, 2], "pool_strides": [2, 2], "conv_function": "conv2d",
}
FC = {
    "num_layers": 4, "layer_sizes": [1024, 128, 16, 1],
    "activations": ["leaky_relu", "leaky_relu", "leaky_relu", "tanh"],
    "dropout_p": 0.1,
}
# the trained joint model (artifacts/policy_best.pth)
POLICY_CONFIG = dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
                     enc_params=ENC, fc_params=FC, input_shape=[1, 1, 260, 346],
                     velpred=0, form_BEV=2, evs_min_cutoff=0.0, skip_type="interp")


def _cfg(out, logsub, datasets, **over):
    from ..configs import EvflyConfig

    kw = dict(
        basedir=out,
        logdir=opj("logs", logsub),
        datadir=opj(out, "data/datasets"),
        dataset=datasets,
        use_h5=True,
        events="evs_frames",
        keep_collisions=False,      # drop expert-crash trajectories (reference default)
        val_split=0.15,
        seed=7,
        batch_size=32,
        num_recurrent=[1, 0],
        skip_type="interp",
        resize_input=[260, 346],
        rescale_depth=1.0,
        rescale_evs=-1.0,
        evs_min_cutoff=0.0,
        data_augmentation=1.0,
        device_data_quantized=True,
        traj_scan=True,
        lr=1e-4,
        lr_warmup_epochs=1,
        print_trainprogress_freq=1,
        enc_num_layers=2, enc_kernel_sizes=[5, 3], enc_kernel_strides=[2, 2],
        enc_out_channels=[8, 32], enc_activations=["relu", "relu"],
        enc_pool_type="max", enc_invert_pool_inputs=True,
        enc_pool_kernels=[2, 2], enc_pool_strides=[2, 2],
        fc_num_layers=4, fc_layer_sizes=[1024, 128, 16, 1],
        fc_activations=["leaky_relu", "leaky_relu", "leaky_relu", "tanh"],
        fc_dropout_p=0.1,
    )
    kw.update(over)
    return EvflyConfig(**kw)


def _lr_over(args):
    """--lr override (lr 1e-4 leaves the velocity head at the
    constant-output floor for the whole compute budget)."""
    return {"lr": args.lr} if getattr(args, "lr", None) else {}


def _train(cfg, device=None):
    """Learner(cfg).train_loop() in TF32 on ``device``; the best
    checkpoint (the last epoch's without one)."""
    from ..train.learner import Learner

    set_precision(PRECISION)
    learner = Learner(cfg, device=device)
    learner.train_loop()
    best = sorted(glob.glob(opj(learner.workspace, "model_best_ep*.pth")))
    picks = best or sorted(glob.glob(opj(learner.workspace, "model_ep*.pth")))
    print(f"[TRAIN_POLICY] workspace {learner.workspace} -> {picks[-1]}")
    return picks[-1]


def cmd_pretrain_v(args):
    over = {}
    if getattr(args, "init", None):
        over = dict(checkpoint_path=[_as_epoch0(args.init, "v")], load_trainval=False)
    cfg = _cfg(
        OUT, "pretrain_v", DATASETS,
        model_type=["VITFLY_ViTLSTM"],
        epoch_scan=True,
        scan_group=16,
        num_in_channels=1,           # depth input
        num_out_channels=1,
        input_frame_scale=2.0,       # composite hand-off distribution
        loss_weights=[1.0, 0.0],
        optional_loss_param=[5.0, 0.0],
        N_eps=args.epochs,
        save_model_freq=max(args.epochs // 2, 1),
        val_freq=1,
        **_lr_over(args),
        **over,
    )
    return _train(cfg, args.device)


def cmd_pretrain_d(args):
    over = {}
    if getattr(args, "init", None):
        over = dict(checkpoint_path=[_as_epoch0(args.init, "d")], load_trainval=False)
    cfg = _cfg(
        OUT, "pretrain_d", DATASETS,
        model_type=["OrigUNet"],
        batch_size=16,               # chunks of 16, as the JAX driver
        epoch_scan=True,
        scan_group=16,
        velpred=0,
        **over,
        num_in_channels=2,           # event input
        num_out_channels=1,
        bev=2,
        loss_weights=[0.0, 1.0],
        optional_loss_param=[0.0, -1.0],
        N_eps=args.epochs,
        save_model_freq=max(args.epochs // 2, 1),
        val_freq=1,
        **_lr_over(args),
    )
    return _train(cfg, args.device)


def _joint_cfg(args, **over):
    datasets = DATASETS + (args.extra_data or [])
    kw = dict(
        model_type=["OrigUNet", "VITFLY_ViTLSTM"],
        batch_size=16,
        epoch_scan=True,
        scan_group=16,
        velpred=0,
        num_in_channels=2,
        num_out_channels=1,
        bev=2,
        loss_weights=[10.0, 1.0],
        optional_loss_param=[5.0, -1.0],
        N_eps=args.epochs,
        save_model_freq=max(args.epochs // 2, 1),
        val_freq=1,
    )
    kw.update(_lr_over(args))
    kw.update(over)
    return _cfg(OUT, args.logsub, datasets, **kw)


def _as_epoch0(ckpt, tag):
    """Copy a checkpoint to an epoch-000000 name so the joint run starts its
    own epoch/LR accounting instead of inheriting the pretrain epoch parsed
    from the filename (port.parse_epoch_from_path)."""
    import shutil

    os.makedirs(OUT, exist_ok=True)
    dst = opj(OUT, f"combine_{tag}_model_ep000000.pth")
    shutil.copyfile(ckpt, dst)
    return dst


def cmd_joint(args):
    over = {}
    if args.resume:
        # restore the checkpoint's own train/val split (no val leakage)
        over = dict(checkpoint_path=[args.resume], load_trainval=True)
    elif args.d_ckpt and args.v_ckpt:
        over = dict(
            checkpoint_path=[_as_epoch0(args.d_ckpt, "d"), _as_epoch0(args.v_ckpt, "v")],
            combine_checkpoints=True,
            load_trainval=False,
        )
    return _train(_joint_cfg(args, **over), args.device)


def cmd_scratch(args):
    return _train(_joint_cfg(args), args.device)


def load_policy(ckpt, device=None):
    """The joint model of ``ckpt`` on ``device``, in eval mode."""
    from ..models.composites import OrigUNet_w_VITFLY_ViTLSTM
    from ..models.port import load_state_dict

    model = OrigUNet_w_VITFLY_ViTLSTM(device=resolve_device(device), **POLICY_CONFIG).eval()
    return model.load_params(load_state_dict(ckpt))


def _build_pipeline(ckpt, num_streams, desvels, device=None):
    from ..stream.pipeline import BatchedStreamingPipeline

    set_precision(PRECISION)
    dev = resolve_device(device)
    return BatchedStreamingPipeline(load_policy(ckpt, dev), num_streams=num_streams,
                                    desvel=desvels, device=dev)


def _protocol_trials(ckpt, n_trials, batch, seed, mode="vision", desvel=4.0,
                     dynamics="first_order", device=None):
    from ..sim import generate_forest
    from ..sim.batched import run_trials_batched

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    all_results = []
    n_done = 0
    while n_done < n_trials:
        G = min(batch, n_trials - n_done)
        fields = [
            generate_forest(rng, num_obstacles=int(rng.integers(25, 41)), trees=True)
            for _ in range(G)
        ]
        desvels = np.full(G, desvel)
        pipe = _build_pipeline(ckpt, G, desvels, dev)
        t0 = time.time()
        results = run_trials_batched(
            fields, mode=mode, desired_vels=desvels, policy=pipe,
            policy_every=6, max_steps=7000, seed=seed + n_done,
            obstacle_pad=48, log_images=(mode == "dagger"),
            dynamics=dynamics, device=dev,
        )
        print(f"[TRAIN_POLICY] {mode} batch of {G} in {time.time()-t0:.0f}s", flush=True)
        all_results.extend(results)
        n_done += G
    return all_results


def eval_report(results, ckpt, desvel, dynamics):
    """The protocol report of ``cmd_eval`` over run_trials_batched results."""
    summaries = [r["summary"] for r in results]
    n_success = sum(1 for s in summaries if s.get("Success"))
    n_finish = sum(1 for s in summaries if "time_to_finish" in s)
    crashes = [s.get("number_crashes", -1) for s in summaries]
    # dodge diagnostic: in vision mode the logged velcmd columns (13:16 of
    # the 21-col reference data.csv layout) hold the EXECUTED policy
    # command — lateral magnitude is the "does it dodge" signal
    vy = [np.abs(r["log"][:, 14]) for r in results if len(r["log"])]
    return {
        "ckpt": ckpt,
        "desvel": desvel,
        "dynamics": dynamics,
        "mean_abs_vy_cmd": float(np.mean([v.mean() for v in vy])) if vy else None,
        "p95_abs_vy_cmd": float(np.mean([np.percentile(v, 95) for v in vy])) if vy else None,
        "trials": len(summaries),
        "success_rate": n_success / len(summaries),
        "finish_rate": n_finish / len(summaries),
        "crashes": crashes,
        "mean_crashes": float(np.mean([c for c in crashes if c >= 0])) if n_finish else -1,
        "time_to_finish": [s.get("time_to_finish") for s in summaries],
        "summaries": summaries,
    }


def cmd_eval(args):
    results = _protocol_trials(
        args.ckpt, args.trials, args.batch, seed=args.seed,
        desvel=args.desvel, dynamics=args.dynamics, device=args.device,
    )
    report = eval_report(results, args.ckpt, args.desvel, args.dynamics)
    out_json = args.out_json or opj(OUT, f"eval_{int(time.time())}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: report[k] for k in
                      ("trials", "success_rate", "finish_rate", "mean_crashes",
                       "crashes", "mean_abs_vy_cmd", "p95_abs_vy_cmd")}))
    return report


def require_h5py(what: str):
    """h5py, or an ImportError that names what needed it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{what} writes an h5 dataset and needs h5py, which is not installed; "
            "the trajectories go to data.dataloading.cache_dataset without it") from e
    return h5py


def dagger_trajectories(results):
    """The DAgger trajectories of dagger-mode results: every trial past 30
    frames, its is_collide column cleared."""
    from ..sim import rollout_to_trajectory

    trajs = []
    for i, res in enumerate(results):
        if len(res["depths"]) > 30:
            traj = rollout_to_trajectory(res, f"dagger_{i:04d}")
            # Crashes here happened under the POLICY's actions; the logged
            # labels are the privileged expert's per-state commands, which
            # stay valid supervision.  The dataloader's keep_collisions=False
            # filter (reference semantics: drop bad EXPERT demonstrations)
            # would otherwise discard exactly the covariate-shift states
            # DAgger exists to capture — so clear the is_collide column.
            traj["data"][:, -1] = 0.0
            trajs.append(traj)
    return trajs


def cmd_dagger(args):
    from ..data.dataloading import write_h5_dataset

    require_h5py("dagger")
    results = _protocol_trials(
        args.ckpt, args.trials, args.batch, seed=args.seed, mode="dagger",
        dynamics=args.dynamics, device=args.device,
    )
    trajs = dagger_trajectories(results)
    h5 = opj(OUT, "data/datasets", f"{args.name}.h5")
    os.makedirs(os.path.dirname(h5), exist_ok=True)
    write_h5_dataset(h5, trajs)
    crashes = [r["summary"].get("number_crashes", -1) for r in results]
    print(f"[TRAIN_POLICY] dagger: wrote {len(trajs)} trajs to {h5}; "
          f"policy crashes per trial: {crashes}")
    return h5


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    for name in ("pretrain_v", "pretrain_d"):
        p = sub.add_parser(name)
        p.add_argument("--epochs", type=int, default=10)
        p.add_argument("--init", type=str, default=None,
                       help="warm-start checkpoint (copied to an ep000000 name)")
        p.add_argument("--lr", type=float, default=None)
    for name in ("joint", "scratch"):
        p = sub.add_parser(name)
        p.add_argument("--epochs", type=int, default=20)
        p.add_argument("--logsub", type=str, default=name)
        p.add_argument("--extra-data", nargs="*", default=None)
        p.add_argument("--resume", type=str, default=None)
        p.add_argument("--d-ckpt", type=str, default=None)
        p.add_argument("--v-ckpt", type=str, default=None)
        p.add_argument("--lr", type=float, default=None)
    p = sub.add_parser("eval")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--batch", type=int, default=20)
    p.add_argument("--seed", type=int, default=90000)
    p.add_argument("--out-json", type=str, default=None)
    p.add_argument("--desvel", type=float, default=4.0)
    p.add_argument("--dynamics", type=str, default="first_order",
                   choices=["first_order", "rigid"])
    p = sub.add_parser("dagger")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--trials", type=int, default=40)
    p.add_argument("--batch", type=int, default=20)
    p.add_argument("--seed", type=int, default=50000)
    p.add_argument("--name", type=str, default="dagger_r1")
    p.add_argument("--dynamics", type=str, default="first_order",
                   choices=["first_order", "rigid"])
    for p in sub.choices.values():
        p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")

    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    fn = {
        "pretrain_v": cmd_pretrain_v, "pretrain_d": cmd_pretrain_d,
        "joint": cmd_joint, "scratch": cmd_scratch,
        "eval": cmd_eval, "dagger": cmd_dagger,
    }[args.cmd]
    return fn(args)


if __name__ == "__main__":
    main()
