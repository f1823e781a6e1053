"""Chunk-DP training quality against the sequential path, on the port.

Port of ``tools/dp_quality.py``.  Chunk-level data parallelism
(``parallel/data_parallel``) takes ONE Adam step per G chunks with their
gradients averaged, where the reference (and the Learner's sequential
loop) steps Adam per chunk; fewer, larger steps per epoch can change what
training reaches.  This tool trains the flagship joint OrigUNet+ViTLSTM
(tools/train_policy.py's joint configuration at 260x346) twice from the
same init and seed, sequential (``dp_devices = 0``) and chunk-DP
(``dp_devices = 1, dp_chunks_per_device = 8``: G = 8 chunks in one forward
on one card), and tabulates each epoch's ``ep_loss`` and ``val_loss`` into
a JSON.

Data: by default simulated expert trajectories (``tools/datagen.
generate_trajectories`` in state mode, in memory), the first ``--trajs`` of
them cut to their first ``--frames`` frames, handed to the dataloader's
cache (``data.dataloading.cache_dataset``: no h5 file, no h5py).  ``--h5``
takes an h5 dataset instead (the JAX tool's planner dataset, where h5py
exists), subset the same way.  Both arms read the one cache.

  python -m evfly_tpu_torch.tools.dp_quality [--trajs 6] [--frames 40] [--epochs 5]
      [--h5 FILE] [--out-json OUT] [--device cpu]

Precision: ``set_precision("tf32")`` where the JAX tool sets "default".
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from os.path import join as opj

import numpy as np

from ..device import resolve_device
from ..precision import set_precision
from .train_policy import OUT, PRECISION

DATASET = "dpq_subset"
# the chunk-DP arm's G (``dp_chunks_per_device``), as the JAX tool's arm
CHUNKS = 8
# the simulated expert trajectories' seed
SEED = 0


def subset(trajs, n_traj: int, n_frames: int):
    """The first ``n_traj`` trajectories, each cut to its first
    ``n_frames`` frames (its event frames to n_frames - 1)."""
    out = []
    for t in trajs[:n_traj]:
        T = min(n_frames, len(t["depths"]))
        cut = {k: np.asarray(t[k][:T]) for k in ("data", "ims", "depths", "desvel")}
        cut["evs"] = np.asarray(t["evs"][: T - 1])
        out.append({"name": t["name"], **cut})
    return out


def h5_trajectories(path: str):
    """The trajectories of an h5 dataset (``write_h5_dataset``'s layout),
    in key order; needs h5py."""
    import h5py

    with h5py.File(path, "r") as f:
        return [{"name": name, **{k: np.asarray(f[name][k])
                                  for k in ("data", "ims", "depths", "desvel", "evs")}}
                for name in sorted(f.keys())]


def arm_config(work: str, dp_devices: int, epochs: int, batch_size: int, resize, tag: str):
    """The JAX tool's configuration of one arm."""
    from ..configs import EvflyConfig

    return EvflyConfig(
        basedir=work, logdir=f"logs_{tag}", datadir=opj(work, "data", "datasets"),
        dataset=[DATASET], use_h5=True, events="evs_frames", keep_collisions=True,
        val_split=0.25, seed=11, batch_size=batch_size,
        model_type=["OrigUNet", "VITFLY_ViTLSTM"], velpred=0, num_in_channels=2,
        num_out_channels=1, bev=2, num_recurrent=[1, 0], skip_type="interp",
        resize_input=list(resize), rescale_depth=1.0, rescale_evs=-1.0, evs_min_cutoff=0.0,
        data_augmentation=0.0,  # no draws: the arms differ in the optimizer alone
        loss_weights=[10.0, 1.0], optional_loss_param=[5.0, -1.0], lr=1e-4,
        lr_warmup_epochs=1, N_eps=epochs, save_model_freq=epochs + 1, val_freq=1,
        print_trainprogress_freq=1, dp_devices=dp_devices, dp_chunks_per_device=CHUNKS,
    )


def run_arm(cfg, device) -> tuple:
    """train_loop of one arm -> (ep_loss per epoch, val_loss per
    validation)."""
    from ..train.learner import Learner

    learner = Learner(cfg, device=device)
    ep_losses, val_losses = [], []
    log = learner.mylogger

    def capture(msg):
        log(msg)
        if "ep_loss = " in msg:
            ep_losses.append(float(msg.split("ep_loss = ")[1].split(",")[0]))
        # the epoch's line, not "New lowest val_loss = X at ep N/M"
        if msg.startswith("[VAL] Validated"):
            val_losses.append(float(msg.split("val_loss = ")[1].split(",")[0]))

    learner.mylogger = capture
    learner.train_loop()
    learner.logfile.close()
    return ep_losses, val_losses


def run_ab(trajs, work: str, epochs: int, batch_size: int = 16, resize=(260, 346),
           device=None, out_json=None, source: str = "") -> dict:
    """Both arms on ``trajs`` (cached once under ``work``) -> the report,
    also written to ``out_json`` when given."""
    from ..data.dataloading import cache_dataset
    from ..train.learner import dataloader_kwargs

    dev = resolve_device(device)
    work = os.path.abspath(work)  # the Learner joins a relative datadir to basedir
    shutil.rmtree(work, ignore_errors=True)
    seq_cfg = arm_config(work, 0, epochs, batch_size, resize, "seq")
    cache_dataset(opj(seq_cfg.datadir, DATASET), trajs, logger=print,
                  **dataloader_kwargs(seq_cfg))
    seq_ep, seq_val = run_arm(seq_cfg, dev)
    dp_ep, dp_val = run_arm(arm_config(work, 1, epochs, batch_size, resize, "dp8"), dev)
    report = {
        "dataset": source,
        "subset": {"trajs": len(trajs), "frames": max(len(t["depths"]) for t in trajs)},
        "epochs": epochs,
        "sequential": {"ep_loss": seq_ep, "val_loss": seq_val},
        "dp8_chunk": {"ep_loss": dp_ep, "val_loss": dp_val},
        "final_val_ratio_dp_over_seq": (dp_val[-1] / seq_val[-1] if seq_val and dp_val
                                        else None),
    }
    print(json.dumps(report, indent=2))
    if out_json:
        os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
        with open(out_json, "w") as fh:
            json.dump(report, fh, indent=2)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--h5", default=None, help="an h5 dataset in place of simulated trials")
    ap.add_argument("--trajs", type=int, default=6)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--tmp", default=opj(OUT, "dpq"))
    ap.add_argument("--out-json", default=opj(OUT, "dp_quality.json"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    set_precision(PRECISION)
    if args.h5:
        trajs, source = h5_trajectories(args.h5), args.h5
    else:
        from .datagen import generate_trajectories

        trajs = generate_trajectories(args.trajs, args.trajs, mode="state", seed=SEED,
                                      min_frames=args.frames, device=dev)
        source = f"simulated expert trajectories (datagen, state mode, seed {SEED})"
    return run_ab(subset(trajs, args.trajs, args.frames), args.tmp, args.epochs, device=dev,
                  out_json=args.out_json, source=source)


if __name__ == "__main__":
    main()
