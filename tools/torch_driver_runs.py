"""Full-scale runs of the port's drivers (evfly_tpu_torch/tools) on one GPU.

    python3 tools/torch_driver_runs.py [--out chiprun_out/driver_runs]
        [--parts dagger datagen e2e rl] [--rl-iters 600] [--rl-seeds 0 1]

- dagger: ``train_policy``'s dagger trials (40 in batches of 20, seed
  50000, ``policy_best.pth``) through ``dagger_trajectories`` and
  ``cache_dataset`` (no h5py): wall time, trials/min, frames;
- datagen: ``datagen.generate_trajectories`` in state mode, 24 trials in
  one batch of 24: trials/min, peak device memory;
- e2e: ``e2e_demo.main`` at its defaults (10 trials, 12 epochs, 3
  evaluation trials): each phase's wall time, the evaluation's outcome;
- rl: ``train_rl`` for each env and seed, all started together as
  processes (their wall times overlap: an outcome, not a rate), each
  writing its artifact.

Runs the parts in that order (rl last: its processes share the host),
writes ``summary.json`` and one JSON per RL run under ``--out``, and
prints the card's name and power limit.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "driver_runs"))
    ap.add_argument("--parts", nargs="*", default=["dagger", "datagen", "e2e", "rl"])
    ap.add_argument("--rl-iters", type=int, default=600)
    ap.add_argument("--rl-seeds", type=int, nargs="*", default=[0, 1])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_driver_runs: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    from evfly_tpu_torch.data.dataloading import cache_dataset
    from evfly_tpu_torch.tools import datagen, e2e_demo, train_policy
    from evfly_tpu_torch.train.learner import dataloader_kwargs

    dev = torch.device("cuda")
    smi = _smi()
    print(f"card: {smi}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    scratch = os.path.join(REPO, "build", f"driver_runs_{os.getpid()}")
    ckpt = os.path.join(REPO, "artifacts", "policy_best.pth")
    summary = {"card": smi}

    def save():
        with open(os.path.join(args.out, "summary.json"), "w") as fh:
            json.dump(summary, fh, indent=1, default=float)

    try:
        if "dagger" in args.parts:
            t0 = time.perf_counter()
            results = train_policy._protocol_trials(ckpt, 40, 20, 50000, mode="dagger",
                                                    device=dev)
            fly_s = time.perf_counter() - t0
            trajs = train_policy.dagger_trajectories(results)
            cfg = train_policy._joint_cfg(argparse.Namespace(extra_data=None, epochs=1, lr=None,
                                                             logsub="joint"))
            t1 = time.perf_counter()
            train, val, _ = cache_dataset(os.path.join(scratch, "dagger_r1"), trajs,
                                          logger=lambda m: None, **dataloader_kwargs(cfg))
            summary["dagger"] = dict(
                trials=40, fly_s=fly_s, trials_per_min=40 / fly_s * 60,
                trajectories=len(trajs), frames=int(sum(len(t["ims"]) for t in trajs)),
                cache_s=time.perf_counter() - t1, train_frames=int(train.ims.shape[0]),
                val_frames=int(val.ims.shape[0]),
                policy_crashes=[r["summary"].get("number_crashes", -1) for r in results])
            print(f"dagger: {json.dumps(summary['dagger'])}", flush=True)
            save()
            del results, trajs, train, val
        if "datagen" in args.parts:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            trajs = datagen.generate_trajectories(24, 24, mode="state", seed=0, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            summary["datagen"] = dict(
                trials=24, batch=24, wall_s=wall, trials_per_min=24 / wall * 60,
                peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
                trajectories=len(trajs), frames=int(sum(len(t["ims"]) for t in trajs)))
            print(f"datagen: {json.dumps(summary['datagen'])}", flush=True)
            save()
            del trajs
        if "e2e" in args.parts:
            torch.cuda.empty_cache()
            out = e2e_demo.main(["--out", os.path.join(scratch, "e2e"), "--device", "cuda"])
            summary["e2e"] = dict(
                data_s=out["data_s"], train_s=out["train_s"], eval_s=out["eval_s"],
                eval_success=int(sum(bool(s.get("Success")) for s in out["summaries"].values())),
                eval_trials=len(out["summaries"]), summaries=out["summaries"])
            print(f"e2e_demo: {json.dumps(summary['e2e'], default=float)}", flush=True)
            save()
        if "rl" in args.parts:
            procs = {}
            t0 = time.perf_counter()
            for env in ("vision", "quadrotor"):
                for seed in args.rl_seeds:
                    name = f"rl_{env}_seed{seed}"
                    procs[name] = subprocess.Popen(
                        [sys.executable, "-m", "evfly_tpu_torch.tools.train_rl", "--env", env,
                         "--iters", str(args.rl_iters), "--seed", str(seed), "--out-json",
                         os.path.join(args.out, f"{name}.json")],
                        cwd=REPO, stdout=open(os.path.join(args.out, f"{name}.log"), "w"),
                        stderr=subprocess.STDOUT)
            summary["rl"] = {}
            for name, proc in procs.items():
                rc = proc.wait()
                res = {}
                if rc == 0:
                    with open(os.path.join(args.out, f"{name}.json")) as fh:
                        res = json.load(fh)
                summary["rl"][name] = dict(rc=rc, **{k: v for k, v in res.items()
                                                     if k != "history"})
                print(f"{name}: {json.dumps(summary['rl'][name])}", flush=True)
            summary["rl_wall_s"] = time.perf_counter() - t0
            save()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps({k: v for k, v in summary.items() if k != "e2e"}, default=float),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
