"""Rates of the port's serving, fused-rung and streaming paths on a CUDA
card, through the entry points a user calls, for comparing two checkouts
in turns on one card.

    python3 tools/path_rates.py [--repo DIR]

Imports ``evfly_tpu_torch`` from DIR (by default the checkout holding this
file) and reads its checkpoints from DIR/artifacts, so the same script
times the package of another commit unpacked beside it.  At full f32 (TF32
off), inputs from fixed numpy seeds:

- serving: 256 windows x 5,000 events -> ``event_histogram_scaled_resized``
  (K3) -> ``LSTMNetVIT`` (``pretrain_v_final.pth``) -> velocity, windows/s;
- fused rung (``bench.py:119-127``): the same windows ->
  ``event_histogram_scaled`` (K2) -> ``interpolate_bilinear`` to 60x90 ->
  ``LSTMNetVIT``, windows/s;
- streaming: ``StreamingPipeline.step_events`` with the joint model
  (``policy_best.pth``), one window of 5,000 events a step (one CUDA graph
  replayed per step, the pipeline's default), ms per step over 100
  chained steps.

Each rate is the median of 5 reps of 10 steps after 3 warm-up steps (host
clock around work that ends in a synchronize).  Prints the card's name and
power limit and one JSON line.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W, H_OUT, W_OUT = 260, 346, 60, 90
N_WINDOWS, N_EVENTS, CHAINED_STEPS = 256, 5000, 100
# the trained joint model's configuration (tools/train_policy.py:238-241)
JOINT_CONFIG = dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
                    input_shape=[1, 1, 260, 346], velpred=0, form_BEV=2,
                    evs_min_cutoff=0.0, skip_type="interp")


def events(seed, B, N, dev):
    rng = np.random.default_rng(seed)
    ex = torch.tensor(rng.uniform(0, W, (B, N)), dtype=torch.float32, device=dev)
    ey = torch.tensor(rng.uniform(0, H, (B, N)), dtype=torch.float32, device=dev)
    ep = torch.tensor(rng.choice([-1, 1], (B, N)), dtype=torch.int32, device=dev)
    return ex, ey, ep


def windows_per_s(step) -> float:
    for _ in range(3):
        step()
    reps = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        reps.append(10 * N_WINDOWS / (time.perf_counter() - t0))
    return statistics.median(reps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_rates: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
    from evfly_tpu_torch.models.port import load_state_dict
    from evfly_tpu_torch.models.recurrent import set_fused_lstm
    from evfly_tpu_torch.models.vitfly import LSTMNetVIT
    from evfly_tpu_torch.ops.imageops import interpolate_bilinear
    from evfly_tpu_torch.ops.voxelizer import (event_histogram_scaled,
                                               event_histogram_scaled_resized)
    from evfly_tpu_torch.stream import StreamingPipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    artifacts = os.path.join(repo, "artifacts")
    vit = LSTMNetVIT(device=dev).eval().load_params(
        load_state_dict(os.path.join(artifacts, "pretrain_v_final.pth")))
    joint = OrigUNet_w_VITFLY_ViTLSTM(device=dev, **JOINT_CONFIG).eval().load_params(
        load_state_dict(os.path.join(artifacts, "policy_best.pth")))
    ex, ey, ep = events(2, N_WINDOWS, N_EVENTS, dev)
    desvel = torch.full((N_WINDOWS, 1), 4.0, device=dev)

    def serving():
        small = event_histogram_scaled_resized(ex, ey, ep, H, W, H_OUT, W_OUT, device=dev)
        return vit(small[:, None], desvel)

    def fused_rung():
        frames = event_histogram_scaled(ex, ey, ep, H, W, device=dev)
        return vit(interpolate_bilinear(frames[:, None], (H_OUT, W_OUT)), desvel)

    sx, sy, sp = events(3, 8, N_EVENTS, dev)
    pipe = StreamingPipeline(joint, fast_percentile=True, device=dev)
    with torch.inference_mode():
        set_fused_lstm(True)
        rates = {"serving_windows_per_s": windows_per_s(serving),
                 "fused_rung_windows_per_s": windows_per_s(fused_rung)}
        for i in range(3):
            pipe.step_events(sx[i], sy[i], sp[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(CHAINED_STEPS):
            pipe.step_events(sx[i % 8], sy[i % 8], sp[i % 8])
        torch.cuda.synchronize()
        rates["streaming_ms_per_step"] = (time.perf_counter() - t0) / CHAINED_STEPS * 1e3
    print(f"card: {smi}; package: {repo}")
    print(json.dumps(rates))
    return 0


if __name__ == "__main__":
    sys.exit(main())
