"""Latency of the port's streaming step on a CUDA card, replayed as CUDA
graphs and run eagerly, in turns: the port's counterpart of
``tools/latency_bench.py``.

    python3 tools/torch_latency_bench.py [--streams 16 64 128]

The joint model ``OrigUNet_w_VITFLY_ViTLSTM`` (the trained configuration,
weights drawn from seed 0, as the JAX tool draws them from PRNGKey(0)) at
260x346, full f32, the bisection percentile, one window of 5,000 random
events per step (on the device):

- ``chained_ms``: ms per ``StreamingPipeline.step_events`` over 100 chained
  steps and one synchronize (the rate a pipelining host reaches);
- ``p50_ms``: the median of 20 steps, each ending in a synchronize (what a
  host that waits for each command sees);
- ``steps_per_s`` at each number of streams G: streams stepped per second
  by ``BatchedStreamingPipeline.step_frames`` over 30 steps of sparse
  frames.

Each is measured with the graph (``graph=True``, the default) and eagerly
(``graph=False``) in turns: eager, graph, graph, eager.  Prints the card's
name and power limit, then one JSON line.  Exits 1 without a CUDA card.
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

H, W, N_EVENTS = 260, 346, 5000
CHAINED_STEPS, SYNC_STEPS, RATE_STEPS = 100, 20, 30
TURNS = (False, True, True, False)  # graph: eager, graph, graph, eager
# the trained joint model's configuration (tools/train_policy.py:238-241)
JOINT_CONFIG = dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
                    input_shape=[1, 1, 260, 346], velpred=0, form_BEV=2,
                    evs_min_cutoff=0.0, skip_type="interp")


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def step_ms(step, windows, chained: int = CHAINED_STEPS, sync: int = SYNC_STEPS):
    """(ms per step over ``chained`` chained steps, the ms of each of
    ``sync`` synchronized steps) of ``step(window)`` over ``windows`` in
    turn, after 3 warm-up steps."""
    for w in windows[:3]:
        step(w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(chained):
        step(windows[i % len(windows)])
    torch.cuda.synchronize()
    chained_ms = (time.perf_counter() - t0) / chained * 1e3
    samples = []
    for i in range(sync):
        t0 = time.perf_counter()
        step(windows[i % len(windows)])
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return chained_ms, samples


def streams_per_s(step, G: int, steps: int = RATE_STEPS) -> float:
    """Streams stepped per second by ``step()`` (one step of G streams)
    over ``steps`` steps, after 2 warm-up steps."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return G * steps / (time.perf_counter() - t0)


def sparse_frames(seed: int, shape, dev) -> torch.Tensor:
    """Sparse signed event frames, as tools/latency_bench.py makes them."""
    rng = np.random.default_rng(seed)
    frames = (rng.integers(-3, 4, shape) * (rng.random(shape) < 0.08)) * 0.2
    return torch.tensor(frames, dtype=torch.float32, device=dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, nargs="*", default=[16, 64, 128],
                    help="numbers of streams G of the batched rates")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_latency_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
    from evfly_tpu_torch.stream import BatchedStreamingPipeline, StreamingPipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card()
    model = OrigUNet_w_VITFLY_ViTLSTM(device=dev, **JOINT_CONFIG).eval()
    rng = np.random.default_rng(0)
    windows = [tuple(torch.tensor(v, device=dev) for v in (
        rng.uniform(0, W, N_EVENTS).astype(np.float32),
        rng.uniform(0, H, N_EVENTS).astype(np.float32),
        rng.choice([-1, 1], N_EVENTS).astype(np.int32))) for _ in range(8)]
    result = {"card": smi, "device": torch.cuda.get_device_name(0),
              "single": {"graph": [], "eager": []}, "streams": {}}
    for graph in TURNS:
        pipe = StreamingPipeline(model, fast_percentile=True, device=dev, graph=graph)
        chained, samples = step_ms(lambda w: pipe.step_events(*w), windows)
        result["single"]["graph" if graph else "eager"].append(
            {"chained_ms": chained, "p50_ms": statistics.median(samples)})
        del pipe
    for G in args.streams:
        frames = sparse_frames(5, (G, H, W), dev)
        rates = {"graph": [], "eager": []}
        for graph in TURNS:
            pipe = BatchedStreamingPipeline(model, G, fast_percentile=True, device=dev,
                                            graph=graph)
            rates["graph" if graph else "eager"].append(
                streams_per_s(lambda: pipe.step_frames(frames), G))
            del pipe
            torch.cuda.empty_cache()
        result["streams"][str(G)] = {"steps_per_s": rates}
    print(f"card: {smi}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
