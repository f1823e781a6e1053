"""HIL episode with the real trained model.

Port of ``tools/hil_real_model.py``.  The reference's deployment test flies
the actual network on the vehicle (evfly_ros/run.py:250-309,366-414); this
tool flies one ``run_hil_episode`` with

  * a trained ``StreamingPipeline`` (the joint OrigUNet+ViTLSTM checkpoint,
    one CUDA graph per step on the card; each frame goes in through
    ``step_frame``),
  * a renderer-backed event sensor: intensity difflog between successive
    ``render_depth_intensity`` frames (rendered on the device), quantized at
    the ±0.2 contrast threshold into discrete (x, y, p) bursts on the host —
    exactly what a camera driver would hand the native accumulator,
  * the native C++ flight stack executing the guarded commands,

and reports tracking metrics (forward progress, altitude hold, minimum
obstacle clearance from the 100 Hz fine trajectory) and per-tick model
latency (p50/p95; each tick ends with ``torch.cuda.synchronize``).
Precision: ``set_precision("tf32")`` before the pipeline is built, where
the JAX driver sets "default".

  python -m evfly_tpu_torch.tools.hil_real_model --ckpt <joint.pth> \\
      --out-json hil.json [--pilot] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..precision import set_precision
from .train_policy import PRECISION, load_policy


def make_render_sensor(centers, radii, thresh: float = 0.2, eps: float = 1e-5,
                       is_trees: bool = True, device=None):
    """Renderer-backed event camera: difflog between successive intensity
    renders at the vehicle position, quantized into per-pixel event counts
    (ops/voxelizer.difflog_events semantics, run_competition.py:603-635),
    then expanded to discrete (x, y, p) bursts."""
    from ..sim.render import render_depth_intensity

    dev = resolve_device(device)
    centers = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    radii = torch.as_tensor(radii, dtype=torch.float32, device=dev)
    prev = {"int": None}

    def sensor(pos, t):
        _, inten = render_depth_intensity(np.asarray(pos, np.float32), centers, radii,
                                          is_trees=is_trees, device=dev)
        inten = inten.cpu().numpy()
        if prev["int"] is None:
            prev["int"] = inten
            return np.array([], np.int32), np.array([], np.int32), np.array([], np.int32)
        difflog = np.log(inten + eps) - np.log(prev["int"] + eps)
        prev["int"] = inten
        counts = np.floor(np.abs(difflog) / thresh).astype(np.int32)
        if np.abs(difflog).max() < thresh:
            counts[:] = 0
        sign = np.sign(difflog).astype(np.int32)
        yy, xx = np.nonzero(counts)
        if len(xx) == 0:
            return np.array([], np.int32), np.array([], np.int32), np.array([], np.int32)
        rep = counts[yy, xx]
        return (
            np.repeat(xx.astype(np.int32), rep),
            np.repeat(yy.astype(np.int32), rep),
            np.repeat(sign[yy, xx], rep),
        )

    return sensor


class TimedPipeline:
    """Wraps StreamingPipeline.step_frame with a true-sync latency probe:
    each step ends with ``torch.cuda.synchronize`` on the card."""

    def __init__(self, inner):
        self.inner = inner
        self.input_hw = inner.input_hw
        self.lat = []

    def step_frame(self, frame):
        t0 = time.perf_counter()
        vel, depth = self.inner.step_frame(frame)
        if self.inner.device.type == "cuda":
            torch.cuda.synchronize(self.inner.device)
        self.lat.append(time.perf_counter() - t0)
        return vel, depth


def hil_episode(ckpt: str, duration: float = 8.0, desvel: float = 4.0, seed: int = 77,
                obstacles: int = 30, pilot: bool = False, device=None) -> dict:
    """One HIL episode of the joint model of ``ckpt`` in a forest of
    ``obstacles`` trees from ``seed`` -> the JAX driver's report."""
    from ..sim import generate_forest
    from ..stream.hil import run_hil_episode
    from ..stream.pipeline import StreamingPipeline

    set_precision(PRECISION)
    dev = resolve_device(device)
    pipe = TimedPipeline(StreamingPipeline(load_policy(ckpt, dev), desvel=desvel, device=dev))

    rng = np.random.default_rng(seed)
    field = generate_forest(rng, num_obstacles=obstacles, trees=True)
    K = 48
    centers = np.full((K, 3), 1e6, np.float32)
    radii = np.zeros(K, np.float32)
    centers[: len(field)] = field.positions
    radii[: len(field)] = field.radii
    sensor = make_render_sensor(centers, radii, device=dev)

    res = run_hil_episode(
        pipe, sensor, duration=duration, des_fwd_vel=desvel,
        start_pos=(0.0, 0.0, 0.0) if pilot else (0.0, 0.0, 2.0),
        use_pilot=pilot,
    )

    # pilot episodes: altitude-hold is only meaningful in the run phase
    # (takeoff/landing legs intentionally change altitude)
    fine = res.fine
    if pilot:
        t0, t1 = res.phases["run"]
        fine = fine[(fine[:, 0] >= t0) & (fine[:, 0] <= t1)]

    # minimum horizontal clearance to any tree along the 100 Hz trajectory
    fine_xy = res.fine[:, 1:3]                      # (N, 2) x,y
    act = radii > 0
    d = np.linalg.norm(
        fine_xy[:, None, :] - centers[None, act, :2], axis=-1
    ) - radii[None, act]
    min_clear = float(d.min()) if act.any() else float("inf")

    lat = np.asarray(pipe.lat[1:])  # drop the first tick (the graph's capture)
    report = {
        "ckpt": ckpt,
        "duration_s": duration,
        "final_x_m": float(res.pos[-1, 0]),
        "mean_fwd_vel_mps": float(np.mean(res.vel[:, 0])),
        "alt_rms_about_setpoint_m": float(
            np.sqrt(np.mean((fine[:, 3] - 2.0) ** 2))
        ),
        "min_obstacle_clearance_m": min_clear,
        "collided": bool(min_clear < 0.0),
        "guard_stopped": bool(res.guard_stopped),
        "ticks": int(len(res.t)),
        "tick_latency_ms_p50": float(np.percentile(lat, 50) * 1e3),
        "tick_latency_ms_p95": float(np.percentile(lat, 95) * 1e3),
        "compile_tick_ms": float(pipe.lat[0] * 1e3),
    }
    if pilot:
        report["pilot_transitions"] = [
            [float(t), m_from, m_to] for t, m_from, m_to in res.transitions
        ]
        report["pilot_phases"] = {
            k: [float(a), float(b)] for k, (a, b) in res.phases.items()
        }
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--desvel", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--obstacles", type=int, default=30)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--pilot", action="store_true",
                    help="fly the full pilot episode: arm -> takeoff -> "
                         "run -> land (sim/pilot.py state machine)")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    report = hil_episode(args.ckpt, args.duration, args.desvel, args.seed, args.obstacles,
                         args.pilot, resolve_device(args.device))
    print(json.dumps(report, indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
