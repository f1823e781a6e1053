"""Quantify the ESIM-vs-difflog event-statistics gap on one sim trajectory.

Port of ``tools/esim_divergence_report.py``: the dataset-generation path
uses linear-in-log ESIM (``ops/esim.py``) where the reference uses
SuperSloMo+esim_torch (utils/to_events.py:146-244); the sim runtime path
uses difflog (run_competition.py:603-635, ``ops/voxelizer.difflog_events``).
This tool renders one straight trajectory on the device and reports the
per-pixel count-distribution gap between the two event generators at
identical thresholds.

Interpretation guide: difflog re-quantizes every frame pair independently
and zeroes sub-threshold windows; ESIM integrates residuals across windows
(each crossing emitted exactly once).  On slow ramps difflog UNDERCOUNTS
(residual < threshold discarded every window) while ESIM accumulates —
that is the designed difference, not an error.

  python -m evfly_tpu_torch.tools.esim_divergence_report [--out-json esim_divergence.json] \\
      [--frames 90] [--fps 30] [--vel 4] [--thresh 0.2] [--hw 260 346] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device


def render_trajectory(seed: int, frames: int, fps: float, vel: float, hw=(260, 346),
                      device=None) -> np.ndarray:
    """Intensity frames (T, H, W) of a straight flight at ``vel`` m/s at 2 m
    altitude through a 30-tree forest of ``seed`` (48 obstacle slots)."""
    from ..sim import generate_forest
    from ..sim.render import render_depth_intensity

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    field = generate_forest(rng, num_obstacles=30, trees=True)
    K = 48
    centers = np.full((K, 3), 1e6, np.float32)
    radii = np.zeros(K, np.float32)
    centers[: len(field)] = field.positions
    radii[: len(field)] = field.radii
    centers_t = torch.as_tensor(centers, device=dev)
    radii_t = torch.as_tensor(radii, device=dev)
    H, W = hw
    dt = 1.0 / fps
    return torch.stack([
        render_depth_intensity(np.asarray([vel * dt * i, 0.0, 2.0], np.float32), centers_t,
                               radii_t, H=H, W=W, is_trees=True, device=dev)[1]
        for i in range(frames)
    ]).cpu().numpy()


def counts(frames: np.ndarray, th: float, device=None):
    """Signed threshold counts (T-1, H, W) of ESIM and of difflog."""
    from ..ops.esim import esim_event_frames
    from ..ops.voxelizer import difflog_events

    dev = resolve_device(device)
    esim = esim_event_frames(frames, th, th, device=dev).cpu().numpy()
    f = torch.as_tensor(frames, device=dev)
    dlog = difflog_events(f[1:], f[:-1], th, th, device=dev).cpu().numpy()
    return np.rint(esim / th).astype(np.int64), np.rint(dlog / th).astype(np.int64)


def divergence_report(frames: np.ndarray, th: float, ce: np.ndarray, cd: np.ndarray) -> dict:
    """The JAX tool's report of ESIM counts ``ce`` against difflog's ``cd``."""
    T = len(frames)
    flat_e, flat_d = ce.ravel(), cd.ravel()
    denom = max(np.abs(flat_d).sum(), 1)

    def cos(a, b):
        na, nb = np.linalg.norm(a.astype(np.float64)), np.linalg.norm(b.astype(np.float64))
        if na == 0 or nb == 0:
            return 1.0 if na == nb else 0.0
        return float((a.astype(np.float64) * b).sum() / (na * nb))

    per_window_cos = np.array([
        cos(ce[i].ravel(), cd[i].ravel()) for i in range(T - 1)
    ])
    diff = np.abs(flat_e - flat_d)
    active = (flat_e != 0) | (flat_d != 0)

    return {
        "frames": T,
        "hw": list(frames.shape[1:]),
        "threshold": th,
        "total_count_ratio_esim_over_difflog": float(
            np.abs(flat_e).sum() / denom
        ),
        "active_pixel_fraction_esim": float((flat_e != 0).mean()),
        "active_pixel_fraction_difflog": float((flat_d != 0).mean()),
        "per_pixel_count_mean_abs_esim": float(np.abs(flat_e).mean()),
        "per_pixel_count_mean_abs_difflog": float(np.abs(flat_d).mean()),
        "count_quantiles_esim_p50_p95_p99_max": [
            float(q) for q in np.percentile(np.abs(flat_e[flat_e != 0]), [50, 95, 99])
        ] + [float(np.abs(flat_e).max())],
        "count_quantiles_difflog_p50_p95_p99_max": [
            float(q) for q in np.percentile(np.abs(flat_d[flat_d != 0]), [50, 95, 99])
        ] + [float(np.abs(flat_d).max())],
        "disagreeing_active_pixel_fraction": float(
            (diff[active] > 0).mean()
        ),
        "mean_abs_count_diff_on_active": float(diff[active].mean()),
        "max_abs_count_diff": int(diff.max()),
        "per_window_cosine_mean": float(per_window_cos.mean()),
        "per_window_cosine_min": float(per_window_cos.min()),
        "pearson_r_per_pixel_counts": float(
            np.corrcoef(flat_e, flat_d)[0, 1]
        ),
    }


def report(seed: int = 11, frames: int = 90, fps: float = 30.0, vel: float = 4.0,
           thresh: float = 0.2, hw=(260, 346), device=None) -> dict:
    dev = resolve_device(device)
    f = render_trajectory(seed, frames, fps, vel, hw, dev)
    return divergence_report(f, thresh, *counts(f, thresh, dev))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--vel", type=float, default=4.0)
    ap.add_argument("--thresh", type=float, default=0.2)
    ap.add_argument("--hw", type=int, nargs=2, default=[260, 346],
                    help="the render's size (the JAX tool renders at 260x346)")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    out = report(args.seed, args.frames, args.fps, args.vel, args.thresh, tuple(args.hw),
                 resolve_device(args.device))
    print(json.dumps(out, indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
