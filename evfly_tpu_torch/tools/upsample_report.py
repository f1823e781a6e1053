"""Quantify flow-upsampled event generation against high-rate ground truth.

Port of ``tools/upsample_report.py``.  The reference raises the camera rate
with SuperSloMo before esim_torch (utils/to_events.py:146-200) so event
timestamps resolve motion finer than the camera; the port warps frames
along the renderer's exact optical flow (``ops/upsample.py``).  Because the
scene is analytic, the TRUE intermediate frames can be rendered — the
ground truth Vid2E never has — and measured, on one forest trajectory:

* frame-domain: warped intermediates vs true renders, against the no-warp
  cross-fade baseline;
* event-domain at fine granularity: ESIM on the upsampled sequence vs ESIM
  on the true high-rate sequence, against the linear-in-log interpolation
  the plain ESIM scan assumes.

Renders, warps and ESIM run on the device (CUDA unless ``--device cpu``).

  python -m evfly_tpu_torch.tools.upsample_report [--out-json upsample_report.json] \\
      [--frames 45] [--factor 4] [--hw 130 173] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..device import resolve_device


def render_sequence(seed: int, T: int, K: int, fps: float, vel, hw, device=None):
    """Grayscale frames and flows of T·K + 1 renders along a straight
    flight at ``vel`` from (0, 0, 2), K per base-rate frame interval, in a
    30-tree forest of ``seed`` (48 obstacle slots) -> (frames_hi (T·K+1,
    H, W), flows_hi (T·K+1, H, W, 2))."""
    from ..sim import generate_forest
    from ..sim.batched import pad_fields
    from ..sim.render import render_rgbd_flow

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    field = generate_forest(rng, num_obstacles=30, trees=True)
    centers, radii = pad_fields([field], K_min=48, device=dev)
    centers, radii = centers[0], radii[0]
    H, W = hw
    vel = np.asarray(vel, np.float32)
    vel_t = torch.as_tensor(vel, device=dev)
    lw = torch.tensor([0.299, 0.587, 0.114], device=dev)
    zeros = torch.zeros(3, device=dev)
    dt = 1.0 / fps
    frames_hi, flows_hi = [], []
    for i in range(T * K + 1):
        pos = np.asarray([0.0, 0.0, 2.0] + vel * (i * dt / K), np.float32)
        rgb, _, flow = render_rgbd_flow(pos, vel_t, zeros, centers, radii, H=H, W=W,
                                        is_trees=True, device=dev)
        frames_hi.append(rgb @ lw)
        flows_hi.append(flow)
    return torch.stack(frames_hi).cpu().numpy(), torch.stack(flows_hi).cpu().numpy()


def upsample_report(frames_hi, flows_hi, K: int, fps: float, vel, th: float, device=None) -> dict:
    """The JAX tool's report over the rendered sequence."""
    from ..ops.esim import esim_event_frames
    from ..ops.upsample import adaptive_factor, linear_log_upsample, upsample_sequence

    dev = resolve_device(device)
    dt = 1.0 / fps
    frames = frames_hi[::K]
    flows = flows_hi[::K]
    T = len(frames) - 1
    H, W = frames.shape[1:]

    ts = np.arange(len(frames)) * dt
    up, _ = upsample_sequence(frames, flows, ts, fixed_factor=K, device=dev)

    # ---- frame domain ----
    warp_err = fade_err = 0.0
    n = 0
    for i in range(len(frames_hi)):
        if i % K == 0:
            continue
        a = (i % K) / K
        j = i // K
        fade = (1 - a) * frames[j] + a * frames[j + 1]
        warp_err += float(np.mean(np.abs(up[i] - frames_hi[i])))
        fade_err += float(np.mean(np.abs(fade - frames_hi[i])))
        n += 1
    warp_err /= n
    fade_err /= n

    # ---- event domain (fine windows) ----
    truth_fine = esim_event_frames(frames_hi, th, th, device=dev).cpu().numpy()
    up_fine = esim_event_frames(up, th, th, device=dev).cpu().numpy()
    lin_fine = esim_event_frames(linear_log_upsample(frames, K), th, th,
                                 device=dev).cpu().numpy()

    def cos(a, b):
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            # both empty -> perfect agreement; one empty -> total miss
            return 1.0 if na == nb else 0.0
        return float((a * b).sum() / (na * nb))

    cos_up = np.mean([cos(up_fine[i].ravel(), truth_fine[i].ravel()) for i in range(len(truth_fine))])
    cos_lin = np.mean([cos(lin_fine[i].ravel(), truth_fine[i].ravel()) for i in range(len(truth_fine))])

    factors = [
        adaptive_factor(flows[i], flows[i + 1], dt) for i in range(len(frames) - 1)
    ]
    return {
        "base_frames": T,
        "gt_rate_multiple": K,
        "hw": [H, W],
        "vel": [float(v) for v in vel],
        "threshold": th,
        "frame_mae_flow_warp": warp_err,
        "frame_mae_crossfade": fade_err,
        "frame_mae_ratio": warp_err / fade_err,
        "fine_event_l1_flow_warp": float(np.abs(up_fine - truth_fine).sum()),
        "fine_event_l1_linear_in_log": float(np.abs(lin_fine - truth_fine).sum()),
        "fine_event_l1_ratio": float(
            np.abs(up_fine - truth_fine).sum() / np.abs(lin_fine - truth_fine).sum()
        ),
        "fine_event_cosine_flow_warp": float(cos_up),
        "fine_event_cosine_linear_in_log": float(cos_lin),
        "adaptive_factor_p50_p95_max": [
            float(np.percentile(factors, 50)),
            float(np.percentile(factors, 95)),
            float(np.max(factors)),
        ],
    }


def report(seed: int = 11, frames: int = 45, factor: int = 4, fps: float = 15.0,
           velx: float = 3.0, vely: float = 1.0, thresh: float = 0.2, hw=(130, 173),
           device=None) -> dict:
    dev = resolve_device(device)
    vel = np.array([velx, vely, 0.0], np.float32)
    frames_hi, flows_hi = render_sequence(seed, frames, factor, fps, vel, hw, dev)
    return upsample_report(frames_hi, flows_hi, factor, fps, vel, thresh, dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--frames", type=int, default=45, help="base-rate frames")
    ap.add_argument("--factor", type=int, default=4, help="ground-truth rate multiple")
    ap.add_argument("--fps", type=float, default=15.0)
    ap.add_argument("--velx", type=float, default=3.0)
    ap.add_argument("--vely", type=float, default=1.0, help="lateral dodge component")
    ap.add_argument("--thresh", type=float, default=0.2)
    ap.add_argument("--hw", type=int, nargs=2, default=[130, 173])
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    out = report(args.seed, args.frames, args.factor, args.fps, args.velx, args.vely,
                 args.thresh, tuple(args.hw), resolve_device(args.device))
    print(json.dumps(out, indent=2))
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
