"""Recording -> gif: the rosbag-free counterpart of utils/generic_bag_to_gif.py.

A copy of ``evfly_tpu/utils/recording_to_gif.py`` (numpy, with ``imageio``
imported where a gif is written and ``h5py`` where an h5 file is read), kept
the same code (``tests/test_torch_tools_utils.py`` checks it); its
``simple_evim`` is the port's copy in ``ev_vis``.  The reference extracts
image topics from a rosbag, optionally renders UInt8MultiArray
event-accumulator frames through ``simple_evim``, and writes a gif +
per-frame pngs (generic_bag_to_gif.py:13-100).  Our recordings are h5
trajectory files (the reference schema) or raw npy stacks.  A host tool
on the CPU: it needs ``imageio`` (and ``h5py`` for h5 input), which a CUDA
machine may not have installed.

  python -m evfly_tpu_torch.utils.recording_to_gif dataset.h5 out.gif \
      --traj rollout_state_0000 --channel evs [--fps 15] [--save-ims DIR]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def frames_to_gif(frames: np.ndarray, out_path: str, fps: float = 15.0,
                  save_ims: Optional[str] = None, is_events: bool = False):
    """frames: (T, H, W) float — events (signed) or grayscale [0, 1]."""
    import imageio

    from .ev_vis import simple_evim

    rendered = []
    for i, f in enumerate(frames):
        if is_events:
            im, _ = simple_evim(f, style="redblue-on-white")
            rgb = np.asarray(im)
            if rgb.dtype != np.uint8:
                rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
        else:
            g = np.clip(f, 0.0, 1.0)
            rgb = np.stack([(g * 255).astype(np.uint8)] * 3, axis=-1)
        rendered.append(rgb)
        if save_ims:
            os.makedirs(save_ims, exist_ok=True)
            imageio.imwrite(os.path.join(save_ims, f"{i:06d}.png"), rgb)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    # imageio>=2.28 deprecated `fps` for GIFs in favor of per-frame duration
    # (ms); fps= raises on future versions
    imageio.mimsave(out_path, rendered, duration=1000.0 / fps, loop=0)
    return out_path


def recording_to_gif(path: str, out_path: str, traj: Optional[str] = None,
                     channel: str = "evs", fps: Optional[float] = None,
                     save_ims: Optional[str] = None):
    """path: .h5 (reference schema) or .npy stack (T, H, W)."""
    if path.endswith(".npy"):
        frames = np.load(path, allow_pickle=True)
        if frames.dtype == object:  # reference evs_frames.npy object arrays
            frames = np.stack(list(frames))
        ts = None
    else:
        import h5py

        with h5py.File(path, "r") as f:
            key = traj if traj is not None else sorted(f.keys())[0]
            g = f[key]
            frames = g[channel][()]
            ts = g["data"][()][:, 1] if "data" in g else None
    if fps is None:
        if ts is not None and len(ts) > 1 and ts[-1] > ts[0]:
            fps = float((len(ts) - 1) / (ts[-1] - ts[0]))
        else:
            fps = 15.0
    return frames_to_gif(
        np.asarray(frames, np.float32), out_path, fps=fps, save_ims=save_ims,
        is_events=(channel == "evs"),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--traj", default=None)
    ap.add_argument("--channel", default="evs", choices=["evs", "ims", "depths"])
    ap.add_argument("--fps", type=float, default=None)
    ap.add_argument("--save-ims", default=None)
    args = ap.parse_args()
    out = recording_to_gif(
        args.input, args.output, traj=args.traj, channel=args.channel,
        fps=args.fps, save_ims=args.save_ims,
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
