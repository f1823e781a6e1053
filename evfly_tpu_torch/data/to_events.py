"""Dataset-level event generation: utils/to_events.py parity, on the card.

Port of ``evfly_tpu/data/to_events.py``.  The reference converts rollout
image sequences to event frames with SuperSloMo upsampling and CUDA
esim_torch, then windowed histogram2d accumulation, writing
``evs_frames.npy`` (and an ``evs_frames_difflog.npy`` approximation)
(to_events.py:146-456).  Here each trajectory's images, already stored in
the h5 dataset, go through one of three schemes (``trajectory_events``):

* ``esim``: the ESIM contrast model with carried per-pixel reference levels
  (``ops.esim.esim_event_frames``),
* ``esim_flow``: ESIM on a flow-upsampled frame sequence
  (``ops.esim.esim_event_frames_upsampled``, the renderer's exact optical
  flow standing in for SuperSloMo's estimate); needs a per-trajectory
  ``flows`` dataset in the h5 (datagen --record-flow),
* ``difflog``: the per-frame-pair quantized difflog
  (``ops.voxelizer.difflog_events``), to_events.py:419-439.

Usage:
  python -m evfly_tpu_torch.data.to_events --dataset path/to/dataset \\
      [--scheme esim|esim_flow|difflog] [--thresh 0.2] [--no_h5] [--device cpu]

Writes the per-trajectory event frames back into the h5 under ``evs`` (the
training input schema slot) and as a sibling object-array .npy in the
reference's output format.  ``h5py`` is imported only where a file is read.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.esim import esim_event_frames, esim_event_frames_upsampled
from ..ops.voxelizer import difflog_events

SCHEMES = ("esim", "esim_flow", "difflog")


def trajectory_events(ims: np.ndarray, scheme: str = "esim", thresh: float = 0.2,
                      flows: Optional[np.ndarray] = None, ts: Optional[np.ndarray] = None,
                      device: DeviceLike = None) -> torch.Tensor:
    """One trajectory's images (T, H, W) -> its (T-1, H, W) event frames on
    ``device`` (CUDA unless the caller names another), by ``scheme``;
    ``esim_flow`` also takes the flows (T, H, W, 2) and the frame times
    (T,) [s]."""
    dev = resolve_device(device)
    ims = np.asarray(ims, np.float32)
    if scheme == "esim":
        return esim_event_frames(ims, thresh, thresh, device=dev)
    if scheme == "esim_flow":
        if flows is None or ts is None:
            raise ValueError("scheme=esim_flow needs the trajectory's flows and frame times")
        return esim_event_frames_upsampled(ims, flows, ts, thresh, thresh, device=dev)
    if scheme == "difflog":
        frames = torch.as_tensor(ims, device=dev)
        return difflog_events(frames[1:], frames[:-1], thresh, thresh, device=dev)
    raise ValueError(scheme)


def generate_events_for_dataset(
    h5_path: str,
    scheme: str = "esim",
    thresh: float = 0.2,
    write_npy: bool = True,
    write_h5: bool = True,
    out_name: str = "evs_frames",
    device: DeviceLike = None,
):
    """Every trajectory of the h5 dataset through ``trajectory_events``;
    returns the list of (T-1, H, W) f32 numpy event frames."""
    import h5py

    dev = resolve_device(device)
    all_frames = []
    with h5py.File(h5_path, "r+" if write_h5 else "r") as f:
        for name in list(f.keys()):
            ims = np.asarray(f[name]["ims"][()], np.float32)
            flows = ts = None
            if scheme == "esim_flow":
                if "flows" not in f[name]:
                    raise ValueError(
                        f"scheme=esim_flow needs a 'flows' dataset in trajectory "
                        f"{name!r} — regenerate with `python tools/datagen.py "
                        f"--record-flow` (or use scheme=esim)"
                    )
                flows = np.asarray(f[name]["flows"][()], np.float32)
                ts = np.asarray(f[name]["data"][()], np.float32)[:, 1]
            ev = trajectory_events(ims, scheme, thresh, flows, ts, device=dev).cpu().numpy()
            all_frames.append(ev)
            if write_h5:
                if "evs" in f[name]:
                    del f[name]["evs"]
                f[name].create_dataset("evs", data=ev)

    if write_npy:
        out = os.path.join(
            os.path.dirname(h5_path),
            f"{out_name}{'_difflog' if scheme == 'difflog' else ''}.npy",
        )
        obj = np.empty(len(all_frames), dtype=object)
        for i, fr in enumerate(all_frames):
            obj[i] = fr
        np.save(out, obj)
        print(f"Saved {len(all_frames)} trajectories of evframes to {out}")
    return all_frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", type=str, required=True, help="dataset path (with or without .h5)")
    ap.add_argument("--scheme", type=str, default="esim", choices=list(SCHEMES))
    ap.add_argument("--thresh", type=float, default=0.2)
    ap.add_argument("--no_h5", action="store_true", help="do not write evs back into the h5")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    h5_path = args.dataset if args.dataset.endswith(".h5") else args.dataset + ".h5"
    generate_events_for_dataset(h5_path, args.scheme, args.thresh, write_h5=not args.no_h5,
                                device=args.device)


if __name__ == "__main__":
    main()
