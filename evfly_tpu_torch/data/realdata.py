"""Real-data pipeline: time-synced events and depth -> training trajectories.

Port of ``evfly_tpu/data/realdata.py`` (the data_gather pipeline without
rosbags):

* ``sync_depth_events``: approximate-time matching of depth frames to event
  windows, the in-process ``message_filters.ApproximateTimeSynchronizer``
  with its 0.005 s slop (data_gather/depth_and_events.py:73); numpy.
* ``fix_corrupted_depth``: D435 zero-dropout hole filling; numpy.
* ``package_real_sequence``: a raw (t, x, y, p) event stream and depth
  frames -> the h5 trajectory schema, each inter-depth-frame window
  voxelized by ``ops.voxelizer.event_frames_from_windows`` (K1 over all
  windows in one launch on the card), with the telemetry columns the
  learner ignores for real data spoofed
  (convert_realdata_to_datasetformat.py:65-98).
* Optional per-frame alignment through ``utils.calibration.Aligner``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.voxelizer import event_frames_from_windows


def sync_depth_events(
    depth_ts: np.ndarray, event_t: np.ndarray, slop: float = 0.005
) -> List[Tuple[int, float, float]]:
    """Match each depth frame i (i>=1) to the event window between the
    previous and current depth timestamps, keeping frames whose spacing is
    sane.  Returns [(depth_idx, t_start, t_end), ...]."""
    out = []
    for i in range(1, len(depth_ts)):
        t0, t1 = float(depth_ts[i - 1]), float(depth_ts[i])
        if t1 <= t0:
            continue
        # windows wholly outside the event stream (± slop) are dropped
        if t1 < event_t[0] - slop or t0 > event_t[-1] + slop:
            continue
        out.append((i, t0, t1))
    return out


def fix_corrupted_depth(depth_image: np.ndarray, neighbors: int = 5) -> np.ndarray:
    """Fill zero-valued (corrupted) depth pixels with the mean of nonzero
    neighbors in a (2*neighbors+1)^2 window — D435 dropout hole-filling.

    Reference-exact semantics (run_competition.py:931-953): pixels are
    processed IN PLACE in row-major order, so a filled hole participates in
    later holes' neighborhoods; a hole whose entire window is zero becomes
    NaN (np.mean of an empty slice), as in the reference.  Returns the same
    array, mutated.
    """
    rows, cols = np.nonzero(depth_image == 0.0)
    if len(rows) == 0:
        return depth_image
    Hh, Ww = depth_image.shape
    for row, col in zip(rows.tolist(), cols.tolist()):
        win = depth_image[
            max(0, row - neighbors) : min(Hh, row + neighbors + 1),
            max(0, col - neighbors) : min(Ww, col + neighbors + 1),
        ]
        vals = win[win != 0.0]
        with np.errstate(invalid="ignore"):
            depth_image[row, col] = np.mean(vals) if vals.size else np.nan
    return depth_image


def package_real_sequence(
    name: str,
    event_t: np.ndarray,
    event_x: np.ndarray,
    event_y: np.ndarray,
    event_p: np.ndarray,
    depth_frames: np.ndarray,       # (T, H, W) float [0, 1]
    depth_ts: np.ndarray,           # (T,)
    desired_vel: float = 4.0,
    aligner=None,
    sensor_hw: Optional[Tuple[int, int]] = None,
    pos_thresh: float = 0.2,
    neg_thresh: float = 0.2,
    fix_depth_holes: bool = True,
    device: DeviceLike = None,
) -> Dict:
    """Build one h5-schema trajectory dict (numpy arrays) from a real
    recording, its windows voxelized on ``device`` (CUDA unless the caller
    names another).

    Accepts real-sensor conventions directly:
    * timestamps at any epoch scale (Prophesee stamps are ns/us since boot or
      UNIX epoch), rebased to the recording start in float64 BEFORE the
      float32 cast of the times and the window edges, which would otherwise
      quantize epoch-scale values to ~100 s resolution; window membership is
      decided on those f32 values, as in the JAX package;
    * polarity as {0, 1} (Prophesee/dv EventArray encoding) or {-1, +1};
      {0, 1} streams are mapped to signed.
    """
    dev = resolve_device(device)
    H, W = sensor_hw if sensor_hw is not None else depth_frames.shape[1:]

    event_t = np.asarray(event_t, np.float64)
    depth_ts = np.asarray(depth_ts, np.float64)
    t_base = min(float(event_t[0]), float(depth_ts[0]))
    event_t = event_t - t_base
    depth_ts = depth_ts - t_base

    event_p = np.asarray(event_p)
    if event_p.min() >= 0 and event_p.max() <= 1:
        event_p = event_p.astype(np.int32) * 2 - 1

    pairs = sync_depth_events(depth_ts, event_t)
    if not pairs:
        raise ValueError("no synced depth/event windows")
    idxs = [p[0] for p in pairs]
    starts = np.array([p[1] for p in pairs], np.float64)
    ends = np.array([p[2] for p in pairs], np.float64)

    evs = event_frames_from_windows(
        torch.as_tensor(event_t.astype(np.float32)),
        torch.as_tensor(np.asarray(event_x, np.float32)),
        torch.as_tensor(np.asarray(event_y, np.float32)),
        torch.as_tensor(event_p),
        torch.as_tensor(starts.astype(np.float32)),
        torch.as_tensor(ends.astype(np.float32)),
        H, W, pos_thresh, neg_thresh, device=dev,
    ).cpu().numpy()

    depths = depth_frames[[0] + idxs]  # leading frame + one per window
    if fix_depth_holes:
        # D435 zero-dropout holes (run_competition.py:1020 applies the same
        # fill to every live depth frame before the policy sees it)
        depths = np.stack([fix_corrupted_depth(d.copy()) for d in depths])
    if aligner is not None:
        depths = np.stack([aligner.align(depth=d)["depth"] for d in depths])
        evs = np.stack([aligner.align(davis=e)["davis"] for e in evs])

    T = len(depths)
    # spoofed telemetry (convert_realdata_to_datasetformat.py:65-98):
    # real rigs lack sim ground truth; only idx/timestamp/desvel are real.
    meta = np.zeros((T, 21), np.float32)
    meta[:, 0] = np.arange(T)
    meta[:, 1] = depth_ts[[0] + idxs] - depth_ts[0]
    meta[:, 2] = desired_vel
    meta[:, 3] = 1.0  # identity quaternion w

    return {
        "name": name,
        "data": meta,
        "ims": np.ones_like(depths),  # blank grayscale stand-ins
        "depths": depths,
        "desvel": meta[:, 2],
        "evs": evs,
    }
