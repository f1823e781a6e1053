"""ESIM-style event simulation from image sequences.

Port of ``evfly_tpu/ops/esim.py``.  The ESIM contrast model: a pixel emits
an event each time its log intensity crosses a multiple of the threshold
from a per-pixel reference level, which advances by the emitted quanta and
is carried across windows.  The output is the per-window signed event
count frame x threshold, the tensor the voxelizer makes from a discrete
event list of the same crossings.  The scan over frames is a Python loop of
elementwise torch ops on the frames' device (the JAX package's lax.scan);
``esim_event_frames_upsampled`` loops over frame pairs on the host, each
pair upsampled by flow warping (``ops.upsample``) to its own factor.

Two implementations of ``log`` (XLA's, PyTorch's CPU one, CUDA's ``logf``)
may differ by an ulp, and where a pixel's (log_t - ref) / thresh sits on an
integer, one event count then flips, and through the carried reference
level a later window of that pixel may flip back.  ``esim_margins`` gives,
for each window and pixel, how far that quotient came from an integer in
this window or an earlier one, so that a comparison can bound such flips.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .upsample import adaptive_factor, interp_pair


def _esim_step(ref: torch.Tensor, log_t: torch.Tensor, pos_thresh: float, neg_thresh: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ESIM step from reference level ``ref``: (new ref, frame)."""
    delta = log_t - ref
    pos_events = torch.floor(delta.clamp_min(0.0) / pos_thresh)
    neg_events = torch.floor((-delta).clamp_min(0.0) / neg_thresh)
    frame = pos_thresh * pos_events - neg_thresh * neg_events
    return ref + frame, frame


def _frames_on(frames, device: DeviceLike) -> torch.Tensor:
    return torch.as_tensor(frames, device=resolve_device(device)).to(torch.float32)


def esim_event_frames(frames, pos_thresh: float = 0.2, neg_thresh: float = 0.2,
                      eps: float = 1e-10, device: DeviceLike = None) -> torch.Tensor:
    """(T, H, W) intensities in [0, 1] -> (T-1, H, W) event frames: signed
    threshold-crossing counts x threshold, the reference level carried from
    window to window, so a slow ramp over many frames emits each crossing
    once.  Runs on ``device`` (CUDA unless the caller names another)."""
    logs = torch.log(_frames_on(frames, device) + eps)
    ref = logs[0]
    out = torch.empty_like(logs[1:])
    for i in range(1, logs.shape[0]):
        ref, out[i - 1] = _esim_step(ref, logs[i], pos_thresh, neg_thresh)
    return out


def _esim_block(ref_level: torch.Tensor, block: torch.Tensor, pos_thresh: float,
                neg_thresh: float, eps: float = 1e-10) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ESIM scan over one block of frames (K, H, W) from a carried
    reference level: (the block's signed window sum, the final reference
    level).  The sum is taken in frame order."""
    logs = torch.log(block.to(torch.float32) + eps)
    ref, total = ref_level, torch.zeros_like(ref_level)
    for k in range(logs.shape[0]):
        ref, frame = _esim_step(ref, logs[k], pos_thresh, neg_thresh)
        total = total + frame
    return total, ref


def esim_event_frames_upsampled(
    frames,            # (T, H, W) intensity in [0, 1]
    flows,             # (T, H, W, 2) optical flow [px/s]
    t_frames,          # (T,) timestamps [s]
    pos_thresh: float = 0.2,
    neg_thresh: float = 0.2,
    max_disp: float = 1.0,
    max_factor: int = 16,
    fixed_factor: Optional[int] = None,
    eps: float = 1e-10,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(T-1, H, W) event frames from flow-upsampled ESIM, the Vid2E analog
    (SuperSloMo upsample -> esim_torch -> per-inter-frame windows,
    utils/to_events.py:146-244,400-412).

    Each frame pair is upsampled by flow warping to its own factor (the
    Vid2E displacement rule, ``adaptive_factor`` on the host's numpy
    flows, or ``fixed_factor``), the ESIM scan runs over the pair's fine
    block with the reference level carried across pairs, and the block's
    signed sum is the pair's window.  A host loop over pairs; the warps and
    the scan run on ``device`` (CUDA unless the caller names another), one
    pair's block (up to ``max_factor`` frames) at a time.
    """
    dev = resolve_device(device)
    frames = np.asarray(frames, np.float32)
    flows = np.asarray(flows, np.float32)
    t_frames = np.asarray(t_frames, np.float64)
    fr = torch.as_tensor(frames, device=dev)
    fl = torch.as_tensor(flows, device=dev)
    T = len(frames)
    out = torch.empty(T - 1, *frames.shape[1:], dtype=torch.float32, device=dev)
    ref = torch.log(fr[0] + eps)
    for i in range(1, T):
        dt = float(t_frames[i] - t_frames[i - 1])
        k = (
            int(fixed_factor)
            if fixed_factor is not None
            else adaptive_factor(flows[i - 1], flows[i], dt, max_disp, max_factor)
        )
        if k > 1:
            mids = interp_pair(fr[i - 1], fr[i], fl[i - 1], fl[i], dt, k)
            block = torch.cat([mids, fr[i][None]], dim=0)
        else:
            block = fr[i][None]
        out[i - 1], ref = _esim_block(ref, block, pos_thresh, neg_thresh, eps)
    return out


def esim_margins(frames, pos_thresh: float = 0.2, neg_thresh: float = 0.2,
                 eps: float = 1e-10, device: DeviceLike = None) -> torch.Tensor:
    """(T-1, H, W): for each window and pixel of ``esim_event_frames``, the
    least distance of the quotient its floor takes (delta / pos_thresh, or
    -delta / neg_thresh) from an integer, in this window or any earlier one
    (the carried reference passes a flipped count on).  Where it is small
    (below 1e-5, say), another implementation of ``log`` may emit one event
    more or fewer in this window and one fewer or more in a later one."""
    logs = torch.log(_frames_on(frames, device) + eps)
    ref = logs[0]
    least = torch.full_like(ref, float("inf"))
    out = torch.empty_like(logs[1:])
    for i in range(1, logs.shape[0]):
        delta = logs[i] - ref
        q = torch.where(delta >= 0, delta / pos_thresh, -delta / neg_thresh)
        least = torch.minimum(least, (q - torch.round(q)).abs())
        out[i - 1] = least
        ref, _ = _esim_step(ref, logs[i], pos_thresh, neg_thresh)
    return out


def esim_events_list(
    frames, t_frames, pos_thresh: float = 0.2, neg_thresh: float = 0.2, eps: float = 1e-10
):
    """Host-side discrete event generation (voxelizer / streaming input), a
    copy of the JAX package's numpy function.

    Returns (t, x, y, p) numpy arrays sorted by timestamp; event timestamps
    linearly interpolated within each inter-frame interval in crossing order
    (the output shape of the reference's esim_torch, minus its refractory
    period: events here come from frame-pair crossings, which cannot re-fire
    within a window).  Vectorized with np.repeat over per-pixel counts.
    """
    frames = np.asarray(frames, np.float64)
    t_frames = np.asarray(t_frames, np.float64)
    logs = np.log(frames + eps)
    ref = logs[0].copy()
    ts_l, xs_l, ys_l, ps_l = [], [], [], []
    for i in range(1, len(frames)):
        delta = logs[i] - ref
        n_pos = np.floor(np.maximum(delta, 0) / pos_thresh).astype(np.int64)
        n_neg = np.floor(np.maximum(-delta, 0) / neg_thresh).astype(np.int64)
        ref += pos_thresh * n_pos - neg_thresh * n_neg
        signed = n_pos - n_neg  # at most one of the two is nonzero per pixel
        cnt = np.abs(signed)
        if cnt.sum() == 0:
            continue
        yy, xx = np.nonzero(cnt)
        c = cnt[yy, xx]
        pix = np.repeat(np.arange(len(c)), c)          # active-pixel id per event
        # 0..c-1 within each pixel's run of events
        k = np.arange(len(pix)) - np.repeat(np.cumsum(c) - c, c)
        frac = (k + 1) / (c[pix] + 1)                  # spread uniformly in the interval
        ts_l.append(t_frames[i - 1] + frac * (t_frames[i] - t_frames[i - 1]))
        xs_l.append(xx[pix].astype(np.float64))
        ys_l.append(yy[pix].astype(np.float64))
        ps_l.append(np.sign(signed[yy, xx])[pix].astype(np.int32))
    if not ts_l:
        z = np.array([], np.float64)
        return z, z.copy(), z.copy(), np.array([], np.int32)
    ts = np.concatenate(ts_l)
    order = np.argsort(ts, kind="stable")
    return (
        ts[order],
        np.concatenate(xs_l)[order],
        np.concatenate(ys_l)[order],
        np.concatenate(ps_l)[order],
    )
