"""Flow-based temporal frame upsampling, the Vid2E/SuperSloMo analog.

Port of ``evfly_tpu/ops/upsample.py``.  Intermediate frames between two
rendered frames come from closed-form warping along the renderer's exact
optical flow,

    I_alpha(x) = (1 - alpha) * I0(x - alpha * dt * F0(x))
               +      alpha  * I1(x + (1 - alpha) * dt * F1(x)),

bilinear backward warps of both endpoint frames, border-clamped, blended by
temporal proximity; the factor of a pair is Vid2E's displacement rule
ceil(max |F| * dt / max_disp) (``adaptive_factor``).  The warps are torch
ops on the frames' device, with any leading batch axes (the alphas of a
pair, the pairs of a sequence) in one call; the per-pair host loop
(``upsample_sequence``) and the factor rule stay on the host with numpy, as
in the JAX package.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _sample_bilinear(img: torch.Tensor, xq: torch.Tensor, yq: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img (..., H, W) at float pixel coordinates xq
    (column) and yq (row), (..., H, W), the leading axes broadcast;
    border-clamped (replicate edge), as cv2.remap BORDER_REPLICATE."""
    H, W = img.shape[-2:]
    batch = torch.broadcast_shapes(img.shape[:-2], xq.shape[:-2], yq.shape[:-2])
    xq = xq.clamp(0.0, W - 1.0).expand(*batch, H, W)
    yq = yq.clamp(0.0, H - 1.0).expand(*batch, H, W)
    x0 = torch.floor(xq).to(torch.int64)
    y0 = torch.floor(yq).to(torch.int64)
    x1 = (x0 + 1).clamp_max(W - 1)
    y1 = (y0 + 1).clamp_max(H - 1)
    wx = xq - x0.to(xq.dtype)
    wy = yq - y0.to(yq.dtype)
    flat = img.expand(*batch, H, W).reshape(*batch, H * W)

    def at(yi, xi):
        return flat.gather(-1, (yi * W + xi).reshape(*batch, H * W)).reshape(*batch, H, W)

    top = at(y0, x0) * (1.0 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1.0 - wx) + at(y1, x1) * wx
    return top * (1.0 - wy) + bot * wy


def warp_backward(img: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Backward-warp img by a displacement field: out(x) = img(x + disp(x)).

    img (..., H, W); disp (..., H, W, 2) in pixels, channel 0 = x/column,
    channel 1 = y/row (the renderer's flow order), the leading axes
    broadcast.  disp is cast to f32 first: f16 flows (h5 storage) would
    quantize the sample coordinates to about 0.25 px at x = 346.
    """
    H, W = img.shape[-2:]
    disp = disp.to(torch.float32)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device),
                            indexing="ij")
    return _sample_bilinear(img, xx + disp[..., 0], yy + disp[..., 1])


def interp_pair(
    i0: torch.Tensor,   # (..., H, W) intensity at t0
    i1: torch.Tensor,   # (..., H, W) intensity at t1
    f0: torch.Tensor,   # (..., H, W, 2) optical flow at t0 [px/s]
    f1: torch.Tensor,   # (..., H, W, 2) optical flow at t1 [px/s]
    dt: float,
    factor: int,
) -> torch.Tensor:
    """(..., factor - 1, H, W) intermediate frames at alphas k / factor,
    k = 1 .. factor - 1, all in one batched warp of each endpoint."""
    if factor < 2:
        return i0.new_zeros(*i0.shape[:-2], 0, *i0.shape[-2:])
    alphas = torch.arange(1, factor, dtype=torch.float32, device=i0.device) / factor
    a4 = alphas.reshape(-1, 1, 1, 1)
    w0 = warp_backward(i0.unsqueeze(-3), (-a4 * dt) * f0.unsqueeze(-4))
    w1 = warp_backward(i1.unsqueeze(-3), ((1.0 - a4) * dt) * f1.unsqueeze(-4))
    a3 = alphas.reshape(-1, 1, 1)
    return (1.0 - a3) * w0 + a3 * w1


def adaptive_factor(
    f0: np.ndarray, f1: np.ndarray, dt: float, max_disp: float = 1.0, max_factor: int = 16
) -> int:
    """Vid2E displacement rule: enough intermediate frames that the largest
    per-pixel displacement between consecutive (upsampled) frames is at most
    ``max_disp`` pixels.  Uses the larger endpoint flow as the pair's bound.
    A copy of the JAX package's numpy function.
    """
    mag = 0.0
    for f in (f0, f1):
        if f is not None:
            m = float(np.max(np.hypot(np.asarray(f[..., 0]), np.asarray(f[..., 1]))))
            if not np.isfinite(m):
                # f16 h5 storage yields inf for grazing-obstacle flows
                # (f*|v|/X past 65504 px/s); NaN can't be ranked either —
                # saturate at the cap instead of raising/ignoring (note
                # python max() would silently DROP a nan here)
                return int(max_factor)
            mag = max(mag, m)
    # clip BEFORE the int(): int(ceil(inf)) raises OverflowError
    disp = min(mag * float(dt) / float(max_disp), float(max_factor))
    k = int(np.ceil(disp)) if disp > 0 else 1
    return int(np.clip(k, 1, max_factor))


def upsample_sequence(
    frames: np.ndarray,    # (T, H, W) intensity
    flows: np.ndarray,     # (T, H, W, 2) optical flow [px/s]
    t_frames: np.ndarray,  # (T,) timestamps [s]
    max_disp: float = 1.0,
    max_factor: int = 16,
    fixed_factor: int | None = None,
    return_factors: bool = False,
    device: DeviceLike = None,
):
    """Upsampled (frames, timestamps[, per-pair factors]) as numpy arrays,
    with per-pair adaptive factors; the warps run on ``device`` (CUDA unless
    the caller names another).

    Endpoint frames are kept verbatim (the upsampled sequence holds the
    original frames at their original timestamps, as the reference's
    upsampled image folders, to_events.py:146-165).  ``fixed_factor``
    overrides the adaptive rule for every pair.
    """
    dev = resolve_device(device)
    frames = np.asarray(frames, np.float32)
    flows = np.asarray(flows, np.float32)  # h5 stores flows as f16
    t_frames = np.asarray(t_frames, np.float64)
    fr = torch.as_tensor(frames, device=dev)
    fl = torch.as_tensor(flows, device=dev)
    out_frames: List[np.ndarray] = [frames[0]]
    out_ts: List[float] = [float(t_frames[0])]
    factors: List[int] = []
    for i in range(1, len(frames)):
        dt = float(t_frames[i] - t_frames[i - 1])
        k = (
            int(fixed_factor)
            if fixed_factor is not None
            else adaptive_factor(flows[i - 1], flows[i], dt, max_disp, max_factor)
        )
        factors.append(k)
        if k > 1:
            mids = interp_pair(fr[i - 1], fr[i], fl[i - 1], fl[i], dt, k).cpu().numpy()
            for j in range(k - 1):
                out_frames.append(mids[j])
                out_ts.append(float(t_frames[i - 1]) + (j + 1) / k * dt)
        out_frames.append(frames[i])
        out_ts.append(float(t_frames[i]))
    if return_factors:
        return np.stack(out_frames), np.asarray(out_ts), np.asarray(factors, np.int64)
    return np.stack(out_frames), np.asarray(out_ts)


def linear_log_upsample(frames: np.ndarray, factor: int, eps: float = 1e-10) -> np.ndarray:
    """No-warp linear-in-log cross-fade to a fixed fine grid,
    ((T-1)*factor + 1, H, W): the interpolation the plain ESIM scan assumes
    between frames, the baseline against flow-warp upsampling.  A copy of
    the JAX package's numpy function.
    """
    frames = np.asarray(frames, np.float32)
    logs = np.log(frames.astype(np.float64) + eps)
    out = [frames[0]]
    for j in range(len(frames) - 1):
        for k in range(1, factor):
            a = k / factor
            out.append(np.exp((1 - a) * logs[j] + a * logs[j + 1]) - eps)
        out.append(frames[j + 1])
    return np.stack(out).astype(np.float32)


def upsample_fixed(
    frames: torch.Tensor,  # (T, H, W)
    flows: torch.Tensor,   # (T, H, W, 2)
    dt: float,
    factor: int,
) -> torch.Tensor:
    """Fixed-factor upsampling of a whole sequence in one batched warp over
    its frame pairs: ((T-1)*factor + 1, H, W) on the frames' device."""
    mids = interp_pair(frames[:-1], frames[1:], flows[:-1], flows[1:], dt, factor)
    blocks = torch.cat([frames[:-1].unsqueeze(1), mids], dim=1)  # (T-1, factor, H, W)
    flat = blocks.reshape(-1, *frames.shape[1:])
    return torch.cat([flat, frames[-1:]], dim=0)
