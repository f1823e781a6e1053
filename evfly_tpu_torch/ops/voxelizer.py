"""Event voxelization for the serving path: events -> normalized model input.

Port of the part of ``evfly_tpu/ops/voxelizer.py`` that the serving path
runs: ``_bin_events`` and ``event_histogram_scaled_resized``, with a batch
axis written out (the JAX bench vmaps 256 windows).  For a batch of windows
of raw events ``(x, y, p)`` it returns

    clip(frame / quantile(|frame|, 0.97), +-1) resized bilinearly to
    (h_out, w_out)

where ``frame`` is the signed event count frame with np.histogram2d
binning.  ``hist_scaled_resized`` is the wrapper of the CUDA kernel K3
(``csrc/voxelizer.cu``, the port of ``_hist_pallas_fused_quantile_resize``);
``hist_scaled_resized_plain`` is its plain PyTorch version, which CPU tensors
take and against which the kernel is held.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import _build
from .imageops import resize_matrix
from .percentile import bisect_abs_quantile

# a block may opt in to 227 KB (232,448 bytes) of shared memory; keep 1 KiB
# for the kernel's static shared variables
_SMEM_LIMIT = 232448 - 1024
# two int16 counts share one int32 word in the kernel
_MAX_EVENTS = 32767


def bin_events(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """np.histogram2d binning -> (xi, yi, sign), int64/int64/f32
    (``voxelizer._bin_events``).

    A coordinate equal to W (or H) lands in the last bin; anything outside
    [0, W] x [0, H] (or NaN) gets sign 0, as does pol == 0; sign is +1 for
    pol > 0 and -1 for pol < 0.
    """
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    xi = torch.where(xf >= W, torch.full_like(xf, W - 1), torch.floor(xf))
    yi = torch.where(yf >= H, torch.full_like(yf, H - 1), torch.floor(yf))
    valid = (xf >= 0) & (xf <= W) & (yf >= 0) & (yf <= H)
    sign = torch.where(pol > 0, 1.0, torch.where(pol < 0, -1.0, 0.0)).to(torch.float32)
    sign = torch.where(valid, sign, torch.zeros_like(sign))
    # NaN and far out-of-range coordinates carry sign 0; clamp them before
    # the integer cast so every index is a valid bin
    xi = torch.nan_to_num(xi, nan=0.0).clamp(0, W - 1).to(torch.int64)
    yi = torch.nan_to_num(yi, nan=0.0).clamp(0, H - 1).to(torch.int64)
    return xi, yi, sign


def _kth(q: float, n: int) -> int:
    # floor(q * (n - 1)) + 1 in double, as the TPU kernel computes it at trace time
    return int(q * (n - 1)) + 1


def _taps(R: np.ndarray, n_out: int) -> np.ndarray:
    """(n_out, 4) rows (i0, i1, w0, w1) of the <= 2 nonzeros of each row of R."""
    taps = np.zeros((n_out, 4), np.float32)
    for i in range(n_out):
        nz = np.flatnonzero(R[i])
        if len(nz) == 0:
            continue
        taps[i, 0] = taps[i, 1] = nz[0]
        taps[i, 2] = R[i, nz[0]]
        if len(nz) == 2:
            taps[i, 1] = nz[1]
            taps[i, 3] = R[i, nz[1]]
    return taps


@functools.lru_cache(maxsize=16)
def _resize_operators(H: int, W: int, h_out: int, w_out: int, align_corners: bool,
                      device: torch.device):
    """(taps, rh, rw) on ``device``: the kernel's taps (h_out + w_out, 4) and
    the plain version's dense resize matrices.  Cached: read-only."""
    rh = resize_matrix(H, h_out, align_corners)
    rw = resize_matrix(W, w_out, align_corners)
    taps = np.concatenate([_taps(rh, h_out), _taps(rw, w_out)])
    return (
        torch.tensor(taps, device=device),
        torch.tensor(rh, device=device),
        torch.tensor(rw, device=device),
    )


def hist_scaled_resized_plain(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    h_out: int, w_out: int, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
    align_corners: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: (B, N) events -> ((B, h_out, w_out) input,
    (B,) quantile of |counts|)."""
    B = x.shape[0]
    xi, yi, sign = bin_events(x, y, pol, H, W)
    counts = torch.zeros(B, H * W, dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, yi * W + xi, sign)
    qv = bisect_abs_quantile(counts.abs(), _kth(q, H * W), iters)
    # the zero-quantile fallback scales the VALUE frame (thresh * counts) by 1
    scale = torch.where(qv > 0, 1.0 / qv.clamp_min(1e-30), thresh)
    scaled = (counts * scale[:, None]).clamp(-1.0, 1.0).reshape(B, H, W)
    _, rh, rw = _resize_operators(H, W, h_out, w_out, align_corners, x.device)
    small = torch.matmul(torch.matmul(rh, scaled), rw.T)
    return small, qv


def _kernel_pol(pol: torch.Tensor) -> torch.Tensor:
    if pol.dtype == torch.int32:
        return pol.contiguous()
    return torch.where(pol > 0, 1, torch.where(pol < 0, -1, 0)).to(torch.int32)


def hist_scaled_resized(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    h_out: int, w_out: int, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
    align_corners: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (B, N) events -> ((B, h_out, w_out) input, (B,) quantile).

    CPU tensors take ``hist_scaled_resized_plain``; CUDA tensors launch the
    kernel or raise.  ``hist_scaled_resized.launches`` counts the launches.
    """
    if x.device.type == "cpu":
        return hist_scaled_resized_plain(
            x, y, pol, H, W, h_out, w_out, thresh, q, iters, align_corners
        )
    if x.device.type != "cuda":
        raise ValueError(f"hist_scaled_resized: unsupported device {x.device}")
    if x.dim() != 2 or y.shape != x.shape or pol.shape != x.shape:
        raise ValueError(
            f"hist_scaled_resized: x, y, pol must share one (B, N) shape, got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(pol.shape)}"
        )
    if y.device != x.device or pol.device != x.device:
        raise ValueError("hist_scaled_resized: x, y and pol must be on one device")
    B, N = x.shape
    table_len = N + 1  # |count| <= events per window
    smem = ((H * W + 1) // 2 + table_len) * 4
    if N > _MAX_EVENTS or smem > _SMEM_LIMIT:
        raise ValueError(
            f"hist_scaled_resized: {N} events per window at {H}x{W} need {smem} bytes "
            f"of shared memory (limit {_SMEM_LIMIT}) or exceed {_MAX_EVENTS} events"
        )
    xc = x.to(torch.float32).contiguous()
    yc = y.to(torch.float32).contiguous()
    pc = _kernel_pol(pol)
    taps, _, _ = _resize_operators(H, W, h_out, w_out, align_corners, x.device)
    out = torch.empty(B, h_out, w_out, dtype=torch.float32, device=x.device)
    qout = torch.empty(B, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.evfly_hist_scaled_resized(
            xc.data_ptr(), yc.data_ptr(), pc.data_ptr(), taps.data_ptr(),
            out.data_ptr(), qout.data_ptr(), B, N, H, W, h_out, w_out,
            _kth(q, H * W), thresh, iters, table_len, _build.stream_of(x.device),
        )
    _build.check("evfly_hist_scaled_resized", status)
    hist_scaled_resized.launches += 1
    return out, qout


hist_scaled_resized.launches = 0


def event_histogram_scaled_resized(
    x, y, pol, H: int, W: int, h_out: int, w_out: int, thresh: float = 0.2,
    q: float = 0.97, iters: int = 18, align_corners: bool = False,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Events -> normalized (B, h_out, w_out) model input, one window per row.

    x, y, pol: (B, N) tensors or arrays of the raw events (pol's sign is the
    polarity; 0 is ignored).  Equals the JAX package's
    ``event_histogram_scaled_resized`` applied to each window: the
    97th-percentile normalization of the deployment transform and the
    bilinear resize to the model's input size.  Runs on ``device`` (CUDA
    unless the caller names another), through kernel K3 on CUDA.
    """
    dev = resolve_device(device)
    x, y, pol = (torch.as_tensor(v, device=dev) for v in (x, y, pol))
    if x.dim() != 2:
        raise ValueError(f"event_histogram_scaled_resized expects (B, N) events, got {tuple(x.shape)}")
    small, _ = hist_scaled_resized(
        x, y, pol, H, W, h_out, w_out, thresh, q, iters, align_corners
    )
    return small

