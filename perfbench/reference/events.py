"""Plain PyTorch reference of the event-to-frame transforms.

* ``histogram``: np.histogram2d binning of (x, y) with each event's
  polarity sign times the threshold, summed per cell (evfly's
  ``pos_th * hist2d(pos).T - neg_th * hist2d(neg).T`` with equal thresholds).
* ``quantile_scale``: clip(frame / quantile(|frame|, 0.97), +-1), the exact
  (sorted, interpolated) quantile, 1 where it is 0 (evfly_ros run.py).
* ``scaled_resized``: the serving input: signed counts, scaled by the
  97th-percentile order statistic found by the 18-step f32 bisection of the
  JAX package's ``percentile.approx_abs_quantile`` (the threshold where the
  quantile is 0), clipped to +-1 and resized bilinearly to the model's size
  by two products with the 1-D resample matrices.
"""

from __future__ import annotations

import torch


def signed_counts(x, y, pol, H: int, W: int) -> torch.Tensor:
    """(B, N) events -> (B, H, W) f32 sum of sign(pol) per cell; events
    outside [0, W] x [0, H] and pol 0 count nothing."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    sign = torch.sign(pol.to(torch.float32))
    sign = torch.where((xf >= 0) & (xf <= W) & (yf >= 0) & (yf <= H), sign, 0.0)
    xi = torch.floor(xf).clamp(0, W - 1).to(torch.int64)
    yi = torch.floor(yf).clamp(0, H - 1).to(torch.int64)
    out = torch.zeros(x.shape[0], H * W, dtype=torch.float32, device=x.device)
    return out.scatter_add_(1, yi * W + xi, sign).reshape(-1, H, W)


def histogram(x, y, pol, H: int, W: int, thresh: float = 0.2) -> torch.Tensor:
    return thresh * signed_counts(x, y, pol, H, W)


def quantile_scale(frame: torch.Tensor, q: float = 0.97) -> torch.Tensor:
    """frame (..., H, W) -> clip(frame / quantile(|frame|, q), +-1) per frame."""
    flat = frame.reshape(-1, frame.shape[-2] * frame.shape[-1])
    qv = torch.quantile(flat.abs(), q, dim=1)
    qv = torch.where(qv > 0, qv, 1.0).reshape(*frame.shape[:-2], 1, 1)
    return torch.clamp(frame / qv, -1.0, 1.0)


def bisect_quantile(flat_abs: torch.Tensor, q: float = 0.97, iters: int = 18) -> torch.Tensor:
    """(B, n) -> (B,): the k-th smallest value, k = floor(q (n - 1)) + 1,
    as the upper bound of an ``iters``-step bisection on [0, max]; 0 where
    at least k values are 0."""
    kth = int(q * (flat_abs.shape[1] - 1)) + 1
    lo = torch.zeros(flat_abs.shape[0], dtype=flat_abs.dtype, device=flat_abs.device)
    hi = flat_abs.amax(dim=1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        right = (flat_abs <= mid[:, None]).sum(dim=1) < kth
        lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
    return torch.where((flat_abs <= 0).sum(dim=1) >= kth, torch.zeros_like(hi), hi)


def scaled_resized(x, y, pol, H: int, W: int, h_out: int, w_out: int,
                   thresh: float = 0.2) -> torch.Tensor:
    """(B, N) events -> (B, h_out, w_out) serving input."""
    counts = signed_counts(x, y, pol, H, W).reshape(x.shape[0], -1)
    qv = bisect_quantile(counts.abs())
    scale = torch.where(qv > 0, 1.0 / qv.clamp_min(1e-30), thresh)
    frame = (counts * scale[:, None]).clamp(-1.0, 1.0).reshape(-1, H, W)
    rh = resize_matrix(H, h_out).to(frame.device)
    rw = resize_matrix(W, w_out).to(frame.device)
    return rh @ frame @ rw.t()


def resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) f32 matrix of the 1-D bilinear resample with
    align_corners=False (PyTorch's), its taps worked out in f64."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5).clamp_min(0.0)
    i0 = src.floor().to(torch.int64).clamp_max(n_in - 1)
    i1 = (i0 + 1).clamp_max(n_in - 1)
    w1 = src - i0
    r = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    r.index_put_((rows, i0), 1.0 - w1, accumulate=True)
    r.index_put_((rows, i1), w1, accumulate=True)
    return r.to(torch.float32)
