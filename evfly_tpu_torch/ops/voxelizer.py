"""Event voxelization: raw events -> event frames and normalized model inputs.

Port of ``evfly_tpu/ops/voxelizer.py``: ``_bin_events`` and the three
functions over its Pallas kernels, each with a batch axis written out (the
JAX callers vmap over windows).  For windows of raw events ``(x, y, p)``,
with ``counts`` the signed event count frame under np.histogram2d binning:

- ``event_histogram``: ``thresh * counts`` (two passes,
  ``pos * pos_counts - neg * neg_counts``, when the thresholds differ),
  through kernel K1 (``hist_frame``);
- ``event_histogram_scaled``: ``clip(counts / quantile(|counts|, 0.97),
  +-1)``, through kernel K2 (``hist_scaled``);
- ``event_histogram_scaled_resized``: the same frame resized bilinearly to
  (h_out, w_out), through kernel K3 (``hist_scaled_resized``).

The kernels are in ``csrc/voxelizer.cu``.  Each wrapper ``hist_*`` has a
plain PyTorch version ``hist_*_plain``, which CPU tensors take and against
which the kernel is held.  K2 and K3 pack two int16 counts per word and take
at most 32,767 events per window; the two entry points over them take any
number, routing a batch by its shape (``scaled_route``) where K2 and K3
cannot take it through K1's counts and ``scale_counts`` or
``scale_counts_resized``, K2's and K3's function over a count frame in a
kernel of their own.  The TPU layout knobs of the JAX functions
(``chunk``, ``subchunks``, ``int8_mm``, ``interpret``) have no counterpart.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..precision import with_precision
from . import _build
from .imageops import resize_matrix
from .percentile import bisect_abs_quantile

# a block may opt in to 227 KB (232,448 bytes) of shared memory; keep 1 KiB
# for the kernel's static shared variables
_SMEM_LIMIT = 232448 - 1024
# two int16 counts share one int32 word in K2's and K3's shared frame
_MAX_EVENTS = 32767
# K1 counts a band of rows of the frame per block in int32: 32 KiB a band
_BAND_INTS = 8192


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


def _signed_counts(x, y, pol, H: int, W: int) -> torch.Tensor:
    """(B, N) events -> (B, H * W) f32 signed counts, by scatter_add_."""
    xi, yi, sign = bin_events(x, y, pol, H, W)
    counts = torch.zeros(x.shape[0], H * W, dtype=torch.float32, device=x.device)
    return counts.scatter_add_(1, yi * W + xi, sign)



def hist_frame_plain(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    pos_thresh: float = 0.2, neg_thresh: float = 0.2,
) -> torch.Tensor:
    """Plain PyTorch version of K1: (B, N) events -> (B, H, W) frame."""
    B = x.shape[0]
    if pos_thresh == neg_thresh:
        return (pos_thresh * _signed_counts(x, y, pol, H, W)).reshape(B, H, W)
    xi, yi, sign = bin_events(x, y, pol, H, W)
    idx = yi * W + xi
    zeros = torch.zeros(B, H * W, dtype=torch.float32, device=x.device)
    pos_counts = zeros.clone().scatter_add_(1, idx, sign.clamp_min(0.0))
    neg_counts = zeros.scatter_add_(1, idx, (-sign).clamp_min(0.0))
    return (pos_thresh * pos_counts - neg_thresh * neg_counts).reshape(B, H, W)


def scale_counts_plain(
    counts: torch.Tensor, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2's normalization of a (B, H, W) count
    frame: (clip(counts * scale, +-1), (B,) quantile of |counts|), with
    scale 1 / q, or ``thresh`` where the quantile snapped to 0 (the fallback
    scales the VALUE frame thresh * counts by 1)."""
    flat = counts.reshape(counts.shape[0], -1)
    qv = bisect_abs_quantile(flat.abs(), _kth(q, flat.shape[1]), iters)
    scale = torch.where(qv > 0, 1.0 / qv.clamp_min(1e-30), thresh)
    return (flat * scale[:, None]).clamp(-1.0, 1.0).reshape(counts.shape), qv


def scale_counts_resized_plain(
    counts: torch.Tensor, h_out: int, w_out: int, thresh: float = 0.2, q: float = 0.97,
    iters: int = 18, align_corners: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3's normalization and resize of a (B, H, W)
    count frame: ((B, h_out, w_out) input, (B,) quantile of |counts|)."""
    scaled, qv = scale_counts_plain(counts, thresh, q, iters)
    _, rh, rw = _resize_operators(*counts.shape[1:], h_out, w_out, align_corners,
                                  counts.device)
    return torch.matmul(torch.matmul(rh, scaled), rw.T), qv


def hist_scaled_plain(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    thresh: float = 0.2, q: float = 0.97, iters: int = 18,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: (B, N) events -> ((B, H, W) clipped
    frame, (B,) quantile of |counts|)."""
    counts = _signed_counts(x, y, pol, H, W).reshape(x.shape[0], H, W)
    return scale_counts_plain(counts, thresh, q, iters)


def hist_scaled_resized_plain(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    h_out: int, w_out: int, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
    align_corners: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: (B, N) events -> ((B, h_out, w_out) input,
    (B,) quantile of |counts|)."""
    counts = _signed_counts(x, y, pol, H, W).reshape(x.shape[0], H, W)
    return scale_counts_resized_plain(counts, h_out, w_out, thresh, q, iters, align_corners)


def _kernel_events(name: str, x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor):
    """The events as the kernels take them: (B, N) f32 x, y and int32 pol
    on one CUDA device, contiguous; raises on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 2 or y.shape != x.shape or pol.shape != x.shape:
        raise ValueError(
            f"{name}: x, y, pol must share one (B, N) shape, got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(pol.shape)}"
        )
    if y.device != x.device or pol.device != x.device:
        raise ValueError(f"{name}: x, y and pol must be on one device")
    if pol.dtype == torch.int32:
        pc = pol.contiguous()
    else:
        pc = torch.where(pol > 0, 1, torch.where(pol < 0, -1, 0)).to(torch.int32)
    return x.to(torch.float32).contiguous(), y.to(torch.float32).contiguous(), pc


def _packed_smem(N: int, H: int, W: int) -> int:
    # the packed frame and the count-of-counts table (|count| <= N)
    return ((H * W + 1) // 2 + N + 1) * 4


def scaled_route(N: int, H: int, W: int) -> str:
    """The route of a batch of N events per window at H x W through the
    scaled entry points: "packed" (K2, K3) where a count fits int16 and the
    packed frame fits one block, else "k1" (K1's counts, then
    ``scale_counts`` or ``scale_counts_resized``).  Decided by shape alone,
    before any launch."""
    fits = N <= _MAX_EVENTS and _packed_smem(N, H, W) <= _SMEM_LIMIT
    return "packed" if fits else "k1"


def _packed_table_len(name: str, N: int, H: int, W: int) -> int:
    """K2's and K3's count-of-counts table length; raises when the packed
    frame and the table do not fit one block or a count could pass int16."""
    table_len = N + 1  # |count| <= events per window
    smem = _packed_smem(N, H, W)
    if scaled_route(N, H, W) != "packed":
        raise ValueError(
            f"{name}: {N} events per window at {H}x{W} need {smem} bytes of shared "
            f"memory (limit {_SMEM_LIMIT}) or exceed {_MAX_EVENTS} events: the kernel "
            f"packs two int16 counts per word, so it takes at most {_MAX_EVENTS} events "
            f"per window (event_histogram takes any number)"
        )
    return table_len


def hist_frame(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    pos_thresh: float = 0.2, neg_thresh: float = 0.2,
) -> torch.Tensor:
    """K1: (B, N) events, any N -> (B, H, W) frame ``thresh * counts``
    (``pos * pos_counts - neg * neg_counts`` when the thresholds differ).

    CPU tensors take ``hist_frame_plain``; CUDA tensors launch the kernel or
    raise.  ``hist_frame.launches`` counts the launches.
    """
    if x.device.type == "cpu":
        return hist_frame_plain(x, y, pol, H, W, pos_thresh, neg_thresh)
    xc, yc, pc = _kernel_events("hist_frame", x, y, pol)
    B, N = xc.shape
    two_pass = pos_thresh != neg_thresh
    arrays = 2 if two_pass else 1
    rows_per_band = max(1, min(H, _BAND_INTS // (W * arrays)))
    if rows_per_band * W * arrays * 4 > _SMEM_LIMIT:
        raise ValueError(f"hist_frame: a row of {W} cells does not fit in shared memory")
    out = torch.empty(B, H, W, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.evfly_hist_frame(
            xc.data_ptr(), yc.data_ptr(), pc.data_ptr(), out.data_ptr(), B, N, H, W,
            rows_per_band, pos_thresh, neg_thresh, int(two_pass), _build.stream_of(x.device),
        )
    _build.check("evfly_hist_frame", status)
    hist_frame.launches += 1
    return out


hist_frame.launches = 0


def hist_scaled(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    thresh: float = 0.2, q: float = 0.97, iters: int = 18,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (B, N) events, N <= 32,767 -> ((B, H, W) clipped frame, (B,)
    quantile).

    CPU tensors take ``hist_scaled_plain``; CUDA tensors launch the kernel
    or raise.  ``hist_scaled.launches`` counts the launches.
    """
    if x.device.type == "cpu":
        return hist_scaled_plain(x, y, pol, H, W, thresh, q, iters)
    xc, yc, pc = _kernel_events("hist_scaled", x, y, pol)
    B, N = xc.shape
    table_len = _packed_table_len("hist_scaled", N, H, W)
    out = torch.empty(B, H, W, dtype=torch.float32, device=x.device)
    qout = torch.empty(B, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.evfly_hist_scaled(
            xc.data_ptr(), yc.data_ptr(), pc.data_ptr(), out.data_ptr(), qout.data_ptr(),
            B, N, H, W, _kth(q, H * W), thresh, iters, table_len, _build.stream_of(x.device),
        )
    _build.check("evfly_hist_scaled", status)
    hist_scaled.launches += 1
    return out, qout


hist_scaled.launches = 0


def hist_scaled_resized(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    h_out: int, w_out: int, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
    align_corners: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (B, N) events, N <= 32,767 -> ((B, h_out, w_out) input, (B,)
    quantile).

    CPU tensors take ``hist_scaled_resized_plain``; CUDA tensors launch the
    kernel or raise.  ``hist_scaled_resized.launches`` counts the launches.
    """
    if x.device.type == "cpu":
        return hist_scaled_resized_plain(
            x, y, pol, H, W, h_out, w_out, thresh, q, iters, align_corners
        )
    xc, yc, pc = _kernel_events("hist_scaled_resized", x, y, pol)
    B, N = xc.shape
    table_len = _packed_table_len("hist_scaled_resized", N, H, W)
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


def _scale_launch(name: str, counts: torch.Tensor, thresh: float, q: float, iters: int,
                  resize: Optional[Tuple[int, int, bool]]):
    """Launch ``scale_counts_kernel`` on (B, H, W) counts on CUDA; ``resize``
    (h_out, w_out, align_corners) or None.  Returns (out, q)."""
    if counts.device.type != "cuda" or counts.dim() != 3:
        raise ValueError(f"{name}: expected (B, H, W) counts on CUDA, got "
                         f"{tuple(counts.shape)} on {counts.device}")
    cc = counts.to(torch.float32).contiguous()
    B, H, W = cc.shape
    h_out, w_out, align_corners = resize if resize is not None else (H, W, False)
    taps = cc  # not read without a resize
    if resize is not None:
        taps, _, _ = _resize_operators(H, W, h_out, w_out, align_corners, cc.device)
    out = torch.empty(B, h_out, w_out, dtype=torch.float32, device=cc.device)
    qout = torch.empty(B, dtype=torch.float32, device=cc.device)
    with torch.cuda.device(cc.device):
        status = _build.library().evfly_scale_counts(
            cc.data_ptr(), taps.data_ptr(), out.data_ptr(), qout.data_ptr(), B, H, W, h_out,
            w_out, _kth(q, H * W), thresh, iters, int(resize is not None),
            _build.stream_of(cc.device),
        )
    _build.check(name, status)
    return out, qout


def scale_counts(
    counts: torch.Tensor, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function over a (B, H, W) f32 count frame of exact integers (K1's
    with thresholds 1), for windows K2 cannot take: ((B, H, W) clipped frame,
    (B,) quantile), the quantile the plain version's bit for bit.

    CPU tensors take ``scale_counts_plain``; CUDA tensors launch the kernel
    or raise.  ``scale_counts.launches`` counts the launches.
    """
    if counts.device.type == "cpu":
        return scale_counts_plain(counts, thresh, q, iters)
    res = _scale_launch("scale_counts", counts, thresh, q, iters, None)
    scale_counts.launches += 1
    return res


scale_counts.launches = 0


def scale_counts_resized(
    counts: torch.Tensor, h_out: int, w_out: int, thresh: float = 0.2, q: float = 0.97,
    iters: int = 18, align_corners: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function over a (B, H, W) count frame as ``scale_counts`` takes
    it: ((B, h_out, w_out) input, (B,) quantile).

    CPU tensors take ``scale_counts_resized_plain``; CUDA tensors launch the
    kernel or raise.  ``scale_counts_resized.launches`` counts the launches.
    """
    if counts.device.type == "cpu":
        return scale_counts_resized_plain(counts, h_out, w_out, thresh, q, iters,
                                          align_corners)
    res = _scale_launch("scale_counts_resized", counts, thresh, q, iters,
                        (h_out, w_out, align_corners))
    scale_counts_resized.launches += 1
    return res


scale_counts_resized.launches = 0


def hist_scaled_routed(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    thresh: float = 0.2, q: float = 0.97, iters: int = 18,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(frame, quantile) of ``event_histogram_scaled`` for (B, N) events:
    K2 (``hist_scaled``) or, where ``scaled_route`` says "k1", K1's counts
    and ``scale_counts``."""
    if scaled_route(x.shape[1], H, W) == "packed":
        return hist_scaled(x, y, pol, H, W, thresh, q, iters)
    return scale_counts(hist_frame(x, y, pol, H, W, 1.0, 1.0), thresh, q, iters)


def hist_scaled_resized_routed(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    h_out: int, w_out: int, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
    align_corners: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(input, quantile) of ``event_histogram_scaled_resized`` for (B, N)
    events: K3 (``hist_scaled_resized``) or, where ``scaled_route`` says
    "k1", K1's counts and ``scale_counts_resized``."""
    if scaled_route(x.shape[1], H, W) == "packed":
        return hist_scaled_resized(x, y, pol, H, W, h_out, w_out, thresh, q, iters,
                                   align_corners)
    return scale_counts_resized(hist_frame(x, y, pol, H, W, 1.0, 1.0), h_out, w_out, thresh,
                                q, iters, align_corners)


def _device_events(x, y, pol, device: DeviceLike):
    """Tensors or arrays of events on the resolved device, as a (B, N)
    batch, and whether the caller gave one (N,) window."""
    dev = resolve_device(device)
    x, y, pol = (torch.as_tensor(v, device=dev) for v in (x, y, pol))
    if x.dim() not in (1, 2):
        raise ValueError(f"expected (N,) or (B, N) events, got {tuple(x.shape)}")
    single = x.dim() == 1
    if single:
        x, y, pol = x[None], y[None], pol[None]
    return x, y, pol, single


def event_histogram(
    x, y, pol, H: int, W: int, pos_thresh: float = 0.2, neg_thresh: float = 0.2,
    device: DeviceLike = None,
) -> torch.Tensor:
    """One (N,) window of raw events -> (H, W) f32 event frame; a (B, N)
    batch -> (B, H, W).

    Equals the JAX package's ``event_histogram`` bit for bit:
    ``pos_thresh * counts``, or ``pos_thresh * pos_counts - neg_thresh *
    neg_counts`` when the thresholds differ (the reference's
    ``pos_th*hist2d(pos).T - neg_th*hist2d(neg).T``).  pol's sign is the
    polarity; 0 is ignored.  Any number of events.  Runs on ``device``
    (CUDA unless the caller names another), through kernel K1 on CUDA.
    """
    x, y, pol, single = _device_events(x, y, pol, device)
    frame = hist_frame(x, y, pol, H, W, pos_thresh, neg_thresh)
    return frame[0] if single else frame


def event_histogram_reference(
    x, y, pol, H: int, W: int, pos_thresh: float = 0.2, neg_thresh: float = 0.2,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Plain oracle with the semantics of ``event_histogram``: the threshold
    values themselves summed per cell (``index_add_``), as the JAX
    ``event_histogram_reference`` sums them with ``segment_sum``.  (N,) ->
    (H, W), (B, N) -> (B, H, W)."""
    x, y, pol, single = _device_events(x, y, pol, device)
    xi, yi, sign = bin_events(x, y, pol, H, W)
    vals = torch.where(sign > 0, pos_thresh, torch.where(sign < 0, -neg_thresh, 0.0))
    flat = torch.zeros(x.shape[0], H * W, dtype=torch.float32, device=x.device)
    frame = flat.scatter_add_(1, yi * W + xi, vals.to(torch.float32)).reshape(-1, H, W)
    return frame[0] if single else frame


def event_histogram_scaled(
    x, y, pol, H: int, W: int, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Events -> clip(frame / quantile(|frame|, q), +-1), the deployment
    input transform, as the JAX package's ``event_histogram_scaled``.

    One (N,) window -> (H, W); a (B, N) batch -> (B, H, W).  Any number
    of events.  Runs on ``device`` (CUDA unless the caller names another),
    through K2 on CUDA, or where K2 cannot take the batch (``scaled_route``:
    above 32,767 events per window, or about 12,900 at 260 x 346) through
    K1 and ``scale_counts`` (``hist_scaled_routed``).
    """
    x, y, pol, single = _device_events(x, y, pol, device)
    frame, _ = hist_scaled_routed(x, y, pol, H, W, thresh, q, iters)
    return frame[0] if single else frame


@with_precision
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
    bilinear resize to the model's input size.  Any number of events.
    Runs on ``device`` (CUDA unless the caller names another), through
    kernel K3 on CUDA, or where K3 cannot take the batch (``scaled_route``)
    through K1 and ``scale_counts_resized`` (``hist_scaled_resized_routed``),
    at the precision of
    ``evfly_tpu_torch.set_precision``.
    """
    dev = resolve_device(device)
    x, y, pol = (torch.as_tensor(v, device=dev) for v in (x, y, pol))
    if x.dim() != 2:
        raise ValueError(f"event_histogram_scaled_resized expects (B, N) events, got {tuple(x.shape)}")
    small, _ = hist_scaled_resized_routed(
        x, y, pol, H, W, h_out, w_out, thresh, q, iters, align_corners
    )
    return small
