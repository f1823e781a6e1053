"""Event voxelization: raw events -> event frames and normalized model inputs.

Port of ``evfly_tpu/ops/voxelizer.py``: ``_bin_events`` and the three
functions over its Pallas kernels, each with a batch axis written out (the
JAX callers vmap over windows).  For windows of raw events ``(x, y, p)``,
with ``counts`` the signed event count frame under np.histogram2d binning:

- ``event_histogram``: ``thresh * counts`` (two passes,
  ``pos * pos_counts - neg * neg_counts``, when the thresholds differ),
  through kernel K1 (``hist_frame_routed``);
- ``event_histogram_scaled``: ``clip(counts / quantile(|counts|, 0.97),
  +-1)``, through kernel K2 (``hist_scaled_routed``);
- ``event_histogram_scaled_resized``: the same frame resized bilinearly to
  (h_out, w_out), through kernel K3 (``hist_scaled_resized_routed``);
- ``event_frames_from_windows``: many time windows of one stream -> (T, H,
  W) frames, the stream sorted by time once and every window binned in one
  launch of K1 over offsets into it (``hist_frame_windows``);
- ``difflog_events``: the quantized log difference of two frames (torch
  ops);
- ``stacked_histogram``: RVT's time-binned count frame of one window of
  events (x, y, pol, t), 2 T channels (torch ops, on any device);
- ``voxel_grid``: E-RAFT's normalised trilinear voxel grid of one window of
  events (x, y, pol, t) through a rectification map, T channels (torch ops,
  on any device).

The kernels are in ``csrc/voxelizer.cu``.  Each wrapper ``hist_*`` has a
plain PyTorch version ``hist_*_plain``, which CPU tensors take and against
which the kernel is held, and counts its own launches.  K1, K2 and K3 run
one thread-block cluster per window with the window's count frame in the
cluster's distributed shared memory (``hist_frame_cluster``,
``hist_scaled``, ``hist_scaled_resized``).  K1 has three routes, chosen by
shape before launch (``k1_route``): its cluster kernel on 8 CTAs per window
where they hold the frame, on 16 where those do, and for the frames no
cluster holds the band route (``hist_frame``: a partition pass that sorts
each window's binned events by band of the frame, then one block per
(window, band) reading only its band's).  K2 takes up to
``scaled_cluster_cap`` events per window, K3 up to ``resized_cluster_cap``.
The entry points take any number, routing a batch by its shape
(``scaled_route``) where K2 and K3 cannot take it through K1's counts and
``scale_counts`` or ``scale_counts_resized``, K2's and K3's function over a
count frame on a cluster kernel of their own.  The TPU layout knobs of the
JAX functions (``chunk``, ``subchunks``, ``int8_mm``, ``interpret``) have no
counterpart.
"""

from __future__ import annotations

import ctypes
import functools
import collections
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..precision import with_precision
from ..utils import profiling
from . import _build
from .imageops import resize_matrix
from .percentile import bisect_abs_quantile

# a block may opt in to 227 KB (232,448 bytes) of shared memory; keep 1 KiB
# for the kernel's static shared variables (8 KiB for scale_counts')
_SMEM_LIMIT = 232448 - 1024
_SCALE_SMEM_LIMIT = 232448 - 8192
# two int16 counts share one int32 word in K2's and K3's bands up to this
# many events per window
_MAX_EVENTS = 32767
# K1's band route: a block of its band pass counts a band of this many
# int32 (32 KiB, two arrays with two thresholds) of flat cells, wider only
# where the frame would have more than _MAX_BANDS bands; a block of its
# partition pass takes _BAND_CHUNK events of one window
_BAND_INTS = 8192
_MAX_BANDS = 8192
_BAND_CHUNK = 4096
# CTAs per window of the cluster kernels (measured on the H100, PERF.md
# section 6); the library takes up to 16.  K1 takes K1_CLUSTER where they
# hold the frame, else K1_WIDE_CLUSTER (a non-portable size) where those do
K1_CLUSTER = 8
K1_WIDE_CLUSTER = 16
K2_CLUSTER = 2
K3_CLUSTER = 2
SCALE_CLUSTER = 16
_MAX_CLUSTER = 16
# K2's and K3's cluster kernels and scale_counts' keep a dense table of
# |count| below this and a list of the cells at or above it (K2's and K3's
# at most N / _K_TABLE of them)
_K_TABLE = 64


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


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def band_rows(H: int, cluster: int) -> int:
    """Rows of the frame in each CTA's band on a cluster of ``cluster``
    CTAs: CTA r holds rows [r * rows, (r + 1) * rows) (``csrc/voxelizer.cu``,
    ``band_rows``)."""
    return -(-H // cluster)


def _band_ints(H: int, W: int, cluster: int) -> int:
    # a band array's cells, 3 words for K1's output alignment, whole int4s
    return _round4(band_rows(H, cluster) * W + 3)


def frame_cluster_fits(H: int, W: int, two_pass: bool, cluster: int = K1_CLUSTER) -> bool:
    """Whether K1's cluster kernel takes an H x W frame: its band (two
    count arrays when the thresholds differ) within a block's shared
    memory.  The rule of ``csrc/voxelizer.cu``'s ``frame_cluster_fits``,
    stated here for the CPU where the library is not built (its entry point
    ``evfly_hist_frame_cluster_fits`` gives the library's)."""
    return (H >= 1 and W >= 1 and 1 <= cluster <= _MAX_CLUSTER
            and (2 if two_pass else 1) * _band_ints(H, W, cluster) * 4 <= _SMEM_LIMIT)


def resized_packed(N: int) -> bool:
    """Whether K2's and K3's cluster kernels keep two int16 counts in each
    word of their bands for windows of N events (no count can pass int16;
    two CTAs of 512 threads per SM), rather than one int32 count (one CTA
    of 1,024)."""
    return N <= _MAX_EVENTS


def _resized_band_words(H: int, W: int, cluster: int, packed: bool) -> int:
    # K3's band array, whole int4s
    if packed:
        return _round4((band_rows(H, cluster) * W + 1) // 2)
    return _band_ints(H, W, cluster)


def _resized_halo_words(W: int, packed: bool) -> int:
    # K3's copy of the next band's first row
    return (W + 1) // 2 if packed else W


def _scaled_band_words(H: int, W: int, cluster: int, packed: bool) -> int:
    # K2's band array: its cells from K1's output alignment (up to 3 slots)
    # on, whole int4s
    if packed:
        return _round4((band_rows(H, cluster) * W + 4) // 2)
    return _band_ints(H, W, cluster)


def _events_cap(band_words) -> int:
    """The most events per window whose list of the cells with |count| >= 64
    (at most N / 64) fits beside ``band_words(packed)`` words of a block's
    shared memory, -1 where not even a list of 4 fits.  Up to 32,767
    events the band is packed, so the cap is the int32 band's where that
    passes 32,767, else the packed band's, at most 32,767
    (``csrc/voxelizer.cu``'s ``events_cap``)."""

    def cap_of(packed: bool) -> int:
        n_list = (_SMEM_LIMIT // 4 - band_words(packed)) // 4 * 4  # C's left & ~3
        return n_list * _K_TABLE - 1 if n_list >= 4 else -1

    wide = cap_of(False)
    return wide if wide > _MAX_EVENTS else min(_MAX_EVENTS, cap_of(True))


def resized_cluster_cap(H: int, W: int, h_out: int, w_out: int,
                        cluster: int = K3_CLUSTER) -> int:
    """The most events per window K3's cluster kernel takes at H x W ->
    h_out x w_out: what the band, the taps and a row leave of a block's
    shared memory for the window's list (``_events_cap``).  The rule of
    ``csrc/voxelizer.cu``'s ``resized_cluster_cap`` (its entry point
    ``evfly_hist_resized_cluster_cap``)."""
    if min(H, W, h_out, w_out) < 1 or not 1 <= cluster <= _MAX_CLUSTER:
        return -1
    return _events_cap(lambda packed: _resized_band_words(H, W, cluster, packed)
                       + 4 * (h_out + w_out) + _resized_halo_words(W, packed))


def scaled_cluster_cap(H: int, W: int, cluster: int = K2_CLUSTER) -> int:
    """The most events per window K2's cluster kernel takes at H x W: what
    the band leaves of a block's shared memory for the window's list
    (``_events_cap``).  The rule of ``csrc/voxelizer.cu``'s
    ``scaled_cluster_cap`` (its entry point ``evfly_hist_scaled_cluster_cap``)."""
    if min(H, W) < 1 or not 1 <= cluster <= _MAX_CLUSTER:
        return -1
    return _events_cap(lambda packed: _scaled_band_words(H, W, cluster, packed))


def _large_capacity(N: int) -> int:
    return _round4(N // _K_TABLE + 1)


def resized_cluster_smem(N: int, H: int, W: int, h_out: int, w_out: int,
                         cluster: int = K3_CLUSTER) -> int:
    """Dynamic shared memory of one CTA of K3's cluster kernel, bytes: the
    band (packed up to 32,767 events), the window's list, the taps and the
    next band's first row."""
    packed = resized_packed(N)
    return (_resized_band_words(H, W, cluster, packed) + _large_capacity(N)
            + 4 * (h_out + w_out) + _resized_halo_words(W, packed)) * 4


def scaled_cluster_smem(N: int, H: int, W: int, cluster: int = K2_CLUSTER) -> int:
    """Dynamic shared memory of one CTA of K2's cluster kernel, bytes: the
    band (packed up to 32,767 events) and the window's list."""
    return (_scaled_band_words(H, W, cluster, resized_packed(N)) + _large_capacity(N)) * 4


def scale_slice_slots(HW: int, cluster: int = SCALE_CLUSTER) -> int:
    """Slots of a window's counts each CTA of ``scale_counts``' cluster kernel
    takes: a multiple of 4, from the window's first cell's word offset mod 4
    on (``csrc/voxelizer.cu``'s ``scale_slice_slots``)."""
    return _round4(-(-(HW + 3) // cluster))


def scale_slice_cached(HW: int, cluster: int = SCALE_CLUSTER) -> bool:
    """Whether a CTA of ``scale_counts``' frame kernel keeps its slice of the
    counts in shared memory (else it reads them again from L2 to write)."""
    return scale_slice_slots(HW, cluster) * 4 <= _SCALE_SMEM_LIMIT


class K1Route(NamedTuple):
    """K1's route for a frame: ``kind`` "cluster" with ``cluster`` CTAs per
    window (``hist_frame_cluster``), or "band" with ``cluster`` 0
    (``hist_frame``)."""
    kind: str
    cluster: int

    def __str__(self) -> str:
        return f"cluster{self.cluster}" if self.kind == "cluster" else self.kind


BAND_ROUTE = K1Route("band", 0)


def k1_route(H: int, W: int, two_pass: bool) -> K1Route:
    """K1's route for an H x W frame: the cluster kernel on K1_CLUSTER CTAs
    per window where their bands fit, else on K1_WIDE_CLUSTER where those
    do, else the band route.  Decided by shape alone, before any launch.
    The rule of ``csrc/voxelizer.cu``'s ``frame_cluster_route`` (its entry
    point ``evfly_hist_frame_route``)."""
    for cluster in (K1_CLUSTER, K1_WIDE_CLUSTER):
        if frame_cluster_fits(H, W, two_pass, cluster):
            return K1Route("cluster", cluster)
    return BAND_ROUTE


def band_route_cells(H: int, W: int, two_pass: bool) -> int:
    """Cells of each band of K1's band route at H x W: 8,192 int32 counts
    (4,096 cells with two thresholds), at most the frame rounded up to 4,
    wider where the frame would have more than 8,192 bands; -1 where such a
    band passes a block's shared memory or a key (2 * cell + sign) passes
    int32.  The rule of ``csrc/voxelizer.cu``'s ``band_route_cells`` (its
    entry point ``evfly_hist_band_cells``)."""
    HW = H * W
    if H < 1 or W < 1 or HW >= 2 ** 30:
        return -1
    arrays = 2 if two_pass else 1
    cells = max(min(_BAND_INTS // arrays, _round4(HW)), _round4(-(-HW // _MAX_BANDS)))
    return cells if arrays * cells * 4 <= _SMEM_LIMIT else -1


def band_count(H: int, W: int, band_cells: int) -> int:
    """Bands of an H x W frame of ``band_cells`` cells each."""
    return -(-(H * W) // band_cells)


class BandLayout(NamedTuple):
    """The band route's chunks of T windows (``band_route_layout``)."""
    chunk_end: torch.Tensor  # (T,) int64, running total of the windows' chunks
    key_base: torch.Tensor   # (T,) int64, running total of their lengths before b
    n_keys: int              # the sum of the lengths: the key scratch's ints
    chunks: int              # the count of chunks: the partition pass's blocks


def _layout_sums(begin: torch.Tensor, end: torch.Tensor):
    lengths = (end - begin).clamp_min(0)
    chunk_end = torch.cumsum(-(-lengths // _BAND_CHUNK), 0)
    key_total = torch.cumsum(lengths, 0)
    return chunk_end, key_total - lengths, key_total


def band_route_layout(begin: torch.Tensor, end: torch.Tensor) -> BandLayout:
    """The band route's chunks of T windows [begin[b], end[b]): the
    windows' chunks of _BAND_CHUNK events (the partition pass's blocks, in
    window order) and where each window's keys start in the key scratch;
    the two totals read to the host (one synchronization)."""
    chunk_end, key_base, key_total = _layout_sums(begin, end)
    if begin.numel() == 0:
        return BandLayout(chunk_end, key_base, 0, 0)
    n_keys, chunks = torch.stack([key_total[-1], chunk_end[-1]]).tolist()
    return BandLayout(chunk_end, key_base, n_keys, chunks)


def scaled_route(N: int, H: int, W: int, resize: Optional[Tuple[int, int]] = None) -> str:
    """The route of a batch of N events per window at H x W through the
    scaled entry points: "cluster" up to the cluster kernel's cap, K2's
    (``scaled_cluster_cap``, ``resize`` None) or K3's
    (``resized_cluster_cap``, ``resize`` its (h_out, w_out)), else "k1"
    (K1's counts, then ``scale_counts`` or ``scale_counts_resized``).
    Decided by shape alone, before any launch."""
    if resize is not None:
        return "cluster" if N <= resized_cluster_cap(H, W, *resize) else "k1"
    return "cluster" if N <= scaled_cluster_cap(H, W) else "k1"


def _band_scratch(device, n_keys: int, chunks: int, H: int, W: int, two_pass: bool):
    """The band route's scratch on ``device`` (allocated on the current
    stream): keys (n_keys,) int32, one per event of each window, and the
    table (chunks, bands + 1) int32 of the bands' runs in each chunk; raises
    where the route has no band for the frame."""
    band_cells = band_route_cells(H, W, two_pass)
    if band_cells < 0:
        raise ValueError(f"K1's band route: no band of a {H}x{W} frame fits a block")
    table = torch.empty(chunks, band_count(H, W, band_cells) + 1, dtype=torch.int32,
                        device=device)
    return torch.empty(n_keys, dtype=torch.int32, device=device), table


def hist_frame(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    pos_thresh: float = 0.2, neg_thresh: float = 0.2,
) -> torch.Tensor:
    """K1's band route, for the frames no cluster holds: (B, N) events, any
    N -> (B, H, W) frame ``thresh * counts`` (``pos * pos_counts - neg *
    neg_counts`` when the thresholds differ).  A partition pass sorts each
    window's binned events by band of the frame, one block per chunk of
    4,096 events; a band pass counts each (window, band) from its band's
    keys alone (``csrc/voxelizer.cu``), so every event is read once.

    CPU tensors take ``hist_frame_plain``; CUDA tensors launch the kernels
    or raise.  ``hist_frame.launches`` counts the launches (one per call:
    both passes).
    """
    if x.device.type == "cpu":
        return hist_frame_plain(x, y, pol, H, W, pos_thresh, neg_thresh)
    xc, yc, pc = _kernel_events("hist_frame", x, y, pol)
    B, N = xc.shape
    two_pass = pos_thresh != neg_thresh
    if B >= 2 ** 31 or B * -(-N // _BAND_CHUNK) >= 2 ** 31:
        raise ValueError(f"hist_frame: {B} windows of {N} events pass the launch's grid")
    keys, table = _band_scratch(x.device, B * N, B * -(-N // _BAND_CHUNK), H, W, two_pass)
    out = torch.empty(B, H, W, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = _build.library().evfly_hist_frame(
            xc.data_ptr(), yc.data_ptr(), pc.data_ptr(), keys.data_ptr(), table.data_ptr(),
            out.data_ptr(), B, N, H, W, _BAND_CHUNK, pos_thresh, neg_thresh, int(two_pass),
            _build.stream_of(x.device),
        )
    _build.check("evfly_hist_frame", status)
    hist_frame.launches += 1
    return out


hist_frame.launches = 0


def _frame_cluster_launch(x, y, pol, H: int, W: int, pos_thresh: float, neg_thresh: float,
                          cluster: int) -> torch.Tensor:
    """Launch K1's cluster kernel on clusters of ``cluster`` CTAs; raises
    where they do not hold the frame."""
    xc, yc, pc = _kernel_events("hist_frame_cluster", x, y, pol)
    B, N = xc.shape
    two_pass = pos_thresh != neg_thresh
    if not frame_cluster_fits(H, W, two_pass, cluster):
        raise ValueError(f"hist_frame_cluster: {cluster} CTAs do not hold a {H}x{W} frame "
                         f"(two_pass={two_pass}); hist_frame takes it")
    if B * cluster >= 2 ** 31:
        raise ValueError(f"hist_frame_cluster: {B} windows x {cluster} CTAs pass grid.x")
    out = torch.empty(B, H, W, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = _build.library().evfly_hist_frame_cluster(
            xc.data_ptr(), yc.data_ptr(), pc.data_ptr(), out.data_ptr(), B, N, H, W, cluster,
            pos_thresh, neg_thresh, int(two_pass), _build.stream_of(x.device),
        )
    _build.check("evfly_hist_frame_cluster", status)
    return out


def hist_frame_cluster(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    pos_thresh: float = 0.2, neg_thresh: float = 0.2,
) -> torch.Tensor:
    """K1's cluster kernel: ``hist_frame``'s function with one cluster per
    window of ``k1_route``'s CTAs (8, or 16 where 8 do not hold the frame),
    the frame in row bands across their shared memory; raises where no
    cluster holds the frame.

    CPU tensors take ``hist_frame_plain``; CUDA tensors launch the kernel or
    raise.  ``hist_frame_cluster.launches`` counts the launches,
    ``hist_frame_cluster.by_route`` them by route ("cluster8",
    "cluster16").
    """
    if x.device.type == "cpu":
        return hist_frame_plain(x, y, pol, H, W, pos_thresh, neg_thresh)
    route = k1_route(H, W, pos_thresh != neg_thresh)
    if route.kind != "cluster":
        raise ValueError(f"hist_frame_cluster: no cluster holds a {H}x{W} frame "
                         f"(two_pass={pos_thresh != neg_thresh}); hist_frame takes it")
    out = _frame_cluster_launch(x, y, pol, H, W, pos_thresh, neg_thresh, route.cluster)
    hist_frame_cluster.launches += 1
    hist_frame_cluster.by_route[str(route)] += 1
    return out


hist_frame_cluster.launches = 0
hist_frame_cluster.by_route = collections.Counter()


def hist_frame_routed(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    pos_thresh: float = 0.2, neg_thresh: float = 0.2,
) -> torch.Tensor:
    """K1 for (B, N) events on ``k1_route``'s route: ``hist_frame_cluster``
    (8 or 16 CTAs) or ``hist_frame`` (the band route)."""
    if k1_route(H, W, pos_thresh != neg_thresh).kind == "cluster":
        return hist_frame_cluster(x, y, pol, H, W, pos_thresh, neg_thresh)
    return hist_frame(x, y, pol, H, W, pos_thresh, neg_thresh)


def hist_frame_windows_plain(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, begin: torch.Tensor,
    end: torch.Tensor, H: int, W: int, pos_thresh: float = 0.2, neg_thresh: float = 0.2,
) -> torch.Tensor:
    """Plain PyTorch version of K1 over time windows: (N,) events of one
    stream and (T,) int64 offsets -> (T, H, W) frames, window b the events
    [begin[b], end[b]) (none where end <= begin).  One ``index_add_`` over
    (window, cell) keys, each event repeated once per window that holds it
    (``repeat_interleave``), so windows may overlap."""
    T = begin.shape[0]
    dev = x.device
    lengths = (end - begin).clamp_min(0)
    total = int(lengths.sum().item())
    win = torch.repeat_interleave(torch.arange(T, device=dev), lengths, output_size=total)
    first = torch.repeat_interleave(torch.cumsum(lengths, 0) - lengths - begin, lengths,
                                    output_size=total)
    idx = torch.arange(total, device=dev) - first
    xi, yi, sign = bin_events(x[idx], y[idx], pol[idx], H, W)
    key = win * (H * W) + yi * W + xi
    zeros = torch.zeros(T * H * W, dtype=torch.float32, device=dev)
    if pos_thresh == neg_thresh:
        return (pos_thresh * zeros.index_add_(0, key, sign)).reshape(T, H, W)
    pos_counts = zeros.clone().index_add_(0, key, sign.clamp_min(0.0))
    neg_counts = zeros.index_add_(0, key, (-sign).clamp_min(0.0))
    return fused_two_pass(pos_counts, neg_counts, pos_thresh, neg_thresh).reshape(T, H, W)


def fused_two_pass(pos_counts: torch.Tensor, neg_counts: torch.Tensor, pos_thresh: float,
                   neg_thresh: float) -> torch.Tensor:
    """fma(pos, pos_counts, -(neg * neg_counts)) in f32: the two-threshold
    frame of the JAX package's ``event_frames_from_windows``, whose
    compiler contracts ``pos * pos_counts - neg * neg_counts`` into one FMA
    inside its lax.map (its ``event_histogram`` rounds both products).  In
    f64 the product of the f32 threshold and a count below 2^29 is exact,
    and so is its difference with the rounded f32 product at the magnitudes
    of a count frame, so one rounding to f32 gives the FMA's value."""
    pos64 = torch.tensor(pos_thresh, dtype=torch.float32).to(torch.float64)
    neg = (neg_thresh * neg_counts).to(torch.float64)
    return (pos64 * pos_counts.to(torch.float64) - neg).to(torch.float32)


def _window_events(x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, begin: torch.Tensor,
                   end: torch.Tensor):
    """The events and offsets as K1's window launch takes them: (N,) f32 x,
    y and int32 pol and (T,) int64 begin, end, contiguous on one CUDA
    device, N below 2^31; raises on anything else."""
    name = "hist_frame_windows"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 1 or y.shape != x.shape or pol.shape != x.shape:
        raise ValueError(f"{name}: x, y, pol must share one (N,) shape, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(pol.shape)}")
    if begin.dim() != 1 or end.shape != begin.shape:
        raise ValueError(f"{name}: begin and end must share one (T,) shape, got "
                         f"{tuple(begin.shape)}, {tuple(end.shape)}")
    if any(t.device != x.device for t in (y, pol, begin, end)):
        raise ValueError(f"{name}: events and offsets must be on one device")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: {x.shape[0]} events; the kernels index fewer than 2^31")
    pc = pol if pol.dtype == torch.int32 else torch.where(
        pol > 0, 1, torch.where(pol < 0, -1, 0)).to(torch.int32)
    return (x.to(torch.float32).contiguous(), y.to(torch.float32).contiguous(),
            pc.contiguous(), begin.to(torch.int64).contiguous(),
            end.to(torch.int64).contiguous())


def _frame_windows_launch(x, y, pol, begin, end, H: int, W: int, pos_thresh: float,
                          neg_thresh: float, route: Optional[K1Route] = None,
                          layout: Optional[BandLayout] = None) -> torch.Tensor:
    """One launch of K1 over the T windows [begin[b], end[b]) of a stream,
    on ``route`` (by default ``k1_route``'s): the cluster kernel on
    ``route.cluster`` CTAs per window, or the band route, its scratch sized
    by ``layout`` (by default ``band_route_layout``'s, one read to the
    host).  The offsets must lie in [0, N]; ``hist_frame_windows`` checks
    them."""
    x, y, pol, begin, end = _window_events(x, y, pol, begin, end)
    T = begin.shape[0]
    two_pass = pos_thresh != neg_thresh
    if route is None:
        route = k1_route(H, W, two_pass)
    lib = _build.library()
    events = (x.data_ptr(), y.data_ptr(), pol.data_ptr(), begin.data_ptr(), end.data_ptr())
    with torch.cuda.device(x.device):
        if route.kind == "cluster":
            if T * route.cluster >= 2 ** 31:
                raise ValueError(f"hist_frame_windows: {T} windows x {route.cluster} CTAs pass "
                                 f"grid.x")
            out = torch.empty(T, H, W, dtype=torch.float32, device=x.device)
            name = "evfly_hist_frame_cluster_windows"
            status = lib.evfly_hist_frame_cluster_windows(
                *events, out.data_ptr(), T, H, W, route.cluster, pos_thresh, neg_thresh,
                int(two_pass), _build.stream_of(x.device))
        else:
            chunk_end, key_base, n_keys, chunks = layout or band_route_layout(begin, end)
            if chunks >= 2 ** 31:
                raise ValueError(f"hist_frame_windows: {chunks} chunks of events pass grid.x")
            keys, table = _band_scratch(x.device, n_keys, chunks, H, W, two_pass)
            out = torch.empty(T, H, W, dtype=torch.float32, device=x.device)
            name = "evfly_hist_frame_windows"
            status = lib.evfly_hist_frame_windows(
                *events, chunk_end.data_ptr(), key_base.data_ptr(), keys.data_ptr(),
                table.data_ptr(), out.data_ptr(), T, chunks, H, W, _BAND_CHUNK, pos_thresh,
                neg_thresh, int(two_pass), _build.stream_of(x.device))
    _build.check(name, status)
    return out


def hist_frame_windows(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, begin: torch.Tensor,
    end: torch.Tensor, H: int, W: int, pos_thresh: float = 0.2, neg_thresh: float = 0.2,
) -> torch.Tensor:
    """K1 over time windows: (N,) events of one stream and (T,) int64
    offsets -> (T, H, W) frames, window b the events [begin[b], end[b])
    (none where end <= begin; windows may overlap and come in any order),
    in one launch for all T windows on ``k1_route``'s route: the cluster
    kernel on 8 or 16 CTAs, or the band route for frames no cluster holds.
    Each frame is ``hist_frame``'s of its window's events, except that two
    thresholds give ``fused_two_pass``'s value, as the JAX package's
    ``event_frames_from_windows``.

    CPU tensors take ``hist_frame_windows_plain``; CUDA tensors launch the
    kernel or raise.  The offsets are checked to lie in [0, N] before the
    launch, in one read to the host with the band route's layout.
    ``hist_frame_windows.launches`` counts the launches,
    ``hist_frame_windows.by_route`` them by route ("cluster8", "cluster16",
    "band").
    """
    if x.device.type == "cpu":
        return hist_frame_windows_plain(x, y, pol, begin, end, H, W, pos_thresh, neg_thresh)
    route = k1_route(H, W, pos_thresh != neg_thresh)
    layout = None
    if begin.numel():
        lo, hi = torch.aminmax(torch.stack([begin, end]).to(torch.int64))
        sums = [lo, hi]
        if route.kind == "band":
            chunk_end, key_base, key_total = _layout_sums(begin.to(torch.int64),
                                                          end.to(torch.int64))
            sums += [key_total[-1], chunk_end[-1]]
        sums = torch.stack(sums).tolist()
        if sums[0] < 0 or sums[1] > x.shape[0]:
            raise ValueError(f"hist_frame_windows: offsets must lie in [0, {x.shape[0]}], "
                             f"got [{sums[0]}, {sums[1]}]")
        if route.kind == "band":
            layout = BandLayout(chunk_end, key_base, *sums[2:])
    out = _frame_windows_launch(x, y, pol, begin, end, H, W, pos_thresh, neg_thresh, route,
                                layout)
    hist_frame_windows.launches += 1
    hist_frame_windows.by_route[str(route)] += 1
    return out


hist_frame_windows.launches = 0
hist_frame_windows.by_route = collections.Counter()


def _scaled_cluster_launch(x, y, pol, H: int, W: int, thresh: float, q: float, iters: int,
                           cluster: int):
    """Launch K2's cluster kernel on clusters of ``cluster`` CTAs; raises
    above its cap.  Returns (frame, q)."""
    xc, yc, pc = _kernel_events("hist_scaled", x, y, pol)
    B, N = xc.shape
    cap = scaled_cluster_cap(H, W, cluster)
    if N > cap:
        raise ValueError(
            f"hist_scaled: {N} events per window at {H}x{W} exceed the cap of {cap} on "
            f"{cluster} CTAs; event_histogram_scaled takes any number")
    if B * cluster >= 2 ** 31:
        raise ValueError(f"hist_scaled: {B} windows x {cluster} CTAs pass grid.x")
    out = torch.empty(B, H, W, dtype=torch.float32, device=x.device)
    qout = torch.empty(B, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = _build.library().evfly_hist_scaled_cluster(
            xc.data_ptr(), yc.data_ptr(), pc.data_ptr(), out.data_ptr(), qout.data_ptr(),
            B, N, H, W, cluster, _kth(q, H * W), thresh, iters, _build.stream_of(x.device),
        )
    _build.check("evfly_hist_scaled_cluster", status)
    return out, qout


def hist_scaled(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    thresh: float = 0.2, q: float = 0.97, iters: int = 18,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (B, N) events, N <= ``scaled_cluster_cap(H, W)`` -> ((B, H, W)
    clipped frame, (B,) quantile), one cluster of ``K2_CLUSTER`` CTAs per
    window with the count frame in row bands across their shared memory
    (two int16 counts a word up to 32,767 events, ``resized_packed``; int32
    above).

    CPU tensors take ``hist_scaled_plain``; CUDA tensors launch the kernel
    or raise.  ``hist_scaled.launches`` counts the launches.
    """
    if x.device.type == "cpu":
        return hist_scaled_plain(x, y, pol, H, W, thresh, q, iters)
    res = _scaled_cluster_launch(x, y, pol, H, W, thresh, q, iters, K2_CLUSTER)
    hist_scaled.launches += 1
    return res


hist_scaled.launches = 0


def _resized_cluster_launch(x, y, pol, H: int, W: int, h_out: int, w_out: int, thresh: float,
                            q: float, iters: int, align_corners: bool, cluster: int):
    """Launch K3's cluster kernel on clusters of ``cluster`` CTAs; raises
    above its cap.  Returns (out, q)."""
    xc, yc, pc = _kernel_events("hist_scaled_resized", x, y, pol)
    B, N = xc.shape
    cap = resized_cluster_cap(H, W, h_out, w_out, cluster)
    if N > cap:
        raise ValueError(
            f"hist_scaled_resized: {N} events per window at {H}x{W} -> "
            f"{h_out}x{w_out} exceed the cap of {cap} on {cluster} CTAs; "
            f"event_histogram_scaled_resized takes any number")
    if B * cluster >= 2 ** 31:
        raise ValueError(f"hist_scaled_resized: {B} windows x {cluster} CTAs pass grid.x")
    taps, _, _ = _resize_operators(H, W, h_out, w_out, align_corners, x.device)
    out = torch.empty(B, h_out, w_out, dtype=torch.float32, device=x.device)
    qout = torch.empty(B, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = _build.library().evfly_hist_scaled_resized_cluster(
            xc.data_ptr(), yc.data_ptr(), pc.data_ptr(), taps.data_ptr(), out.data_ptr(),
            qout.data_ptr(), B, N, H, W, h_out, w_out, cluster, _kth(q, H * W), thresh, iters,
            _build.stream_of(x.device),
        )
    _build.check("evfly_hist_scaled_resized_cluster", status)
    return out, qout


def hist_scaled_resized(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    h_out: int, w_out: int, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
    align_corners: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (B, N) events, N <= ``resized_cluster_cap(H, W, h_out, w_out)``
    -> ((B, h_out, w_out) input, (B,) quantile), one cluster of
    ``K3_CLUSTER`` CTAs per window with the count frame in row bands across
    their shared memory (two int16 counts a word up to 32,767 events,
    ``resized_packed``; int32 above).

    CPU tensors take ``hist_scaled_resized_plain``; CUDA tensors launch the
    kernel or raise.  ``hist_scaled_resized.launches`` counts the launches.
    """
    if x.device.type == "cpu":
        return hist_scaled_resized_plain(
            x, y, pol, H, W, h_out, w_out, thresh, q, iters, align_corners
        )
    res = _resized_cluster_launch(x, y, pol, H, W, h_out, w_out, thresh, q, iters,
                                  align_corners, K3_CLUSTER)
    hist_scaled_resized.launches += 1
    return res


hist_scaled_resized.launches = 0


def cluster_occupancy(kernel: str, H: int, W: int, N: int = 0,
                      out_hw: Tuple[int, int] = (1, 1), cluster: Optional[int] = None) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a cluster kernel on the current
    device: ``kernel`` "k1" (one count array), "k1_two_pass", "k3" (with N
    events per window and an ``out_hw`` output) or "k2" (with N events per
    window); ``cluster`` CTAs each (the kernel's own by default)."""
    kind = {"k1": 0, "k1_two_pass": 1, "k3": 2, "k2": 3}[kernel]
    if cluster is None:
        cluster = {2: K3_CLUSTER, 3: K2_CLUSTER}.get(kind, K1_CLUSTER)
    n = ctypes.c_int(0)
    status = _build.library().evfly_hist_cluster_occupancy(kind, H, W, N, *out_hw, cluster,
                                                           ctypes.byref(n))
    _build.check("evfly_hist_cluster_occupancy", status)
    return n.value


def _scale_launch(name: str, counts: torch.Tensor, thresh: float, q: float, iters: int,
                  resize: Optional[Tuple[int, int, bool]], cluster: int = SCALE_CLUSTER):
    """Launch ``scale_counts_cluster_kernel`` on (B, H, W) counts on CUDA,
    one cluster of ``cluster`` CTAs per window; ``resize`` (h_out, w_out,
    align_corners) or None.  Returns (out, q)."""
    if counts.device.type != "cuda" or counts.dim() != 3:
        raise ValueError(f"{name}: expected (B, H, W) counts on CUDA, got "
                         f"{tuple(counts.shape)} on {counts.device}")
    if not 1 <= cluster <= _MAX_CLUSTER:
        raise ValueError(f"{name}: clusters of {cluster} CTAs (1 to {_MAX_CLUSTER})")
    cc = counts.to(torch.float32).contiguous()
    if cc.data_ptr() % 16:  # the kernel reads whole 16-byte groups
        cc = cc.clone()
    B, H, W = cc.shape
    if B * cluster >= 2 ** 31:
        raise ValueError(f"{name}: {B} windows x {cluster} CTAs pass grid.x")
    h_out, w_out, align_corners = resize if resize is not None else (H, W, False)
    taps = cc  # not read without a resize
    if resize is not None:
        taps, _, _ = _resize_operators(H, W, h_out, w_out, align_corners, cc.device)
    out = torch.empty(B, h_out, w_out, dtype=torch.float32, device=cc.device)
    qout = torch.empty(B, dtype=torch.float32, device=cc.device)
    # each CTA's list of the |count| >= 64 of its slice: no count is
    # bounded, so up to every cell of the window
    lists = torch.empty(B, H, W, dtype=torch.int32, device=cc.device)
    with torch.cuda.device(cc.device):
        status = _build.library().evfly_scale_counts(
            cc.data_ptr(), taps.data_ptr(), out.data_ptr(), qout.data_ptr(), lists.data_ptr(),
            B, H, W, h_out, w_out, cluster, _kth(q, H * W), thresh, iters,
            int(resize is not None), _build.stream_of(cc.device),
        )
    _build.check(name, status)
    return out, qout


def scale_counts(
    counts: torch.Tensor, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function over a (B, H, W) f32 count frame of exact integers (K1's
    with thresholds 1), for windows K2 cannot take: ((B, H, W) clipped frame,
    (B,) quantile), the quantile the plain version's bit for bit.  One
    cluster of ``SCALE_CLUSTER`` CTAs per window reads the counts once.

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
    if scaled_route(x.shape[1], H, W) == "cluster":
        return hist_scaled(x, y, pol, H, W, thresh, q, iters)
    return scale_counts(hist_frame_routed(x, y, pol, H, W, 1.0, 1.0), thresh, q, iters)


def hist_scaled_resized_routed(
    x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor, H: int, W: int,
    h_out: int, w_out: int, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
    align_corners: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(input, quantile) of ``event_histogram_scaled_resized`` for (B, N)
    events, by ``scaled_route(N, H, W, (h_out, w_out))``: K3
    (``hist_scaled_resized``), or K1's counts and ``scale_counts_resized``."""
    if scaled_route(x.shape[1], H, W, (h_out, w_out)) == "cluster":
        return hist_scaled_resized(x, y, pol, H, W, h_out, w_out, thresh, q, iters,
                                   align_corners)
    return scale_counts_resized(hist_frame_routed(x, y, pol, H, W, 1.0, 1.0), h_out, w_out,
                                thresh, q, iters, align_corners)


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
    (CUDA unless the caller names another), through kernel K1 on CUDA
    (``hist_frame_routed``).
    """
    x, y, pol, single = _device_events(x, y, pol, device)
    frame = hist_frame_routed(x, y, pol, H, W, pos_thresh, neg_thresh)
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


def window_offsets(t: torch.Tensor, window_starts: torch.Tensor, window_ends: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, begin, end): the stable sort of f32 times ``t`` and each
    window's [begin, end) in the sorted stream, by ``searchsorted`` (left
    for both edges), which is exactly ``t >= t0 & t < t1``.  NaN times sort
    last and lie in no window; a window with a NaN edge is empty."""
    t = t.to(torch.float32)
    t0 = window_starts.to(torch.float32)
    t1 = window_ends.to(torch.float32)
    ts, order = torch.sort(t, stable=True)
    # searchsorted may place a finite edge past the NaNs sorted last
    finite = (~torch.isnan(ts)).sum()
    begin = torch.minimum(torch.searchsorted(ts, t0, side="left"), finite)
    end = torch.minimum(torch.searchsorted(ts, t1, side="left"), finite)
    end = torch.where(torch.isnan(t0) | torch.isnan(t1), begin, end)
    return order, begin, end


def event_frames_from_windows(
    t, x, y, pol, window_starts, window_ends, H: int, W: int, pos_thresh: float = 0.2,
    neg_thresh: float = 0.2, device: DeviceLike = None,
) -> torch.Tensor:
    """Voxelize many time windows of one event stream -> (T, H, W) frames,
    as the JAX package's ``event_frames_from_windows``: frame b is
    ``event_histogram`` of the events with ``window_starts[b] <= t <
    window_ends[b]``, compared in f32 (the reference's per-inter-frame
    slicing, to_events.py:398-412); with two thresholds each cell is
    ``fused_two_pass``'s value, as the JAX function computes it.  The events may come in any order and
    the windows may overlap, come in any order or be empty.

    Where the JAX package masks the whole stream once per window (T x N
    work), the port sorts the stream by its f32 time once (stable), finds
    each window's run of events by ``searchsorted`` (``window_offsets``),
    and bins all T windows in one launch of K1 (``hist_frame_windows``),
    each event read once per window holding it.  Runs on ``device`` (CUDA
    unless the caller names another).
    """
    dev = resolve_device(device)
    t, x, y, pol, t0, t1 = (torch.as_tensor(v, device=dev) for v in
                            (t, x, y, pol, window_starts, window_ends))
    order, begin, end = window_offsets(t, t0.reshape(-1), t1.reshape(-1))
    return hist_frame_windows(x[order], y[order], pol[order], begin, end, H, W, pos_thresh,
                              neg_thresh)


def difflog_events(
    im, prev_im, pos_thresh: float = 0.2, neg_thresh: float = 0.2, eps: float = 1e-5,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Difflog event approximation between intensity frames, as the JAX
    package's ``difflog_events`` (run_competition.py:603-635,
    to_events.py:419-439): difflog = log(im + eps) - log(prev + eps),
    quantized by the thresholds (floor division toward -inf), and zeroed
    wholly where max |difflog| < max(pos_thresh, neg_thresh).  (H, W) frames
    -> (H, W); a (B, H, W) batch of pairs -> (B, H, W), each pair zeroed on
    its own.  Elementwise torch ops on ``device`` (CUDA unless the caller
    names another)."""
    dev = resolve_device(device)
    im = torch.as_tensor(im, device=dev, dtype=torch.float32)
    prev_im = torch.as_tensor(prev_im, device=dev, dtype=torch.float32)
    difflog = torch.log(im + eps) - torch.log(prev_im + eps)
    pos = torch.floor(difflog / pos_thresh) * pos_thresh
    neg = torch.floor(difflog / -neg_thresh) * -neg_thresh
    zero = torch.zeros_like(difflog)
    ev = torch.where(difflog > 0.0, pos, torch.where(difflog < 0.0, neg, zero))
    peak = difflog.abs().amax(dim=(-2, -1), keepdim=True)
    return torch.where(peak >= max(pos_thresh, neg_thresh), ev, zero)


def difflog_margins(
    im, prev_im, pos_thresh: float = 0.2, neg_thresh: float = 0.2, eps: float = 1e-5,
    device: DeviceLike = None,
) -> torch.Tensor:
    """For each pixel of ``difflog_events``, the distance of the quotient
    its floor takes (difflog / pos_thresh, or difflog / -neg_thresh) from an
    integer, or, where it is less, the distance of the frame's max |difflog|
    / max(pos_thresh, neg_thresh) from 1 (the whole frame's zeroing).  Where
    it is small (below 1e-5, say), another implementation of ``log`` may
    give one quantum more or less, or zero the frame or not."""
    dev = resolve_device(device)
    im = torch.as_tensor(im, device=dev, dtype=torch.float32)
    prev_im = torch.as_tensor(prev_im, device=dev, dtype=torch.float32)
    difflog = torch.log(im + eps) - torch.log(prev_im + eps)
    q = torch.where(difflog >= 0, difflog / pos_thresh, difflog / -neg_thresh)
    peak = difflog.abs().amax(dim=(-2, -1), keepdim=True)
    frame = (peak / max(pos_thresh, neg_thresh) - 1.0).abs()
    return torch.minimum((q - torch.round(q)).abs(), frame)


def event_histogram_scaled(
    x, y, pol, H: int, W: int, thresh: float = 0.2, q: float = 0.97, iters: int = 18,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Events -> clip(frame / quantile(|frame|, q), +-1), the deployment
    input transform, as the JAX package's ``event_histogram_scaled``.

    One (N,) window -> (H, W); a (B, N) batch -> (B, H, W).  Any number
    of events.  Runs on ``device`` (CUDA unless the caller names another),
    through K2 on CUDA, or where K2 cannot take the batch (``scaled_route``:
    above ``scaled_cluster_cap``, 823,807 events per window at 260 x 346)
    through K1 and ``scale_counts`` (``hist_scaled_routed``).
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
    ``evfly_tpu_torch.set_precision``.  The span ``evfly.frame``
    (``utils.profiling``).
    """
    with profiling.span("evfly.frame"):
        dev = resolve_device(device)
        x, y, pol = (torch.as_tensor(v, device=dev) for v in (x, y, pol))
        if x.dim() != 2:
            raise ValueError(f"event_histogram_scaled_resized expects (B, N) events, got {tuple(x.shape)}")
        small, _ = hist_scaled_resized_routed(
            x, y, pol, H, W, h_out, w_out, thresh, q, iters, align_corners
        )
        return small


# a stacked histogram's padding events are counted into this many spare
# cells past the frame, spread so that their adds do not meet on one address
_STACKED_SPARE = 4096


def stacked_histogram(x, y, pol, t, n, bins: int, frame_hw: Tuple[int, int],
                      downsample: int = 2, clip: float = 10.0) -> torch.Tensor:
    """RVT's stacked histogram of one window of events -> (2 bins, H, W) f32.

    x, y (N,) integer sensor coordinates, pol (N,) (> 0 positive), t (N,)
    integer timestamps (microseconds); the first ``n`` events are real (an
    int, or a 0-d integer tensor on the events' device), the rest padding.
    A real event counts 1 into channel ``bins * [pol > 0] + tau`` at
    ``(y // downsample, x // downsample)``, where ``tau = min(floor(bins (t -
    t_first) / max(t_last - t_first, 1)), bins - 1)`` and t_first, t_last
    are the smallest and the largest real timestamp; events outside the
    frame count nothing; every count is clipped at ``clip``.  Integer
    arithmetic throughout, so that every device bins alike.  Plain torch
    ops on any device (``index_add_``), with no host synchronization, so a
    CUDA graph can capture it with ``n`` on the device."""
    H, W = frame_hw
    N = x.shape[0]
    dev = x.device
    cells = 2 * bins * H * W
    index = torch.arange(N, device=dev)
    real = index < torch.as_tensor(n, device=dev)
    t = t.to(torch.int64)
    t0 = torch.where(real, t, torch.iinfo(torch.int64).max).amin()
    t1 = torch.where(real, t, torch.iinfo(torch.int64).min).amax()
    tau = torch.div(bins * (t - t0), (t1 - t0).clamp_min(1), rounding_mode="floor")
    tau = tau.clamp(0, bins - 1)
    xs = torch.div(x.to(torch.int64), downsample, rounding_mode="floor")
    ys = torch.div(y.to(torch.int64), downsample, rounding_mode="floor")
    inside = real & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    cell = ((torch.where(pol > 0, bins, 0) + tau) * H + ys) * W + xs
    cell = torch.where(inside, cell, cells + index % _STACKED_SPARE)
    frame = torch.zeros(cells + _STACKED_SPARE, dtype=torch.float32, device=dev)
    frame.index_add_(0, cell, inside.to(torch.float32))
    return frame[:cells].view(2 * bins, H, W).clamp_(max=clip)


def voxel_grid(x, y, pol, t, n, rectify_map: torch.Tensor, bins: int) -> torch.Tensor:
    """E-RAFT's voxel grid of one window of events (``VoxelGrid`` with
    ``normalize=True``) -> (bins, H, W) f32, (H, W) the rectified frame.

    x, y (N,) integer sensor coordinates, pol (N,) (> 0 positive), t (N,)
    integer timestamps (microseconds); the first ``n`` events are real (an
    int, or a 0-d integer tensor on the events' device), the rest padding;
    events off the (H, W) sensor count as padding.  ``rectify_map`` (H, W, 2)
    f32 gives each sensor pixel's rectified (x, y).

    A real event at rectified (xr, yr), time ``tn = (bins - 1) u`` with ``u =
    f32(t - t_first) / f32(t_last - t_first)`` (0 where t_last = t_first;
    E-RAFT divides by zero there) and t_first, t_last the smallest and the
    largest real timestamp, adds to each of the 8 corners (xl, yl, tl) in
    {x0, x0 + 1} x {y0, y0 + 1} x {t0, t0 + 1} inside the grid, with x0, y0,
    t0 the values truncated toward zero (E-RAFT's ``.int()``: a coordinate in
    (-1, 0) splats with weights 0.7 and -0.3), ``(2 p - 1) (1 - |xl - xr|)
    (1 - |yl - yr|) (1 - |tl - tn|)``, multiplied in that order in f32.  Then
    over the n nonzero cells, mean m and unbiased standard deviation s: each
    nonzero cell becomes (v - m) / s where s > 0, else v - m (n <= 1
    included); zero cells stay 0.

    Departure: the contributions are summed in f64 and the statistics and the
    normalisation taken in f64, then rounded once to f32 (E-RAFT sums in
    f32).  The sums of a cell's f32 products are then exact, so a cell's
    value, and whether it is zero, does not depend on the order of the
    atomic adds.  Plain torch ops on any device (``index_add_``, masked
    sums), with no host synchronization, so a CUDA graph can capture it with
    ``n`` on the device."""
    H, W = rectify_map.shape[:2]
    N = x.shape[0]
    dev = x.device
    f32 = torch.float32
    index = torch.arange(N, device=dev)
    xi, yi = x.to(torch.int64), y.to(torch.int64)
    real = ((index < torch.as_tensor(n, device=dev)) & (xi >= 0) & (xi < W)
            & (yi >= 0) & (yi < H))
    t = t.to(torch.int64)
    t_first = torch.where(real, t, torch.iinfo(torch.int64).max).amin()
    t_last = torch.where(real, t, torch.iinfo(torch.int64).min).amax()
    span = t_last - t_first
    u = (t - t_first).to(f32) / span.to(f32)
    tn = (bins - 1) * torch.where(span > 0, u, 0.0)
    rect = rectify_map[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
    xr, yr = rect[:, 0], rect[:, 1]
    value = torch.where(pol > 0, 1.0, -1.0)
    # the 8 corners (x offset, y offset, t offset), t fastest
    corner = torch.arange(8, device=dev)
    xl = xr.to(torch.int64)[:, None] + (corner >> 2)
    yl = yr.to(torch.int64)[:, None] + ((corner >> 1) & 1)
    tl = tn.to(torch.int64)[:, None] + (corner & 1)
    w = (value[:, None] * (1 - (xl.to(f32) - xr[:, None]).abs())
         * (1 - (yl.to(f32) - yr[:, None]).abs()) * (1 - (tl.to(f32) - tn[:, None]).abs()))
    inside = (real[:, None] & (xl >= 0) & (xl < W) & (yl >= 0) & (yl < H)
              & (tl >= 0) & (tl < bins))
    cells = bins * H * W
    cell = torch.where(inside, (tl * H + yl) * W + xl,
                       cells + (8 * index[:, None] + corner) % _STACKED_SPARE)
    acc = torch.zeros(cells + _STACKED_SPARE, dtype=torch.float64, device=dev)
    acc.index_add_(0, cell.reshape(-1), torch.where(inside, w, 0.0).to(torch.float64).reshape(-1))
    return _normalise_nonzero(acc[:cells]).view(bins, H, W)


def _normalise_nonzero(v: torch.Tensor) -> torch.Tensor:
    """E-RAFT's normalisation of f64 cells v over the nonzero ones, by
    masked sums (no host synchronization), rounded to f32."""
    nonzero = v != 0
    count = nonzero.sum().to(torch.float64)
    mean = v.sum() / count
    centred = torch.where(nonzero, v - mean, 0.0)
    std = ((centred * centred).sum() / (count - 1)).sqrt()
    return torch.where(std > 0, centred / std, centred).to(torch.float32)
