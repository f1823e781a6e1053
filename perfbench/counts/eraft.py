"""Bytes and operations of E-RAFT's voxel grid, its correlation pyramid and
its lookups (the ``voxel``, ``corr`` and ``lookup`` classes of a streaming
step's least time), from the shapes and the events.

They count the work, not how the program does it: each input read once,
each output written once, so that a hand-written kernel later is judged by
the same yardstick.
"""

from __future__ import annotations

from typing import Tuple

EVENT_BYTES = 2 + 2 + 1 + 8  # x and y int16, the polarity int8, the timestamp int64
MAP_BYTES = 2 * 4            # a rectified (x, y) in f32


def voxel(events: int, bins: int = 15, H: int = 480, W: int = 640) -> Tuple[float, float]:
    """One window of ``events`` real events into a (bins, H, W) f32 grid:
    the events and their map entries read, the grid written once, then the
    normalisation's read and write of it; 8 corners of 4 multiplies an
    event, a subtraction and a division a cell."""
    cells = bins * H * W
    return (EVENT_BYTES + MAP_BYTES) * events + 3 * 4 * cells, 32 * events + 2 * cells


def corr(h: int = 60, w: int = 80, dim: int = 256, levels: int = 4) -> Tuple[float, float]:
    """The all-pairs correlation of two (dim, h, w) f32 maps and its pooled
    levels: both maps read, every level written; a multiply-add for each
    pair and channel."""
    n = h * w
    cells, lh, lw = 0, h, w
    for _ in range(levels):
        cells += n * lh * lw
        lh, lw = lh // 2, lw // 2
    return 4 * (2 * dim * n + cells), 2 * n * n * dim


def _spans(n: int, size: int, scale: int, radius: int) -> int:
    """Sum over the n positions of one axis of the integer window
    [floor(p / scale) - radius, floor(p / scale) + radius + 1] clipped to
    [0, size - 1]."""
    total = 0
    for p in range(n):
        c = p // scale
        lo, hi = max(c - radius, 0), min(c + radius + 1, size - 1)
        total += max(hi - lo + 1, 0)
    return total


def lookup(h: int = 60, w: int = 80, levels: int = 4, radius: int = 4) -> Tuple[float, float]:
    """One iteration's lookup at zero flow: at each level, each position's
    distinct (2 radius + 2)^2 window of the level around its centre, clipped
    to the level, read; ``levels (2 radius + 1)^2`` f32 values a position
    written; 4 multiply-adds a sample."""
    read, lh, lw = 0, h, w
    for i in range(levels):
        read += _spans(h, lh, 2 ** i, radius) * _spans(w, lw, 2 ** i, radius)
        lh, lw = lh // 2, lw // 2
    samples = h * w * levels * (2 * radius + 1) ** 2
    return 4 * (read + samples), 8 * samples
