"""Bytes and operations of RVT's stacked histogram (the ``hist`` class of a
streaming step's least time), from its shapes.

The events count as a window really holds them (not its padding), in the
types of the streaming step's buffers; the frame is written once.
"""

from __future__ import annotations

from typing import Tuple

EVENT_BYTES = 2 + 2 + 1 + 8  # x and y int16, the polarity int8, the timestamp int64


def hist(events: int, bins: int = 10, H: int = 384, W: int = 640) -> Tuple[float, float]:
    """One window of ``events`` real events into a (2 bins, H, W) f32
    frame: the events read, the frame written; one add per event."""
    return EVENT_BYTES * events + 4 * 2 * bins * H * W, events
