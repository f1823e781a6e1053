"""Bytes and operations each kernel's work needs, from its shapes, and the
least time the card could take for it (the roofline's bound).

Inputs are counted once and outputs once, whatever a kernel reads again;
events count as what a window really holds, not its padding.  The formulas
are those of the port's kernel table (PERF.md), kept here so that the
yardstick does not move with the program.
"""

from __future__ import annotations

import json
import pathlib
from typing import Tuple

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent / "peaks.json").read_text())
EVENT_BYTES = 12  # x and y f32, the polarity int32


def least_s(n_bytes: float, n_flops: float, peaks: dict = PEAKS) -> float:
    """The larger of bytes over the HBM rate and f32 operations over the f32
    peak."""
    return max(n_bytes / peaks["hbm_bytes_per_s"], n_flops / peaks["f32_flops_per_s"])


def k1(events: int, H: int, W: int) -> Tuple[float, float]:
    """K1, one window of ``events`` real events into an (H, W) f32 frame:
    the events read, the frame written; one add per event and one scaling
    per cell."""
    return EVENT_BYTES * events + 4 * H * W, events + H * W


def k3(events: int, windows: int, H: int, W: int, h_out: int, w_out: int) -> Tuple[float, float]:
    """K3 over ``windows`` windows holding ``events`` real events in all:
    the events read, the (h_out, w_out) inputs and the quantiles written;
    one add per event, |count| and its table entry per cell, 4 scalings and
    6 resize operations per output."""
    n_bytes = EVENT_BYTES * events + 4 * windows * (h_out * w_out + 1)
    return n_bytes, events + 2 * windows * H * W + 10 * windows * h_out * w_out


def lstm(G: int, T: int, H: int, L: int) -> Tuple[float, float]:
    """K4 or K5 for G streams of T steps, L layers of hidden size H: the
    layer-0 gate inputs (G, T, 4H), the weights (L hidden-to-hidden and L - 1
    input-to-hidden (4H, H) blocks, L biases), the carried (h, c) read; the
    outputs (G, T, H) and the new (h, c) written; a multiply-add per weight
    per stream and step."""
    weights = (2 * L - 1) * 4 * H * H + L * 4 * H
    n_bytes = 4 * (G * T * 4 * H + weights + 2 * G * L * H) + 4 * (G * T * H + 2 * G * L * H)
    return n_bytes, 2 * G * T * H * 4 * H * (2 * L - 1)
