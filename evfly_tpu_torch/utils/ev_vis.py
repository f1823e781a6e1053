"""Event-frame visualization (utils/ev_utils.py:6-111 parity).

A copy of ``evfly_tpu/utils/ev_vis.py``.  Host-side numpy rendering of event frames for plots/gifs/debug imagery:
percentile scaledown + red/blue colorings (``simple_evim``), threshold
binning (``bin_evim``), and the darkened RGB view (``visualize_evim``).
"""

from __future__ import annotations

import numpy as np


def bin_evim(evim: np.ndarray, target_maxabs_value: float, pos_thresh=0.2, neg_thresh=0.2):
    binned = evim * target_maxabs_value
    pos = evim > 0
    neg = evim < 0
    binned[pos] = evim[pos] // pos_thresh
    binned[neg] = evim[neg] // neg_thresh
    return binned


def simple_evim(evframe, scaledown_percentile=100, style="gray"):
    evframe = np.asarray(evframe, np.float32)
    if scaledown_percentile is not None:
        if scaledown_percentile <= 1:
            scaledown_percentile *= 100.0
        factor = np.percentile(np.abs(evframe), scaledown_percentile)
        sc = np.clip(evframe / factor, -1.0, 1.0) if factor > 0 else evframe
    else:
        sc = evframe

    if style == "gray":
        rng = np.max(sc) - np.min(sc)
        arr = 255 * (sc - np.min(sc)) / (rng if rng > 0 else 1.0)
        return arr.astype(np.uint8), "8UC1"

    pos, neg = sc > 0, sc < 0
    if style == "redblue-on-black":
        arr = np.zeros((*sc.shape, 3))
        arr[pos, 0] = 255 * sc[pos]
        arr[neg, 2] = 255 * -sc[neg]
        return arr.astype(np.uint8), "rgb8"
    if style == "redblue-on-white":
        arr = np.ones((*sc.shape, 3)) * 255
        arr[pos, 0] = 255
        arr[pos, 1] = 255 - 255 * sc[pos]
        arr[pos, 2] = 255 - 255 * sc[pos]
        arr[neg, 0] = 255 - 255 * -sc[neg]
        arr[neg, 1] = 255 - 255 * -sc[neg]
        arr[neg, 2] = 255
        return arr.astype(np.uint8), "rgb8"
    raise ValueError(f"[simple_evim] style {style} not recognized")


def visualize_evim(evim, pos_thresh=0.2, neg_thresh=0.2, darken_factor=0.7):
    evim = np.asarray(evim, np.float32)
    frame = np.zeros((*evim.shape, 3))
    binned = bin_evim(evim.copy(), 1.0, pos_thresh, neg_thresh)
    maxabs = np.abs(binned).max()
    if maxabs == 0:
        return (frame * 255).astype(np.uint8)
    neg = binned < 0
    pos = binned > 0
    frame[neg, 0] = darken_factor + binned[neg] / maxabs * darken_factor
    frame[neg, 1] = darken_factor + binned[neg] / maxabs * darken_factor
    frame[pos, 1] = darken_factor - binned[pos] / maxabs * darken_factor
    frame[pos, 2] = darken_factor - binned[pos] / maxabs * darken_factor
    return (frame * 255.0).astype(np.uint8)
