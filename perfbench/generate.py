"""The general traffic generator: what a traffic file's parameters describe,
made from the seed on the device in a few large calls.

* ``sizes``: events per window, log-uniform over [lo, hi]: the same set of
  ``count`` sizes for every seed (the law's quantiles at (i + 0.5) / count),
  in an order drawn from the seed.
* ``edge_events``: windows of events, a share on a few moving edges (a
  segment swept along a displacement over the window, with jitter), the
  rest uniform noise; polarity +-1 (an edge's own, flipped at a rate); each
  window padded with pol-0 events to the batch's longest.
* ``sparse_frames``: signed event frames as the simulator's difflog hands
  them over: multiples of the threshold at a density drawn per frame.
* ``reset_steps``: for each stream, the steps at which its recurrent state
  is reset, gaps uniform over [lo, hi].
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        int(rng(seed, stream).integers(0, 2 ** 62)))


def sizes(law: dict, count: int, seed: int, stream: int = 1) -> np.ndarray:
    lo, hi = law["lo"], law["hi"]
    q = (np.arange(count) + 0.5) / count
    s = np.round(lo * (hi / lo) ** q).astype(np.int64)
    return s[rng(seed, stream).permutation(count)]


def edge_events(n: Sequence[int], H: int, W: int, p: dict, gen: torch.Generator,
                device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, y, pol) of shape (B, max n) for windows of n[b] events."""
    B, N, E = len(n), int(max(n)), p["edges"]
    f32 = dict(dtype=torch.float32, device=device)
    scale = torch.tensor([W, H], **f32)
    ends = torch.rand(B, E, 2, 2, generator=gen, **f32) * scale
    motion = (torch.rand(B, E, 2, generator=gen, **f32) * 2 - 1) * p["motion_px"]
    edge_pol = torch.where(torch.rand(B, E, generator=gen, **f32) < 0.5, -1, 1)
    which = torch.randint(0, E, (B, N), generator=gen, device=device)
    t, u = torch.rand(2, B, N, generator=gen, **f32)
    a = torch.gather(ends[:, :, 0], 1, which[..., None].expand(B, N, 2))
    b = torch.gather(ends[:, :, 1], 1, which[..., None].expand(B, N, 2))
    d = torch.gather(motion, 1, which[..., None].expand(B, N, 2))
    on_edge = a + t[..., None] * (b - a) + u[..., None] * d \
        + torch.randn(B, N, 2, generator=gen, **f32) * p["jitter_px"]
    noise = torch.rand(B, N, 2, generator=gen, **f32) * scale
    is_edge = torch.rand(B, N, generator=gen, **f32) < p["edge_share"]
    xy = torch.where(is_edge[..., None], on_edge, noise)
    xy = torch.minimum(xy.clamp_min(0.0), scale - 1e-3)
    pol = torch.where(is_edge, torch.gather(edge_pol, 1, which),
                      torch.where(torch.rand(B, N, generator=gen, **f32) < 0.5, -1, 1))
    flip = torch.rand(B, N, generator=gen, **f32) < p["flip"]
    pol = torch.where(flip, -pol, pol)
    real = torch.arange(N, device=device)[None] < torch.as_tensor(n, device=device)[:, None]
    zero = torch.zeros((), **f32)
    return (torch.where(real, xy[..., 0], zero), torch.where(real, xy[..., 1], zero),
            torch.where(real, pol, 0).to(torch.int32))


def sparse_frames(count: int, H: int, W: int, p: dict, gen: torch.Generator,
                  device) -> torch.Tensor:
    """(count, H, W) f32 frames: k * thresh, k in +-1..levels, at a density
    uniform over [density_lo, density_hi] per frame."""
    f32 = dict(dtype=torch.float32, device=device)
    dens = p["density_lo"] + torch.rand(count, 1, 1, generator=gen, **f32) * (
        p["density_hi"] - p["density_lo"])
    on = torch.rand(count, H, W, generator=gen, **f32) < dens
    k = torch.randint(1, p["levels"] + 1, (count, H, W), generator=gen, device=device)
    sign = torch.where(torch.rand(count, H, W, generator=gen, **f32) < 0.5, -1.0, 1.0)
    return torch.where(on, sign * k * p["thresh"], 0.0).to(torch.float32)


def reset_steps(streams: int, lo: int, hi: int, horizon: int, r: np.random.Generator
                ) -> List[np.ndarray]:
    out = []
    for _ in range(streams):
        gaps = r.integers(lo, hi + 1, size=horizon // lo + 1)
        steps = np.cumsum(gaps)
        out.append(steps[steps < horizon])
    return out
