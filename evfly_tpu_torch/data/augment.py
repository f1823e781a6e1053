"""Training-chunk augmentation: ``evfly_tpu/data/augment.py`` on torch
tensors (reference learner.py:862-918).

The reference augments each training chunk with gated transforms, and the
JAX package keeps its gates, probabilities and ranges:

* p 0.1: roll rotation by U(-20, 20) degrees, then the largest valid
  centered crop zoomed back to the full size (learner.py:868-876,
  ``calculate_valid_crop_size`` :803; the crop uses 3.14/180 for the
  radians, a quirk of the reference);
* p 0.1: horizontal flip, negating the y velocity (:890-893);
* p 0.2: event scale x U(0.25, 4), clipped to +-1 (:898-904);
* p 0.1: Gaussian noise, sigma 1e-5 (:907-909);
* p 0.1: a random polarity sign per frame (:911-916).

Scale and polarity reach the ground truth too when it is event frames
(``num_out_channels == 2``).  As in the JAX package, rotation and zoom are
one bilinear warp (not the reference's nearest rotation, crop and resize).
The draws come from a ``torch.Generator`` (the JAX package splits a key):
``draw_params`` makes them on the generator's device in the JAX order, and
``apply_params`` applies them with ``torch.where`` gates, so a chunk on the
card never waits for the host.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

ROT_P, ROT_DEG = 0.1, 20.0
FLIP_P = 0.1
SCALE_P, SCALE_MIN, SCALE_MAX = 0.2, 0.25, 4.0
NOISE_P, NOISE_STD = 0.1, 1e-5
POL_P = 0.1


def _affine_rotate_zoom(img: torch.Tensor, angle_rad: torch.Tensor,
                        zoom: torch.Tensor) -> torch.Tensor:
    """Rotate img (N, C, H, W) by angle about its center and zoom in
    (zoom <= 1 takes the centered (zoom H, zoom W) region back to (H, W)),
    bilinear, edges clamped."""
    N, C, H, W = img.shape
    dev = img.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys = torch.arange(H, dtype=torch.float32, device=dev) - cy
    xs = torch.arange(W, dtype=torch.float32, device=dev) - cx
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    cos, sin = torch.cos(angle_rad), torch.sin(angle_rad)
    # output pixel -> source coordinate: zoom, then rotate by -angle
    sx = (xx * cos - yy * sin) * zoom + cx
    sy = (xx * sin + yy * cos) * zoom + cy

    x0 = torch.floor(sx).to(torch.int64).clamp(0, W - 1)
    y0 = torch.floor(sy).to(torch.int64).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    wx = (sx - x0).clamp(0.0, 1.0)
    wy = (sy - y0).clamp(0.0, 1.0)

    flat = img.reshape(N * C, H, W)
    out = (
        flat[:, y0, x0] * (1 - wy) * (1 - wx)
        + flat[:, y0, x1] * (1 - wy) * wx
        + flat[:, y1, x0] * wy * (1 - wx)
        + flat[:, y1, x1] * wy * wx
    )
    return out.reshape(N, C, H, W)


def _valid_zoom(angle_rad: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Largest centered axis-aligned crop scale valid after the rotation
    (learner.py:803-820)."""
    c, s = torch.cos(angle_rad).abs(), torch.sin(angle_rad).abs()
    rot_w = W * c + H * s
    rot_h = W * s + H * c
    crop_w = W * H / rot_h
    crop_h = W * H / rot_w
    return torch.maximum(crop_w / W, crop_h / H)


def rotate_zoom(img: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """The rotation transform at a given angle: the warp by the angle in
    radians, zoomed by ``_valid_zoom`` of the angle taken with 3.14/180 and
    with (W, H) in the place of (H, W), both as the JAX package calls it."""
    H, W = img.shape[-2], img.shape[-1]
    angle = angle_deg * math.pi / 180.0
    zoom = _valid_zoom(angle_deg * 3.14 / 180.0, W, H)
    return _affine_rotate_zoom(img, angle, zoom)


def draw_params(generator: torch.Generator, n_frames: int, frame_shape,
                device) -> Dict[str, torch.Tensor]:
    """One chunk's draws, in the order of the JAX package's keys: the
    gates' uniforms (``*_u``), the angle in degrees, the scale, the noise
    (frame_shape per frame) and the per-frame polarity signs."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    p = {"rot_u": u()}
    p["angle_deg"] = u() * (2 * ROT_DEG) - ROT_DEG
    p["flip_u"] = u()
    p["scale_u"] = u()
    p["scale"] = u() * (SCALE_MAX - SCALE_MIN) + SCALE_MIN
    p["noise_u"] = u()
    p["noise"] = torch.randn((n_frames, *frame_shape), generator=generator,
                             device=device) * NOISE_STD
    p["pol_u"] = u()
    p["signs"] = torch.where(u(n_frames, 1, 1, 1) < 0.5, -1.0, 1.0)
    return p


def apply_params(p: Dict[str, torch.Tensor], inputs: torch.Tensor, gts_vels: torch.Tensor,
                 gts: torch.Tensor, num_out_channels: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gated transforms with the draws ``p``: inputs (N, 1, H, W) event
    frames, gts_vels (N, 3), gts (N, 1, H, W) depth (or event) ground
    truth."""
    rot = p["rot_u"] < ROT_P
    inputs = torch.where(rot, rotate_zoom(inputs, p["angle_deg"]), inputs)
    gts = torch.where(rot, rotate_zoom(gts, p["angle_deg"]), gts)

    flip = p["flip_u"] < FLIP_P
    inputs = torch.where(flip, inputs.flip(-1), inputs)
    gts = torch.where(flip, gts.flip(-1), gts)
    y_sign = torch.where(flip, -1.0, 1.0)
    gts_vels = torch.cat([gts_vels[:, :1], gts_vels[:, 1:2] * y_sign, gts_vels[:, 2:]], 1)

    scale_gate = p["scale_u"] < SCALE_P
    scale = torch.where(scale_gate, p["scale"], 1.0)
    inputs = torch.where(scale_gate, (inputs * scale).clamp(-1.0, 1.0), inputs)
    if num_out_channels == 2:
        gts = torch.where(scale_gate, (gts * scale).clamp(-1.0, 1.0), gts)

    inputs = torch.where(p["noise_u"] < NOISE_P, inputs + p["noise"], inputs)

    pol = p["pol_u"] < POL_P
    inputs = torch.where(pol, inputs * p["signs"], inputs)
    if num_out_channels == 2:
        gts = torch.where(pol, gts * p["signs"], gts)
    return inputs, gts_vels, gts


def augment_chunk(generator: torch.Generator, inputs: torch.Tensor, gts_vels: torch.Tensor,
                  gts: torch.Tensor, num_out_channels: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's augmentation of one training chunk, its draws from
    ``generator`` (on the inputs' device)."""
    p = draw_params(generator, inputs.shape[0], inputs.shape[1:], inputs.device)
    return apply_params(p, inputs, gts_vels, gts, num_out_channels)
