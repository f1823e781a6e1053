"""Torch-semantics image and layer primitives, as plain tensor functions.

Port of ``evfly_tpu/ops/imageops.py`` for the functions the serving path
of ``LSTMNetVIT`` needs.  Layouts are torch's (NCHW activations, OIHW conv
weights, (out, in) linear weights), the same as the JAX package keeps, so
one state_dict feeds both.  Matmuls and convolutions run in full f32: the
JAX package's parity contract uses ``Precision.HIGHEST``, and on the card
the caller turns TF32 off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``) where it compares with it.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride=1,
    padding=0,
    groups: int = 1,
) -> torch.Tensor:
    """torch.nn.functional.conv2d.  x: (N, C, H, W), weight: (O, I/groups,
    kH, kW); ``padding`` may be an int, a pair or 'same' (stride 1, as
    MixFFN's depthwise conv uses it)."""
    return F.conv2d(x, weight, bias, stride=stride, padding=padding, groups=groups)


def _interp_axis_weights(n_in: int, n_out: int, align_corners: bool, device):
    """(i0, i1, w1) source taps of a 1-D bilinear resample, f32 as in
    ``imageops._interp_axis_weights``."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    if align_corners:
        src = torch.zeros_like(i) if n_out == 1 else i * (n_in - 1) / (n_out - 1)
    else:
        src = ((i + 0.5) * (n_in / n_out) - 0.5).clamp_min(0.0)
    i0 = torch.floor(src).to(torch.int64).clamp_max(n_in - 1)
    i1 = (i0 + 1).clamp_max(n_in - 1)
    w1 = src - i0.to(torch.float32)
    return i0, i1, w1


def interpolate_bilinear(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """torch F.interpolate(x, size, mode='bilinear', align_corners=...),
    as the JAX package's separable gather (``imageops.interpolate_bilinear``):
    rows first, then columns.  x: (..., H, W)."""
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = x.shape[-2], x.shape[-1]
    xf = x.to(torch.float32)
    if h_in != h_out:
        i0, i1, w1 = _interp_axis_weights(h_in, h_out, align_corners, x.device)
        top = xf.index_select(-2, i0)
        bot = xf.index_select(-2, i1)
        w1 = w1.reshape(h_out, 1)
        xf = top * (1.0 - w1) + bot * w1
    if w_in != w_out:
        j0, j1, v1 = _interp_axis_weights(w_in, w_out, align_corners, x.device)
        left = xf.index_select(-1, j0)
        right = xf.index_select(-1, j1)
        xf = left * (1.0 - v1) + right * v1
    return xf.to(x.dtype)


@functools.lru_cache(maxsize=64)
def resize_matrix(n_in: int, n_out: int, align_corners: bool = False, n_out_pad: int = 0):
    """Dense (max(n_out_pad, n_out), n_in) f32 matrix R with R @ v the 1-D
    bilinear resample of v (a copy of ``imageops.resize_matrix``).  Each row
    has <= 2 nonzeros; rows past n_out are zero.  numpy, read-only."""
    i = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = np.zeros_like(i) if n_out == 1 else i * (n_in - 1) / (n_out - 1)
    else:
        src = np.maximum((i + 0.5) * (n_in / n_out) - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = (src - i0).astype(np.float64)
    rows = max(n_out_pad, n_out)
    R = np.zeros((rows, n_in), np.float32)
    np.add.at(R, (np.arange(n_out), i0), (1.0 - w1).astype(np.float32))
    np.add.at(R, (np.arange(n_out), i1), w1.astype(np.float32))
    R.setflags(write=False)  # lru_cache shares this array across callers
    return R


def pixel_shuffle(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    """torch.nn.PixelShuffle: (N, C*r^2, H, W) -> (N, C, H*r, W*r)."""
    return F.pixel_shuffle(x, upscale_factor)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """torch F.linear: weight (out, in)."""
    return F.linear(x, weight, bias)


def spectral_sigma(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sigma = u^T W v with W flattened to (out, -1): torch spectral_norm in
    eval mode, with the stored u and v (no power iteration)."""
    w_mat = weight.reshape(weight.shape[0], -1)
    return u @ (w_mat @ v)


def spectral_linear(
    x: torch.Tensor,
    weight_orig: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
):
    """Linear layer under torch spectral_norm, eval semantics:
    weight = weight_orig / sigma."""
    return linear(x, weight_orig / spectral_sigma(weight_orig, u, v), bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """torch nn.LayerNorm over the last dimension."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


def gelu_exact(x: torch.Tensor):
    """torch nn.GELU() default (erf form)."""
    return F.gelu(x, approximate="none")
