"""Torch-semantics image and layer primitives, as plain tensor functions.

Port of ``evfly_tpu/ops/imageops.py`` for the functions the port's models
need (``LSTMNetVIT``, ``OrigUNet`` and its velocity heads).  Layouts are
torch's (NCHW activations, OIHW conv weights, (out, in) linear weights),
the same as the JAX package keeps, so one state_dict feeds both.  These
functions run at whatever precision PyTorch's flags give; the port's entry
points set those flags for their own work (``evfly_tpu_torch.precision``):
full f32 by default, the JAX package's ``Precision.HIGHEST``, or TF32 after
``set_precision("tf32")``.  On the card, PyTorch's own default would run
cuDNN's f32 convolutions in TF32.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..precision import precision_scope


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


def conv_transpose2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride=1,
    padding=0,
) -> torch.Tensor:
    """torch.nn.functional.conv_transpose2d.  weight: (I, O, kH, kW) (torch
    IOHW); output size (in - 1) * stride - 2 * padding + k."""
    return F.conv_transpose2d(x, weight, bias, stride=stride, padding=padding)


def max_pool2d(x: torch.Tensor, kernel_size, stride=None) -> torch.Tensor:
    """torch.nn.functional.max_pool2d with floor semantics (VALID windows)."""
    return F.max_pool2d(x, kernel_size, stride if stride is not None else kernel_size)


def avg_pool2d(x: torch.Tensor, kernel_size, stride=None) -> torch.Tensor:
    """torch.nn.functional.avg_pool2d with floor semantics (VALID windows,
    the window's sum over its kh * kw cells)."""
    return F.avg_pool2d(x, kernel_size, stride if stride is not None else kernel_size)


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


def interpolate_bilinear_mm(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """``interpolate_bilinear`` as two matrix products, out = R_h @ x @ R_w^T,
    with ``resize_matrix``'s dense operators (``imageops.interpolate_bilinear_mm``).
    The products run in full f32 whatever PyTorch's TF32 flag says, as the
    JAX package runs them at HIGHEST.  x: (..., H, W)."""
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = x.shape[-2], x.shape[-1]
    xf = x.to(torch.float32)
    with precision_scope("highest"):
        if h_in != h_out:
            rh = torch.as_tensor(resize_matrix(h_in, h_out, align_corners).copy(),
                                 device=x.device)
            xf = torch.matmul(rh, xf)
        if w_in != w_out:
            rw = torch.as_tensor(resize_matrix(w_in, w_out, align_corners).copy(),
                                 device=x.device)
            xf = torch.matmul(xf, rw.T)
    return xf.to(x.dtype)


def pixel_shuffle(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    """torch.nn.PixelShuffle: (N, C*r^2, H, W) -> (N, C, H*r, W*r)."""
    return F.pixel_shuffle(x, upscale_factor)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """torch F.linear: weight (out, in).  Mixed floating dtypes compute in
    the promoted one, as ``jnp.matmul`` promotes (an f32 input times bf16
    weights: f32), where ``F.linear`` refuses them."""
    dtype = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dtype = torch.promote_types(dtype, bias.dtype)
        bias = bias.to(dtype)
    return F.linear(x.to(dtype), weight.to(dtype), bias)


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


def spectral_norm_power_iteration(weight_orig: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                                  n_iters: int = 1, eps: float = 1e-12):
    """torch spectral_norm's power-iteration update of (u, v), n_iters
    times: v = normalize(W^T u), then u = normalize(W v), W flattened to
    (out, -1).  The train step runs it once on every spectral-norm layer
    before the forward, outside autograd, as torch does inside forward()
    when training."""
    w_mat = weight_orig.reshape(weight_orig.shape[0], -1)
    for _ in range(n_iters):
        v = w_mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = w_mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return u, v


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """torch nn.LayerNorm over the last dimension."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def batch_norm2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    training: bool = False,
    momentum: float = 0.1,
    eps: float = 1e-5,
    mask: Optional[torch.Tensor] = None,
):
    """torch nn.BatchNorm2d over x (N, C, H, W) -> (out, new_running_mean,
    new_running_var), in plain tensor ops (``F.batch_norm`` takes no mask).

    Training mode normalizes with the biased batch statistics and moves the
    running stats by ``momentum`` toward the batch mean and the unbiased
    variance, count / max(count - 1, 1) times the biased one.  ``mask`` (N,),
    float 0/1, marks the valid frames of a padded chunk: the statistics are
    taken over those frames only, so a padded chunk normalizes and updates
    the running stats as its valid frames alone would.  Eval mode normalizes
    with the running stats and returns them unchanged.

    A mask of shape (G, N) means G chunks of N frames, x (G N, C, H, W) in
    chunk order (the JAX package's ``vmap`` over chunks): each chunk is
    normalized with its own masked statistics, and the new running stats
    are each chunk's own update from the same old stats, (G, C) each, with
    its own count and unbiased correction (``BatchNorm2d`` averages them
    over the chunks that have a valid frame).
    """
    if training and mask is not None and mask.dim() == 2:
        return _batch_norm2d_chunks(x, weight, bias, running_mean, running_var, momentum, eps,
                                    mask)
    if training:
        if mask is not None:
            m = mask.reshape(-1, 1, 1, 1).to(x.dtype)
            count = torch.clamp(mask.to(x.dtype).sum() * (x.shape[2] * x.shape[3]), min=1.0)
            mean = (x * m).sum(dim=(0, 2, 3)) / count
            var = ((x - mean.reshape(1, -1, 1, 1)).square() * m).sum(dim=(0, 2, 3)) / count
            unbiased = var * (count / torch.clamp(count - 1.0, min=1.0))
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean.reshape(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
            n = x.shape[0] * x.shape[2] * x.shape[3]
            unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps).reshape(1, -1, 1, 1)
    out = ((x - mean.reshape(1, -1, 1, 1)) * inv * weight.reshape(1, -1, 1, 1)
           + bias.reshape(1, -1, 1, 1))
    return out, new_mean, new_var


def _batch_norm2d_chunks(x, weight, bias, running_mean, running_var, momentum, eps, mask):
    """``batch_norm2d`` in training with a (G, N) mask: per-chunk masked
    statistics; the running stats' updates (G, C) each.  A chunk with no
    valid frame counts 1 element (no NaN); its update is left out by the
    caller."""
    G, N = mask.shape
    C, h, w = x.shape[1:]
    xg = x.reshape(G, N, C, h, w)
    m = mask.to(x.dtype).reshape(G, N, 1, 1, 1)
    count = torch.clamp(mask.to(x.dtype).sum(1) * (h * w), min=1.0)[:, None]  # (G, 1)
    mean = (xg * m).sum(dim=(1, 3, 4)) / count                                # (G, C)
    centered = xg - mean.reshape(G, 1, C, 1, 1)
    var = (centered.square() * m).sum(dim=(1, 3, 4)) / count
    unbiased = var * (count / torch.clamp(count - 1.0, min=1.0))
    new_mean = (1 - momentum) * running_mean + momentum * mean
    new_var = (1 - momentum) * running_var + momentum * unbiased
    inv = torch.rsqrt(var + eps).reshape(G, 1, C, 1, 1)
    out = centered * inv * weight.reshape(1, 1, C, 1, 1) + bias.reshape(1, 1, C, 1, 1)
    return out.reshape(x.shape), new_mean, new_var


def dropout(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (on x's
    device): keep with probability 1 - p, scale kept values by 1 / (1 - p),
    as ``evfly_tpu.ops.imageops.dropout``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


def gelu_exact(x: torch.Tensor):
    """torch nn.GELU() default (erf form)."""
    return F.gelu(x, approximate="none")
