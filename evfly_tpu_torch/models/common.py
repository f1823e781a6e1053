"""Shared model infrastructure: torch-default initializers, param helpers and
the leaf modules whose tensors are named like the reference state_dicts.

Port of ``evfly_tpu/models/common.py``.  Parameters keep the reference's
PyTorch ``state_dict`` keys (``"decoder.weight_orig"``, ``"lstm.weight_ih_l0"``)
and torch layouts, so a checkpoint or the JAX package's params load with a
cast.  Initial values come from an explicit ``torch.Generator`` on the CPU
and are then moved to the module's device, so a seed gives the same weights
on every device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from ..ops import imageops

Params = Dict[str, torch.Tensor]


def sub(params: Params, prefix: str) -> Params:
    """The entries of params under a key prefix, with the prefix removed."""
    pre = prefix + "."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def prefix_params(prefix: str, params: Params) -> Params:
    return {f"{prefix}.{k}": v for k, v in params.items()}


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen)


def _kaiming_uniform_bound(fan_in: int) -> float:
    # torch kaiming_uniform_(a=sqrt(5)) => U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


def init_conv2d(gen, in_ch: int, out_ch: int, kernel_size, bias: bool = True,
                groups: int = 1) -> Params:
    """``kernel_size`` k (k x k) or (kh, kw)."""
    kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
    b = _kaiming_uniform_bound((in_ch // groups) * kh * kw)
    p = {"weight": _uniform(gen, (out_ch, in_ch // groups, kh, kw), b)}
    if bias:
        p["bias"] = _uniform(gen, (out_ch,), b)
    return p


def init_conv_transpose2d(gen, in_ch: int, out_ch: int, kernel_size: int,
                          bias: bool = True) -> Params:
    """torch ConvTranspose2d params: weight (in, out, k, k); torch's fan_in
    for that layout is out * k * k."""
    k = kernel_size
    b = _kaiming_uniform_bound(out_ch * k * k)
    p = {"weight": _uniform(gen, (in_ch, out_ch, k, k), b)}
    if bias:
        p["bias"] = _uniform(gen, (out_ch,), b)
    return p


def init_linear(gen, in_f: int, out_f: int, bias: bool = True) -> Params:
    b = _kaiming_uniform_bound(in_f)
    p = {"weight": _uniform(gen, (out_f, in_f), b)}
    if bias:
        p["bias"] = _uniform(gen, (out_f,), b)
    return p


def init_spectral_linear(gen, in_f: int, out_f: int, bias: bool = True) -> Params:
    """torch spectral_norm(Linear): weight_orig and the power-iteration
    vectors u, v."""
    base = init_linear(gen, in_f, out_f, bias)
    p = {"weight_orig": base["weight"]}
    if bias:
        p["bias"] = base["bias"]
    u = torch.randn(out_f, generator=gen)
    v = torch.randn(in_f, generator=gen)
    p["weight_u"] = u / (u.norm() + 1e-12)
    p["weight_v"] = v / (v.norm() + 1e-12)
    return p


def init_batchnorm2d(num_features: int) -> Params:
    """torch nn.BatchNorm2d's state: weight and bias, the running stats and
    the int64 counter ``num_batches_tracked``."""
    return {
        "weight": torch.ones(num_features, dtype=torch.float32),
        "bias": torch.zeros(num_features, dtype=torch.float32),
        "running_mean": torch.zeros(num_features, dtype=torch.float32),
        "running_var": torch.ones(num_features, dtype=torch.float32),
        "num_batches_tracked": torch.zeros((), dtype=torch.int64),
    }


def init_layernorm(num_features: int) -> Params:
    return {
        "weight": torch.ones(num_features, dtype=torch.float32),
        "bias": torch.zeros(num_features, dtype=torch.float32),
    }


def init_lstm(gen, input_size: int, hidden_size: int, num_layers: int,
              bias: bool = True) -> Params:
    """torch nn.LSTM params: weight_ih_l{k} (4H, in), weight_hh_l{k} (4H, H)."""
    p: Params = {}
    b = 1.0 / math.sqrt(hidden_size)
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden_size
        p[f"weight_ih_l{layer}"] = _uniform(gen, (4 * hidden_size, in_sz), b)
        p[f"weight_hh_l{layer}"] = _uniform(gen, (4 * hidden_size, hidden_size), b)
        if bias:
            p[f"bias_ih_l{layer}"] = _uniform(gen, (4 * hidden_size,), b)
            p[f"bias_hh_l{layer}"] = _uniform(gen, (4 * hidden_size,), b)
    return p


def is_trainable_key(key: str) -> bool:
    """Running stats, counters and spectral-norm u/v are not trained."""
    tail = key.rsplit(".", 1)[-1]
    return tail not in ("running_mean", "running_var", "num_batches_tracked", "weight_u", "weight_v")


def param_count(params: Params, trainable_only: bool = True) -> int:
    n = 0
    for k, v in params.items():
        if k.endswith("num_batches_tracked"):
            continue
        if trainable_only and not is_trainable_key(k):
            continue
        n += int(v.numel())
    return n


def module_param_count(module: nn.Module) -> int:
    """A module's trained parameters (BatchNorm's running statistics and
    counters are buffers, left out; a module shared twice counted once)."""
    return sum(p.numel() for p in module.parameters())


def part_param_counts(model: nn.Module, parts: Dict[str, str]) -> List[Tuple[str, int]]:
    """(part, trained parameters) of each part name -> submodule attribute."""
    return [(part, module_param_count(getattr(model, attr))) for part, attr in parts.items()]


class ParamLeaf(nn.Module):
    """A leaf module whose tensors are registered under their state_dict
    names: parameters, except the names in ``buffers``."""

    def __init__(self, params: Params, device: torch.device, buffers: Iterable[str] = ()):
        super().__init__()
        buffers = set(buffers)
        for name, value in params.items():
            value = value.to(device)
            if name in buffers:
                self.register_buffer(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value))

    def _bias(self) -> Optional[torch.Tensor]:
        return getattr(self, "bias", None)


class Linear(ParamLeaf):
    def __init__(self, in_f: int, out_f: int, gen, device, bias: bool = True):
        super().__init__(init_linear(gen, in_f, out_f, bias), device)

    def forward(self, x):
        return imageops.linear(x, self.weight, self._bias())


class SpectralLinear(ParamLeaf):
    """Linear under torch spectral_norm, eval semantics (stored u and v)."""

    def __init__(self, in_f: int, out_f: int, gen, device, bias: bool = True):
        super().__init__(
            init_spectral_linear(gen, in_f, out_f, bias), device, ("weight_u", "weight_v")
        )

    def forward(self, x):
        return imageops.spectral_linear(
            x, self.weight_orig, self.weight_u, self.weight_v, self._bias()
        )


class Conv2d(ParamLeaf):
    def __init__(self, in_ch: int, out_ch: int, kernel_size, gen, device,
                 stride=1, padding=0, groups: int = 1, bias: bool = True):
        super().__init__(init_conv2d(gen, in_ch, out_ch, kernel_size, bias, groups), device)
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x):
        return imageops.conv2d(x, self.weight, self._bias(), self.stride, self.padding, self.groups)


class ConvTranspose2d(ParamLeaf):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, gen, device, stride=1,
                 padding=0, bias: bool = True):
        super().__init__(init_conv_transpose2d(gen, in_ch, out_ch, kernel_size, bias), device)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return imageops.conv_transpose2d(x, self.weight, self._bias(), self.stride, self.padding)


class BatchNorm2d(ParamLeaf):
    """torch nn.BatchNorm2d (momentum 0.1, eps 1e-5) whose running stats
    and counter are buffers, so an optimizer over ``parameters()`` never
    sees them (``is_trainable_key``).  In training mode a forward
    normalizes with the batch statistics, over the frames where ``mask``
    is 1 when one is given, and writes the new running stats and the
    counter + 1 into the buffers outside autograd: the JAX package's
    ``updates``, merged into the params after the optimizer step.

    A (G, N) mask marks G chunks of N frames (the JAX package's vmap over
    chunks): each chunk is normalized with its own statistics, and the
    buffers stay as they were.  The forward leaves on ``chunk_update``
    (sum over the chunks with a valid frame of each chunk's running-mean
    update from the old stats, the same of its running-var update, their
    count) for the caller, which may add them up across processes before
    ``apply_chunk_update`` (``parallel.make_dp_chunked_train_step``)."""

    def __init__(self, num_features: int, device):
        super().__init__(init_batchnorm2d(num_features), device,
                         ("running_mean", "running_var", "num_batches_tracked"))
        self.chunk_update: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        out, mean, var = imageops.batch_norm2d(x, self.weight, self.bias, self.running_mean,
                                               self.running_var, self.training, mask=mask)
        if self.training:
            with torch.no_grad():
                if mask is not None and mask.dim() == 2:
                    real = (mask.sum(1) > 0).to(mean.dtype)[:, None]
                    self.chunk_update = ((mean * real).sum(0), (var * real).sum(0), real.sum())
                else:
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
                    self.num_batches_tracked.add_(1)
        return out

    def apply_chunk_update(self, mean_sum: torch.Tensor, var_sum: torch.Tensor,
                           n_real: torch.Tensor) -> None:
        """Running stats = the sums of the valid chunks' updates over their
        count ``n_real``, the counter + 1 (JAX's average of its int counter
        is an f32 old + 1; here it stays int64 with that value); nothing
        where ``n_real`` is 0.  No host synchronization."""
        with torch.no_grad():
            some = n_real > 0
            n = torch.clamp(n_real, min=1.0)
            self.running_mean.copy_(torch.where(some, mean_sum / n, self.running_mean))
            self.running_var.copy_(torch.where(some, var_sum / n, self.running_var))
            self.num_batches_tracked.add_(some.to(self.num_batches_tracked.dtype))


class LayerNorm(ParamLeaf):
    def __init__(self, num_features: int, device):
        super().__init__(init_layernorm(num_features), device)

    def forward(self, x):
        return imageops.layer_norm(x, self.weight, self.bias)



@dataclasses.dataclass(frozen=True)
class StreamIO:
    """What a model takes in a streaming step (``stream.pipeline``),
    declared by the model as ``stream_io``.  Every streaming model steps as
    ``stream(frame, hidden, desvel) -> (outputs, new hidden)``.

    ``time_bins`` 0: one signed event frame at the pipeline's size (K1's
    histogram of (x, y, pol)).  ``time_bins`` T > 0: a stacked histogram of
    the events (x, y, pol, t) from a ``sensor_hw`` sensor, 2 T channels
    (polarity-major) of ``frame_hw``, coordinates divided by
    ``downsample``, counts clipped at ``clip``.  ``rectify_map`` (H, W, 2),
    the rectified (x, y) of each sensor pixel: in place of the stacked
    histogram, E-RAFT's voxel grid of the events (``time_bins`` channels of
    ``frame_hw``, trilinear over the coordinates rectified through the map,
    normalised).  ``quantile_scale``: the pipeline may scale the frame by
    its 97th percentile."""
    time_bins: int = 0
    sensor_hw: Optional[Tuple[int, int]] = None
    frame_hw: Optional[Tuple[int, int]] = None
    downsample: int = 1
    clip: float = 0.0
    quantile_scale: bool = True
    rectify_map: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)


COMPOSITE_IO = StreamIO()
