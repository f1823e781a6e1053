"""Configurable building blocks of the velocity heads: DynamicConvNet,
DynamicFCNet and VelPredictor.

Port of ``evfly_tpu/models/layers.py`` (reference learner_models.py:18-146,
274-336), with its state_dict keys (``layers.conv2d_0.weight``,
``layers.batchnorm_0.running_mean``, ``fcnet.layers.fc_0.bias``).

The reference quirk the JAX package keeps, kept here too: DynamicConvNet
registers its "undo the inversion after pooling" module under the same name
as the "invert before pooling" one (learner_models.py:77,92 both use
``f'invert_{i}'``), and ``nn.Module.add_module`` replaces in place, so the
built network negates its activations once before each pool and never
undoes it.  The shipped configurations train with
``enc_invert_pool_inputs = True``, so trained weights depend on it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import imageops
from .common import BatchNorm2d, Conv2d, ConvTranspose2d, Linear

_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "leaky_relu": imageops.leaky_relu,
}
_POOLS = {"max": imageops.max_pool2d, "avg": imageops.avg_pool2d}


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class DynamicConvNet(nn.Module):
    """Conv (or transposed conv) without bias -> BatchNorm -> activation ->
    [a sign flip] -> [pool], per layer; transposed convs are not pooled."""

    def __init__(
        self,
        in_channels: int,
        num_layers: int,
        kernel_sizes: List[int],
        kernel_strides: List[int],
        out_channels: List[int],
        activations: List[str],
        pool_type: str = "max",
        pool_kernels: Optional[List[int]] = None,
        pool_strides: Optional[List[int]] = None,
        conv_function: str = "conv2d",
        invert_pool_input: bool = False,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        for name, v in (("kernel_sizes", kernel_sizes), ("kernel_strides", kernel_strides),
                        ("out_channels", out_channels), ("activations", activations)):
            if len(v) != num_layers:
                raise ValueError(f"{name} has {len(v)} entries for {num_layers} layers")
        if conv_function not in ("conv2d", "upconv2d"):
            raise NotImplementedError(f"conv_function {conv_function}")
        if pool_type not in ("none", *_POOLS):
            raise NotImplementedError(f"pool_type {pool_type}")
        dev, gen = resolve_device(device), _generator(generator)
        self.num_layers = num_layers
        self.kernel_sizes, self.kernel_strides = list(kernel_sizes), list(kernel_strides)
        self.out_channels, self.activations = list(out_channels), list(activations)
        self.pool_type = pool_type
        self.pool_kernels = list(pool_kernels) if pool_kernels is not None else [2] * num_layers
        self.pool_strides = list(pool_strides) if pool_strides is not None else [2] * num_layers
        self.conv_function = conv_function
        self.invert_pool_input = invert_pool_input
        self.layers = nn.ModuleDict()
        cur = in_channels
        for i in range(num_layers):
            k, s, cout = kernel_sizes[i], kernel_strides[i], out_channels[i]
            conv = (Conv2d(cur, cout, k, gen, dev, stride=s, bias=False)
                    if conv_function == "conv2d"
                    else ConvTranspose2d(cur, cout, k, gen, dev, stride=s, bias=False))
            self.layers[f"{conv_function}_{i}"] = conv
            self.layers[f"batchnorm_{i}"] = BatchNorm2d(cout, dev)
            cur = cout

    def forward(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
        """x (N, C, H, W) -> (N, C', H', W').  ``frame_mask`` (N,) marks the
        valid frames of a padded chunk for the BatchNorms' statistics in
        training; (G, N) for G chunks of N frames in chunk order, each with
        its own statistics."""
        for i in range(self.num_layers):
            x = self.layers[f"{self.conv_function}_{i}"](x)
            x = self.layers[f"batchnorm_{i}"](x, frame_mask)
            if self.activations[i] != "none":
                x = _ACTS[self.activations[i]](x)
            if self.invert_pool_input:
                x = -x  # once, never undone (the reference's duplicate name)
            if self.conv_function == "conv2d" and self.pool_type != "none":
                x = _POOLS[self.pool_type](x, self.pool_kernels[i], self.pool_strides[i])
        return x

    def output_shape(self, input_hw: Tuple[int, int]) -> Tuple[int, int, int]:
        """(C, H, W) of the output for an input of ``input_hw``, by the
        arithmetic of valid convolutions and pools (the reference probes a
        random tensor, learner_models.py:8-12)."""
        h, w = input_hw
        for i in range(self.num_layers):
            k, s = self.kernel_sizes[i], self.kernel_strides[i]
            if self.conv_function == "conv2d":
                h, w = (h - k) // s + 1, (w - k) // s + 1
                if self.pool_type != "none":
                    pk, ps = self.pool_kernels[i], self.pool_strides[i]
                    h, w = (h - pk) // ps + 1, (w - pk) // ps + 1
            else:
                h, w = (h - 1) * s + k, (w - 1) * s + k
        return self.out_channels[-1], h, w


class DynamicFCNet(nn.Module):
    """Linear -> [dropout] -> activation, per layer (learner_models.py:102-145).
    Dropout applies in training mode with a ``generator`` only, as the JAX
    package drops out only when given an ``rng``."""

    def __init__(self, input_features: int, num_layers: int, layer_sizes: List[int],
                 activations: List[str], dropout_p: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        if len(layer_sizes) != num_layers or len(activations) != num_layers:
            raise ValueError(f"{num_layers} layers need as many sizes and activations")
        dev, gen = resolve_device(device), _generator(generator)
        self.activations = list(activations)
        self.dropout_p = dropout_p
        self.layers = nn.ModuleDict()
        cur = input_features
        for i, size in enumerate(layer_sizes):
            self.layers[f"fc_{i}"] = Linear(cur, size, gen, dev)
            cur = size

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        for i, act in enumerate(self.activations):
            x = self.layers[f"fc_{i}"](x)
            if self.dropout_p and self.training and generator is not None:
                x = imageops.dropout(x, self.dropout_p, generator)
            x = _ACTS[act](x)
        return x


class VelPredictor(nn.Module):
    """An FC head that emits a velocity 3-vector: with num_out 1 or 2 the
    leading component is completed as sqrt(clip(1 - sum y^2, 0, 1)), and
    with num_out 1 the last is 0 (learner_models.py:313-334)."""

    def __init__(self, input_size: int = 512, num_out: int = 3,
                 fc_params: Optional[dict] = None, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        if fc_params is None:
            fc_params = {"num_layers": 3, "layer_sizes": [128, 32, num_out],
                         "activations": ["leaky_relu", "leaky_relu", "tanh"], "dropout_p": 0.1}
        self.num_out = num_out
        self.fcnet = DynamicFCNet(input_size, fc_params["num_layers"], fc_params["layer_sizes"],
                                  fc_params["activations"], fc_params["dropout_p"],
                                  generator, device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x (N, ...) flattened to (N, features) -> (N, 3) (num_out 1 or 2),
        or (N, num_out)."""
        y = self.fcnet(x.reshape(x.shape[0], -1), generator)
        if self.num_out == 2:
            first = torch.sqrt(torch.clamp(1.0 - y.square().sum(dim=1, keepdim=True), 0.0, 1.0))
            return torch.cat([first, y], dim=1)
        if self.num_out == 1:
            first = torch.sqrt(torch.clamp(1.0 - y.square(), 0.0, 1.0))
            return torch.cat([first, y, torch.zeros_like(y)], dim=1)
        return y


def dynamic_convnet(in_channels: int, enc_params: dict, gen, device) -> DynamicConvNet:
    """A ``DynamicConvNet`` from the config's ``enc_*`` keys
    (``registry.enc_params_from_config``)."""
    ep = enc_params
    return DynamicConvNet(
        in_channels, ep["num_layers"], ep["kernel_sizes"], ep["kernel_strides"],
        ep["out_channels"], ep["activations"], pool_type=ep["pool_type"],
        pool_kernels=ep["pool_kernels"], pool_strides=ep["pool_strides"],
        conv_function=ep["conv_function"], invert_pool_input=ep.get("invert_pool_inputs", False),
        generator=gen, device=device)


def head_features(x: torch.Tensor, lead) -> torch.Tensor:
    """Features (B, F) of B = prod(lead) frames as the head's LSTM takes
    them: (N, F), one sequence, or (G, N, F), G streams."""
    return x.reshape(*(lead if len(lead) == 2 else (-1,)), x.shape[-1])
