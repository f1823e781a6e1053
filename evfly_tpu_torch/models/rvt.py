"""RVT-B, the Recurrent Vision Transformer for event cameras, for inference.

Gehrig and Scaramuzza, "Recurrent Vision Transformers for Object Detection
with Event Cameras", CVPR 2023 (arXiv:2212.05598, github.com/uzh-rpg/RVT),
at its base size (18.5 M parameters) on the 1 Mpx automotive sensor
(Prophesee Gen4, 720x1280).  One streaming step takes one window of events
and the state of four per-pixel LSTMs, and gives YOLOX detections.

* Input: the stacked histogram of the window (``ops.voxelizer.
  stacked_histogram``): coordinates halved to 360x640, T = 10 time bins per
  polarity (20 channels, polarity-major), counts clipped at 10, rows
  zero-padded to 384.
* Stage s = 1..4 (C = 64, 128, 256, 512; strides 4, 8, 16, 32):
  ``Z = LN(Conv(X))`` (7x7 stride 4 for s = 1, 3x3 stride 2 after, no bias,
  a LayerNorm over channels), then for P = window, then grid (MaxViT's
  multi-axis attention over 6x10 partitions):
  ``Z = Z + g1 * Unpart_P(MHSA(Part_P(LN(Z))))``,
  ``Z = Z + g2 * MLP(LN(Z))``, MHSA of C/32 heads of width 32 with no
  relative position bias, MLP C -> 4C -> C with erf GELU, g1 and g2
  LayerScale; then a 1x1 ConvLSTM of C channels (``recurrent.ConvLSTM``,
  gates (i, f, o, g)), whose h is the stage's output and the next stage's
  input.
* YOLOX's PAFPN over stages 2-4 at depth 0.67 (two bottlenecks a CSP
  layer), ``BaseConv`` = convolution without bias, BatchNorm (eval), SiLU;
  nearest x2 upsampling.
* YOLOX's decoupled head at hidden width 128 (YOLOX's 256 scaled by the last
  stage's 512 over YOLOX's 1024), 3 classes: raw (B, anchors, 8) = (box 4,
  objectness, classes), and decoded ``xy = (r_xy + grid) stride``,
  ``wh = exp(r_wh) stride``, sigmoid of the rest.

Departures from the published model: non-maximum suppression is
data-dependent and stays outside the step (the caller runs it on the
decoded output); no relative position bias in the attention.

While a profiler records, the layers are spans (``utils.profiling``):
``evfly.rvt.downsample``, ``evfly.rvt.attention`` (window and grid) and
``evfly.rvt.lstm`` each stage, with counts ``stage`` and ``tokens`` (and
``partitions``, the attention's groups of each kind), and ``evfly.rvt.head``
(FPN, head and decode); inside a captured CUDA graph they are its marks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..precision import with_precision
from ..utils import profiling
from .common import (BatchNorm2d, Conv2d, LayerNorm, Linear, ParamLeaf, Params, StreamIO,
                     part_param_counts)
from .recurrent import ConvLSTM

STAGE_DIMS = (64, 128, 256, 512)
PARTITION = (6, 10)          # window and grid partition, rows x columns
HEAD_DIM = 32
MLP_RATIO = 4
TIME_BINS = 10
SENSOR_HW = (720, 1280)
FRAME_HW = (384, 640)        # 360x640 after halving, rows padded to a multiple of 64
COUNT_CLIP = 10.0
FPN_STAGES = (2, 3, 4)
FPN_DEPTH = 2                # round(3 x 0.67) bottlenecks a CSP layer
HEAD_WIDTH = 128             # int(256 x 512 / 1024)
NUM_CLASSES = 3              # pedestrian, two-wheeler, car
BN_EPS = 1e-3                # YOLOX's BatchNorm
LAYERSCALE_INIT = 1e-5       # RVT's LayerScale initial value

State = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


# ------------------------------------------------------------ partitions

def window_partition(x: torch.Tensor, p: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B H/ph W/pw, ph pw, C): contiguous ph x pw windows."""
    B, H, W, C = x.shape
    ph, pw = p
    x = x.view(B, H // ph, ph, W // pw, pw, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ph * pw, C)


def window_unpartition(t: torch.Tensor, p: Tuple[int, int], shape) -> torch.Tensor:
    B, H, W, C = shape
    ph, pw = p
    x = t.view(B, H // ph, W // pw, ph, pw, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def grid_partition(x: torch.Tensor, p: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B H/gh W/gw, gh gw, C): groups of gh x gw tokens
    H/gh rows and W/gw columns apart (MaxViT's grid)."""
    B, H, W, C = x.shape
    gh, gw = p
    x = x.view(B, gh, H // gh, gw, W // gw, C).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, gh * gw, C)


def grid_unpartition(t: torch.Tensor, p: Tuple[int, int], shape) -> torch.Tensor:
    B, H, W, C = shape
    gh, gw = p
    x = t.view(B, H // gh, W // gw, gh, gw, C).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, H, W, C)


PARTITIONS = {"window": (window_partition, window_unpartition),
              "grid": (grid_partition, grid_unpartition)}


# ---------------------------------------------------------------- layers

class LayerScale(ParamLeaf):
    def __init__(self, dim: int, device, init: float = LAYERSCALE_INIT):
        super().__init__({"gamma": torch.full((dim,), init)}, device)

    def forward(self, x):
        return x * self.gamma


class PartitionBlock(nn.Module):
    """One MaxViT block over one kind of partition, channels last."""

    def __init__(self, dim: int, kind: str, partition: Tuple[int, int], gen, device):
        super().__init__()
        self.kind, self.partition, self.heads = kind, tuple(partition), dim // HEAD_DIM
        self.norm1 = LayerNorm(dim, device)
        self.qkv = Linear(dim, 3 * dim, gen, device)
        self.proj = Linear(dim, dim, gen, device)
        self.ls1 = LayerScale(dim, device)
        self.norm2 = LayerNorm(dim, device)
        self.fc1 = Linear(dim, MLP_RATIO * dim, gen, device)
        self.fc2 = Linear(MLP_RATIO * dim, dim, gen, device)
        self.ls2 = LayerScale(dim, device)

    def attention(self, t: torch.Tensor) -> torch.Tensor:
        n, L, C = t.shape
        qkv = self.qkv(t).view(n, L, 3, self.heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return self.proj(o.transpose(1, 2).reshape(n, L, C))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        part, unpart = PARTITIONS[self.kind]
        t = part(self.norm1(z), self.partition)
        z = z + self.ls1(unpart(self.attention(t), self.partition, z.shape))
        return z + self.ls2(self.fc2(F.gelu(self.fc1(self.norm2(z)))))


class Downsample(nn.Module):
    """Strided convolution without bias, then a LayerNorm over channels;
    channels last out."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, gen, device):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, gen, device, stride=stride, padding=k // 2, bias=False)
        self.norm = LayerNorm(cout, device)

    def forward(self, x):
        return self.norm(self.conv(x).permute(0, 2, 3, 1))


class Stage(nn.Module):
    def __init__(self, index: int, cin: int, dim: int, partition, gen, device):
        super().__init__()
        self.index, self.partition = index, tuple(partition)
        k, stride = (7, 4) if index == 1 else (3, 2)
        self.downsample = Downsample(cin, dim, k, stride, gen, device)
        self.window = PartitionBlock(dim, "window", partition, gen, device)
        self.grid = PartitionBlock(dim, "grid", partition, gen, device)
        self.lstm = ConvLSTM(dim, [dim], (1, 1), gen, device)

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]):
        """x (B, Cin, H, W), state (h, c) each (B, C, H/2, W/2) (H/4 for the
        first stage) -> (h, (h, c))."""
        B, _, h, w = state[0].shape
        counts = dict(stage=self.index, tokens=B * h * w)
        with profiling.span("evfly.rvt.downsample", **counts):
            z = self.downsample(x)
        ph, pw = self.partition
        with profiling.span("evfly.rvt.attention", partitions=B * (h // ph) * (w // pw),
                            **counts):
            z = self.grid(self.window(z))
        with profiling.span("evfly.rvt.lstm", **counts):
            _, ((h_new, c_new),) = self.lstm(z.permute(0, 3, 1, 2)[:, None], [state])
        return h_new, (h_new, c_new)


class BaseConv(nn.Module):
    """YOLOX's BaseConv: convolution without bias, BatchNorm in eval, SiLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, gen, device):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, gen, device, stride=stride, padding=(k - 1) // 2,
                           bias=False)
        self.bn = BatchNorm2d(cout, device)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         False, 0.0, BN_EPS)
        return F.silu(x)


class Bottleneck(nn.Module):
    """YOLOX's Bottleneck without the shortcut: 1x1 then 3x3 BaseConv."""

    def __init__(self, dim: int, gen, device):
        super().__init__()
        self.conv1 = BaseConv(dim, dim, 1, 1, gen, device)
        self.conv2 = BaseConv(dim, dim, 3, 1, gen, device)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class CSPLayer(nn.Module):
    """YOLOX's CSPLayer (expansion 0.5, no shortcut)."""

    def __init__(self, cin: int, cout: int, n: int, gen, device):
        super().__init__()
        hidden = cout // 2
        self.conv1 = BaseConv(cin, hidden, 1, 1, gen, device)
        self.conv2 = BaseConv(cin, hidden, 1, 1, gen, device)
        self.conv3 = BaseConv(2 * hidden, cout, 1, 1, gen, device)
        self.m = nn.Sequential(*(Bottleneck(hidden, gen, device) for _ in range(n)))

    def forward(self, x):
        return self.conv3(torch.cat([self.m(self.conv1(x)), self.conv2(x)], 1))


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PAFPN(nn.Module):
    """YOLOX's PAFPN over (C3, C4, C5) = (128, 256, 512) channels."""

    def __init__(self, dims: Sequence[int], depth: int, gen, device):
        super().__init__()
        c3, c4, c5 = dims
        self.lateral_conv0 = BaseConv(c5, c4, 1, 1, gen, device)
        self.C3_p4 = CSPLayer(2 * c4, c4, depth, gen, device)
        self.reduce_conv1 = BaseConv(c4, c3, 1, 1, gen, device)
        self.C3_p3 = CSPLayer(2 * c3, c3, depth, gen, device)
        self.bu_conv2 = BaseConv(c3, c3, 3, 2, gen, device)
        self.C3_n3 = CSPLayer(2 * c3, c4, depth, gen, device)
        self.bu_conv1 = BaseConv(c4, c4, 3, 2, gen, device)
        self.C3_n4 = CSPLayer(2 * c4, c5, depth, gen, device)

    def forward(self, x3, x4, x5):
        fpn_out0 = self.lateral_conv0(x5)
        f_out0 = self.C3_p4(torch.cat([_up(fpn_out0), x4], 1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(torch.cat([_up(fpn_out1), x3], 1))
        pan_out1 = self.C3_n3(torch.cat([self.bu_conv2(pan_out2), fpn_out1], 1))
        pan_out0 = self.C3_n4(torch.cat([self.bu_conv1(pan_out1), fpn_out0], 1))
        return pan_out2, pan_out1, pan_out0


class YOLOXHead(nn.Module):
    """YOLOX's decoupled head: per level a 1x1 stem, two 3x3 BaseConvs in
    each of the class and box branches, 1x1 predictions (box 4, objectness
    1, classes)."""

    def __init__(self, dims: Sequence[int], width: int, classes: int, gen, device):
        super().__init__()

        def branch():
            return nn.Sequential(BaseConv(width, width, 3, 1, gen, device),
                                 BaseConv(width, width, 3, 1, gen, device))

        self.stems = nn.ModuleList(BaseConv(c, width, 1, 1, gen, device) for c in dims)
        self.cls_convs = nn.ModuleList(branch() for _ in dims)
        self.reg_convs = nn.ModuleList(branch() for _ in dims)
        self.cls_preds = nn.ModuleList(Conv2d(width, classes, 1, gen, device) for _ in dims)
        self.reg_preds = nn.ModuleList(Conv2d(width, 4, 1, gen, device) for _ in dims)
        self.obj_preds = nn.ModuleList(Conv2d(width, 1, 1, gen, device) for _ in dims)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """The levels' features -> raw (B, anchors, 5 + classes), the
        anchors level by level, row-major within a level."""
        outs = []
        for i, x in enumerate(feats):
            x = self.stems[i](x)
            c, r = self.cls_convs[i](x), self.reg_convs[i](x)
            out = torch.cat([self.reg_preds[i](r), self.obj_preds[i](r), self.cls_preds[i](c)], 1)
            outs.append(out.flatten(2))
        return torch.cat(outs, 2).permute(0, 2, 1)


class RVT(nn.Module):
    """RVT-B with YOLOX's PAFPN and head; see the module's docstring.

    ``sensor_hw``, ``frame_hw`` and ``partition`` default to the published
    setting; a smaller frame needs each stage's map divisible by the
    partition (the frame by 32 x ``partition``)."""

    def __init__(self, generator: Optional[torch.Generator] = None, device: DeviceLike = None,
                 sensor_hw: Tuple[int, int] = SENSOR_HW, frame_hw: Tuple[int, int] = FRAME_HW,
                 partition: Tuple[int, int] = PARTITION):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.frame_hw = tuple(frame_hw)
        self.stream_io = StreamIO(time_bins=TIME_BINS, sensor_hw=tuple(sensor_hw),
                                  frame_hw=self.frame_hw, downsample=2, clip=COUNT_CLIP,
                                  quantile_scale=False)
        dims = (2 * TIME_BINS,) + STAGE_DIMS
        self.stages = nn.ModuleList(Stage(s + 1, dims[s], dims[s + 1], partition, gen, dev)
                                    for s in range(len(STAGE_DIMS)))
        fpn_dims = tuple(STAGE_DIMS[s - 1] for s in FPN_STAGES)
        self.fpn = PAFPN(fpn_dims, FPN_DEPTH, gen, dev)
        self.head = YOLOXHead(fpn_dims, HEAD_WIDTH, NUM_CLASSES, gen, dev)
        self._grids: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def load_params(self, params: Params) -> "RVT":
        """Load a state_dict; every key must match, except BatchNorm's
        counters, which inference does not read."""
        counters = {k: v for k, v in self.state_dict().items()
                    if k.endswith("num_batches_tracked")}
        self.load_state_dict({**counters, **params}, strict=True)
        return self

    def map_hw(self, stage: int) -> Tuple[int, int]:
        """The (H, W) of stage ``stage``'s (1-4) map."""
        stride = 2 ** (stage + 1)
        return self.frame_hw[0] // stride, self.frame_hw[1] // stride

    def init_hidden(self, streams: Optional[int] = None) -> State:
        """Zero (h, c) of each stage's LSTM, (B, C, H_s, W_s) with B =
        ``streams`` or 1, on the module's device."""
        dev = self.head.stems[0].conv.weight.device
        B = 1 if streams is None else streams
        return tuple((torch.zeros(B, C, *self.map_hw(s + 1), device=dev),
                      torch.zeros(B, C, *self.map_hw(s + 1), device=dev))
                     for s, C in enumerate(STAGE_DIMS))

    def _grid(self, feats, device):
        """(grid (anchors, 2) of (x, y) cells, stride (anchors, 1)) of the
        levels' shapes, made once per shape."""
        key = tuple(f.shape[-2:] for f in feats) + (device,)
        if key not in self._grids:
            self._grids[key] = self._make_grid(feats, device)
        return self._grids[key]

    def _make_grid(self, feats, device):
        # ordinary tensors even under inference_mode: the cache outlives the call
        with torch.inference_mode(False), torch.no_grad():
            grids, strides = [], []
            for f in feats:
                h, w = f.shape[-2:]
                ys, xs = torch.meshgrid(torch.arange(h, device=device),
                                        torch.arange(w, device=device), indexing="ij")
                grids.append(torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32))
                strides.append(torch.full((h * w, 1), float(self.frame_hw[0] // h),
                                          device=device))
            return torch.cat(grids), torch.cat(strides)

    @with_precision
    def forward(self, frame: torch.Tensor, hidden: Optional[State] = None):
        """frame (B, 2T, H, W) stacked histograms; hidden each stage's (h, c),
        None for zeros.  Returns (raw (B, anchors, 5 + classes), decoded
        (B, anchors, 5 + classes), the new hidden state)."""
        if hidden is None:
            hidden = self.init_hidden(frame.shape[0])
        x, new_hidden, feats = frame, [], []
        for stage, state in zip(self.stages, hidden):
            x, hc = stage(x, state)
            new_hidden.append(hc)
            feats.append(x)
        with profiling.span("evfly.rvt.head"):
            levels = self.fpn(*(feats[s - 1] for s in FPN_STAGES))
            raw = self.head(levels)
            grid, stride = self._grid(levels, raw.device)
            decoded = torch.cat([(raw[..., :2] + grid) * stride,
                                 torch.exp(raw[..., 2:4]) * stride,
                                 torch.sigmoid(raw[..., 4:])], -1)
        return raw, decoded, tuple(new_hidden)

    def stream(self, frame: torch.Tensor, hidden: State, desvel=None):
        """One streaming step of one stream: frame (2T, H, W) -> ((decoded
        (anchors, 5 + classes), raw (anchors, 5 + classes)), new state);
        ``desvel`` is not read."""
        raw, decoded, new_hidden = self(frame[None], hidden)
        return (decoded[0], raw[0]), new_hidden


def layer_counts(model: RVT) -> List[Tuple[str, int]]:
    """(part, trained parameters) of the backbone, the FPN and the head."""
    return part_param_counts(model, {"backbone": "stages", "fpn": "fpn", "head": "head"})
