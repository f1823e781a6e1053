"""E-RAFT, dense optical flow from event cameras, for inference.

Gehrig, Millhaeusler, Gehrig and Scaramuzza, "E-RAFT: Dense Optical Flow
from Event Cameras", 3DV 2021 (arXiv:2108.10552, github.com/uzh-rpg/E-RAFT):
RAFT (Teed and Deng, ECCV 2020) over event voxel grids, in its warm-start
form on DSEC-Flow (a 640x480 camera, flow every 100 ms).  One streaming step
takes one window of events and the state carried from the last window, and
gives the window's flow at full resolution.

* Input: E-RAFT's voxel grid of the window (``ops.voxelizer.voxel_grid``):
  the events rectified through a (480, 640, 2) map, T = 15 time bins,
  trilinear, signed, normalised over the nonzero cells.
* Encoders, RAFT's ``BasicEncoder`` of 15 input channels: a 7x7 stride-2
  convolution to 64, norm, ReLU; two residual blocks at each of 64, 96
  (stride 2) and 128 (stride 2); a 1x1 convolution to 256.  ``fnet`` (instance
  norm without affine parameters) runs on both grids, the previous window's
  and the current one; ``cnet`` (BatchNorm, eval) on the current grid,
  split into ``net = tanh`` of the first 128 channels and ``inp = ReLU`` of
  the rest.
* Correlation: ``fmap1^T fmap2 / sqrt(256)`` over the 60x80 positions at 1/8
  resolution, (4800, 1, 60, 80), and three ``avg_pool2d(2, 2)`` levels below
  it (30x40, 15x20, 7x10).
* Lookup at ``coords1``, radius 4: level i sampled bilinearly
  (``grid_sample``, ``align_corners=True``, zero padding) at ``coords1 / 2^i
  + delta``; level i's channel ``81 i + 9 a + b`` is the sample at x offset
  ``a - 4`` and y offset ``b - 4`` (RAFT's ``stack(meshgrid(dy, dx), -1)``
  added to (x, y)), 324 channels.
* ``ITERATIONS`` = 12 weight-shared updates (RAFT's ``BasicUpdateBlock``):
  the motion encoder (``convc1``, ``convc2`` over the lookup, ``convf1``,
  ``convf2`` over the flow, ``conv``; ReLU after each; its output with the
  flow, 128 channels), a separable ConvGRU of hidden size 128 over ``[inp,
  motion]`` (1x5, then 5x1), the flow head's correction added to
  ``coords1``.
* Convex upsampling by 8 of the last 1/8 flow: ``0.25 mask(net)``, a softmax
  over 9 neighbours for each of 64 sub-pixels.
* Warm start (RAFT's ``forward_interpolate``, on the device): each source
  pixel of the last 1/8 flow displaced to ``(x + dx, y + dy)`` and kept where
  ``0 < x1 < 80`` and ``0 < y1 < 60``; each target pixel takes the flow of
  the nearest kept source (squared distance ``ex ex + ey ey`` in separate
  operations, so never a fused multiply-add; ties to the lowest source
  index), zeros where no source is kept.

Departures from the published model: the mask head and the upsampling run
after the last iteration only (inference reads only the last upsampled
flow, which they give alike); the warm start's nearest neighbour is found
on the device in f32, not by scipy's ``griddata`` (a host KD-tree) in f64.

Streaming (``stream``): the state is (the previous window's voxel grid, the
1/8 ``init`` flow, windows seen clamped at 2, counters).  A stream's first
window yields no flow (``valid`` 0, zero flows); the second starts cold
(``init`` 0), as E-RAFT's first sample of a sequence; every later window
starts from the warm start of the last.  All three cases are masks in one
step, with no host branch, so a CUDA graph captures it.  The counters are
windows, cold starts and warm starts since the last reset (``stats``).

While a profiler records, the layers are spans (``utils.profiling``):
``evfly.eraft.encode`` (fnet twice, cnet), ``evfly.eraft.corr`` (the GEMM
and the pyramid), ``evfly.eraft.refine`` (the iterations; counts
``iterations`` and ``gru_kernel``, 1 where the ConvGRU runs as
``ops.sepconvgru``'s kernels) holding each iteration's
``evfly.eraft.lookup`` (counts ``levels``, ``radius``, ``positions``),
``evfly.eraft.upsample`` (the mask head and the convex upsampling),
``evfly.eraft.warm`` (the forward interpolation; count ``warm`` 1: the step
carries its flow to the next window); inside a captured CUDA graph they
are its marks.

Module names follow RAFT's (``fnet``, ``cnet``, ``update_block.encoder``,
``.gru``, ``.flow_head``, ``.mask``), so that E-RAFT's checkpoint loads by
name; the rectification map is a buffer outside the state_dict.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import imageops, sepconvgru
from ..precision import with_precision
from ..utils import profiling
from .common import BatchNorm2d, Conv2d, Params, StreamIO, part_param_counts

BINS = 15
SENSOR_HW = (480, 640)
FEATURE_DIM = 256
HIDDEN_DIM = 128
CONTEXT_DIM = 128
LEVELS = 4
RADIUS = 4
ITERATIONS = 12
STRIDE = 8

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class InstanceNorm(nn.Module):
    """torch nn.InstanceNorm2d without affine parameters or running
    statistics (eps 1e-5): nothing in the state_dict."""

    def forward(self, x):
        return F.instance_norm(x, eps=1e-5)


class BatchNorm(BatchNorm2d):
    """nn.BatchNorm2d's state, applied from its running statistics in one
    call (cuDNN's inference kernel on the card)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, 1e-5)


def _norm(kind: str, dim: int, device) -> nn.Module:
    return BatchNorm(dim, device) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    """RAFT's ResidualBlock: conv3x3, norm, ReLU, conv3x3, norm, ReLU; a
    strided block's shortcut a strided 1x1 conv and ``norm3`` (registered
    as ``downsample.1`` too, as RAFT's state_dict has it); ReLU(x + y)."""

    def __init__(self, cin: int, dim: int, norm: str, stride: int, gen, device):
        super().__init__()
        self.conv1 = Conv2d(cin, dim, 3, gen, device, stride=stride, padding=1)
        self.conv2 = Conv2d(dim, dim, 3, gen, device, padding=1)
        self.norm1, self.norm2 = _norm(norm, dim, device), _norm(norm, dim, device)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm, dim, device)
            self.downsample = nn.Sequential(Conv2d(cin, dim, 1, gen, device, stride=stride),
                                            self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Encoder(nn.Module):
    """RAFT's BasicEncoder (dropout 0) of ``BINS`` input channels."""

    def __init__(self, out_dim: int, norm: str, gen, device, in_dim: int = BINS):
        super().__init__()
        self.conv1 = Conv2d(in_dim, 64, 7, gen, device, stride=2, padding=3)
        self.norm1 = _norm(norm, 64, device)
        layers, cin = [], 64
        for dim, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(ResidualBlock(cin, dim, norm, stride, gen, device),
                                        ResidualBlock(dim, dim, norm, 1, gen, device)))
            cin = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = Conv2d(128, out_dim, 1, gen, device)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class MotionEncoder(nn.Module):
    """RAFT's BasicMotionEncoder: (flow, lookup) -> 128 channels."""

    def __init__(self, gen, device):
        super().__init__()
        planes = LEVELS * (2 * RADIUS + 1) ** 2
        self.convc1 = Conv2d(planes, 256, 1, gen, device)
        self.convc2 = Conv2d(256, 192, 3, gen, device, padding=1)
        self.convf1 = Conv2d(2, 128, 7, gen, device, padding=3)
        self.convf2 = Conv2d(128, 64, 3, gen, device, padding=1)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, gen, device, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], 1))), flow], 1)


class SepConvGRU(nn.Module):
    """RAFT's SepConvGRU: a ConvGRU with 1x5 convolutions, then one with 5x1.
    On the card in f32 without autograd each half-step is two hand-written
    kernels (``ops.sepconvgru``), else the plain formulation.  The kernels'
    packed weights are packed again after each ``load_state_dict``, into the
    tensors a captured step reads."""

    def __init__(self, gen, device, hidden: int = HIDDEN_DIM, inputs: int = 128 + HIDDEN_DIM):
        super().__init__()
        for i, (k, pad) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))), 1):
            for gate in "zrq":
                setattr(self, f"conv{gate}{i}",
                        Conv2d(hidden + inputs, hidden, k, gen, device, padding=pad))
        self._packed = sepconvgru.WeightCache()
        self.register_load_state_dict_post_hook(_repack_gru)

    def halves(self) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """(wz, bz, wr, br, wq, bq) of the 1x5 half-step, then the 5x1's."""
        convs = [[getattr(self, f"conv{gate}{i}") for gate in "zrq"] for i in (1, 2)]
        return tuple(tuple(t for c in half for t in (c.weight, c._bias())) for half in convs)

    def forward(self, h, x):
        return sepconvgru.sepconvgru(h, x, self.halves(), self._packed)


def _repack_gru(gru: SepConvGRU, incompatible_keys) -> None:
    gru._packed.refresh(gru.halves())


class FlowHead(nn.Module):
    def __init__(self, gen, device, inputs: int = HIDDEN_DIM, hidden: int = 256):
        super().__init__()
        self.conv1 = Conv2d(inputs, hidden, 3, gen, device, padding=1)
        self.conv2 = Conv2d(hidden, 2, 3, gen, device, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    """RAFT's BasicUpdateBlock; ``mask`` is its upsampling mask head."""

    def __init__(self, gen, device):
        super().__init__()
        self.encoder = MotionEncoder(gen, device)
        self.gru = SepConvGRU(gen, device)
        self.flow_head = FlowHead(gen, device)
        self.mask = nn.Sequential(Conv2d(HIDDEN_DIM, 256, 3, gen, device, padding=1),
                                  nn.ReLU(), Conv2d(256, STRIDE * STRIDE * 9, 1, gen, device))

    def forward(self, net, inp, corr, flow):
        """-> (new net, the flow's correction)."""
        net = self.gru(net, torch.cat([inp, self.encoder(flow, corr)], 1))
        return net, self.flow_head(net)


# ------------------------------------------------------------ the layers

def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int = LEVELS
                 ) -> List[torch.Tensor]:
    """RAFT's CorrBlock pyramid: (B, D, h, w) each -> ``levels`` tensors
    (B h w, 1, h / 2^i, w / 2^i), the all-pairs dot products over sqrt(D)."""
    B, D, h, w = fmap1.shape
    corr = torch.matmul(fmap1.view(B, D, h * w).transpose(1, 2), fmap2.view(B, D, h * w))
    corr = (corr / math.sqrt(D)).view(B * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(levels - 1):
        pyramid.append(imageops.avg_pool2d(pyramid[-1], 2, 2))
    return pyramid


def lookup(pyramid: List[torch.Tensor], coords: torch.Tensor, delta: torch.Tensor
           ) -> torch.Tensor:
    """RAFT's CorrBlock lookup: coords (B, 2, h, w) of (x, y) at 1/8, delta
    (1, 2r + 1, 2r + 1, 2) -> (B, levels (2r + 1)^2, h, w)."""
    B, _, h, w = coords.shape
    k = delta.shape[1]
    centre = coords.permute(0, 2, 3, 1).reshape(B * h * w, 1, 1, 2)
    out = []
    for i, level in enumerate(pyramid):
        H, W = level.shape[-2:]
        at = centre / 2 ** i + delta
        grid = torch.cat([2 * at[..., :1] / (W - 1) - 1, 2 * at[..., 1:] / (H - 1) - 1], -1)
        sampled = F.grid_sample(level, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=True)
        out.append(sampled.view(B, h, w, k * k))
    return torch.cat(out, -1).permute(0, 3, 1, 2).contiguous()


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT's upsample_flow: flow (B, 2, h, w), mask (B, 9 S^2, h, w), S =
    ``STRIDE`` -> (B, 2, S h, S w), each sub-pixel a softmax-weighted mean of
    the 3x3 neighbourhood of ``S flow``."""
    B, _, h, w = flow.shape
    mask = torch.softmax(mask.view(B, 1, 9, STRIDE, STRIDE, h, w), dim=2)
    up = F.unfold(STRIDE * flow, [3, 3], padding=1).view(B, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, STRIDE * h, STRIDE * w)


def forward_interpolate(flow: torch.Tensor) -> torch.Tensor:
    """RAFT's forward_interpolate of flow (B, 2, h, w) on the device, exact
    for a given input (see the module's docstring): every target against
    every source, (B, h w, h w) distances."""
    B, _, h, w = flow.shape
    N = h * w
    dev = flow.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    x0, y0 = xs.reshape(1, N), ys.reshape(1, N)
    dx, dy = flow[:, 0].reshape(B, N), flow[:, 1].reshape(B, N)
    x1, y1 = x0 + dx, y0 + dy
    kept = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
    ex = x0[:, :, None] - x1[:, None, :]
    ey = y0[:, :, None] - y1[:, None, :]
    exx = ex * ex
    eyy = ey * ey
    dist = torch.where(kept[:, None, :], exx + eyy, torch.inf)
    nearest = dist.amin(2, keepdim=True)
    source = torch.arange(N, device=dev, dtype=torch.int32)
    first = torch.where(dist == nearest, source, N).amin(2).clamp_(max=N - 1).long()
    out = torch.stack([dx.gather(1, first), dy.gather(1, first)], 1)
    return torch.where(kept.any(1)[:, None, None], out, 0.0).view(B, 2, h, w)


class ERAFT(nn.Module):
    """E-RAFT with RAFT's widths; see the module's docstring.

    ``sensor_hw`` defaults to DSEC's 480x640; a smaller frame needs each side
    divisible by 8 and a 1/8 map of at least 16x16 (the lookup normalises a
    level's coordinates by its side less one, so the pyramid's last level
    needs two cells a side).  ``rectify_map`` (H, W, 2), the
    rectified (x, y) of each sensor pixel, defaults to the identity
    (``set_rectify_map`` replaces it in place)."""

    def __init__(self, generator: Optional[torch.Generator] = None, device: DeviceLike = None,
                 sensor_hw: Tuple[int, int] = SENSOR_HW):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        H, W = self.sensor_hw = tuple(sensor_hw)
        self.fnet = Encoder(FEATURE_DIM, "instance", gen, dev)
        self.cnet = Encoder(HIDDEN_DIM + CONTEXT_DIM, "batch", gen, dev)
        self.update_block = UpdateBlock(gen, dev)
        ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                                torch.arange(W, dtype=torch.float32), indexing="ij")
        self.register_buffer("rectify_map", torch.stack([xs, ys], -1).to(dev), persistent=False)
        self._grids: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def stream_io(self) -> StreamIO:
        """A voxel grid of the sensor's events through ``rectify_map``."""
        return StreamIO(time_bins=BINS, sensor_hw=self.sensor_hw, frame_hw=self.sensor_hw,
                        quantile_scale=False, rectify_map=self.rectify_map)

    def load_params(self, params: Params) -> "ERAFT":
        """Load a state_dict; every key must match, except BatchNorm's
        counters, which inference does not read."""
        counters = {k: v for k, v in self.state_dict().items()
                    if k.endswith("num_batches_tracked")}
        self.load_state_dict({**counters, **params}, strict=True)
        return self

    def set_rectify_map(self, rectify_map: torch.Tensor) -> "ERAFT":
        """Copy (H, W, 2) rectified (x, y) into the map a captured step reads."""
        with torch.no_grad():
            self.rectify_map.copy_(rectify_map)
        return self

    def init_hidden(self, streams: Optional[int] = None) -> State:
        """Zero state of one stream (``streams`` None or 1): the previous
        voxel grid (BINS, H, W), ``init`` (1, 2, H/8, W/8), windows seen (an
        int64 scalar, clamped at 2), the counters (3,) int64."""
        if streams not in (None, 1):
            raise ValueError("E-RAFT streams one camera")
        dev = self.rectify_map.device
        H, W = self.sensor_hw
        return (torch.zeros(BINS, H, W, device=dev),
                torch.zeros(1, 2, H // STRIDE, W // STRIDE, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros(3, dtype=torch.int64, device=dev))

    @staticmethod
    def stats(hidden: State) -> Dict[str, int]:
        """Windows, cold starts and warm starts since the last reset."""
        windows, cold, warm = hidden[3].tolist()
        return {"windows": windows, "cold_starts": cold, "warm_starts": warm}

    def _grid(self, h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(coords0 (1, 2, h, w) of the pixels' (x, y), the lookup's delta),
        made once per shape."""
        key = (h, w, device)
        if key not in self._grids:
            # ordinary tensors even under inference_mode: the cache outlives the call
            with torch.inference_mode(False), torch.no_grad():
                ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                                        torch.arange(w, device=device, dtype=torch.float32),
                                        indexing="ij")
                d = torch.arange(-RADIUS, RADIUS + 1, device=device, dtype=torch.float32)
                delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)
                self._grids[key] = (torch.stack([xs, ys])[None], delta[None])
        return self._grids[key]

    @with_precision
    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                flow_init: Optional[torch.Tensor] = None):
        """image1, image2 (B, BINS, H, W) voxel grids of the earlier and the
        later window, flow_init (B, 2, H/8, W/8) or None -> (the 1/8 flow
        after the last iteration, its convex upsampling (B, 2, H, W))."""
        B = image1.shape[0]
        with profiling.span("evfly.eraft.encode"):
            fmap1, fmap2 = self.fnet(torch.cat([image1, image2])).split(B)
            net, inp = self.cnet(image2).split([HIDDEN_DIM, CONTEXT_DIM], 1)
            net, inp = torch.tanh(net), F.relu(inp)
        with profiling.span("evfly.eraft.corr"):
            pyramid = corr_pyramid(fmap1, fmap2)
        h, w = fmap1.shape[-2:]
        coords0, delta = self._grid(h, w, fmap1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        gru = self.update_block.gru
        with profiling.span("evfly.eraft.refine", iterations=ITERATIONS,
                            gru_kernel=int(sepconvgru.kernel_takes(net, inp, gru.halves()))):
            for _ in range(ITERATIONS):
                with profiling.span("evfly.eraft.lookup", levels=LEVELS, radius=RADIUS,
                                    positions=B * h * w):
                    corr = lookup(pyramid, coords1, delta)
                net, delta_flow = self.update_block(net, inp, corr, coords1 - coords0)
                coords1 = coords1 + delta_flow
        with profiling.span("evfly.eraft.upsample"):
            flow_low = coords1 - coords0
            flow_up = convex_upsample(flow_low, 0.25 * self.update_block.mask(net))
        return flow_low, flow_up

    def stream(self, frame: torch.Tensor, hidden: State, desvel=None):
        """One streaming step of one camera: frame (BINS, H, W), this
        window's voxel grid -> ((flow (1, 2, H, W), flow_low (1, 2, H/8,
        W/8), valid (1,) f32), new state); ``desvel`` is not read."""
        previous, init, seen, counters = hidden
        valid, warm = seen >= 1, seen >= 2
        flow_low, flow_up = self(previous[None], frame[None], torch.where(warm, init, 0.0))
        flow_low = torch.where(valid, flow_low, 0.0)
        flow_up = torch.where(valid, flow_up, 0.0)
        with profiling.span("evfly.eraft.warm", warm=1):
            new_init = forward_interpolate(flow_low)
        started = torch.stack([torch.ones_like(seen), (valid & ~warm).long(), warm.long()])
        outputs = (flow_up, flow_low, valid.to(torch.float32).reshape(1))
        return outputs, (frame, new_init, (seen + 1).clamp(max=2), counters + started)


def layer_counts(model: ERAFT) -> List[Tuple[str, int]]:
    """(part, trained parameters) of fnet, cnet and the update block
    (``norm3``, also ``downsample.1``, counted once)."""
    return part_param_counts(model, {p: p for p in ("fnet", "cnet", "update_block")})
