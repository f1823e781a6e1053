"""MixFFN's grouped 3x3 convolution, bias and exact GELU as one CUDA kernel.

``models.vit.MixFFN`` runs mlp1, a 3x3 convolution with 8 channels in and 8
out a group (groups = the block's channels, not the expanded width: the
reference's quirk) and "same" padding, exact GELU, then mlp2.  On the card
cuDNN has no fast f32 engine for that grouping, so ``dwconv3x3_gelu`` runs
the convolution, its bias and the GELU in one hand-written kernel
(``csrc/dwconv.cu``, ``mixffn_dwconv3x3_gelu_kernel``) that reads and writes
the (B, N, C) tokens as mlp1 and mlp2 hold them.  It replaces no Pallas
kernel: the JAX package leaves this convolution to XLA.

The route is decided from what the call shows: CPU tensors, a call that
needs a gradient (the kernel has no backward) and any dtype but f32 take the
plain version, ``dwconv3x3_gelu_plain`` (exactly MixFFN's formulation of
before: ``F.conv2d`` then ``gelu_exact``); every other CUDA call launches the
kernel, which raises on what it does not take.  ``dwconv3x3_gelu.launches``
counts launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import _build, imageops

GROUP_CHANNELS = 8  # channels in and out of each group the kernel takes
ROWS = 4            # output rows a thread computes (kRows in csrc/dwconv.cu)
MAX_THREADS = 256   # threads a block (kMaxThreads)
# A tile holds up to 4 groups (a pixel's 128 contiguous bytes) and about
# three warps of work: at V(phi)'s serving shapes the fastest tiles on the
# H100 (PERF.md)
MAX_TILE_GROUPS = 4
TILE_WORK = 96
# a block may opt in to 227 KB (232,448 bytes) of shared memory; keep 1 KiB
_SMEM_LIMIT = 232448 - 1024


class Tile(NamedTuple):
    """A block's tile: ``groups`` groups of one image over a band of
    ``rows`` rows, with ``threads`` threads."""
    groups: int
    rows: int
    threads: int


def _row_blocks(rows: int) -> int:
    return -(-rows // ROWS)


def tile_cells(rows: int, W: int) -> int:
    """Cells of a tile's zero-padded input for bands of ``rows`` rows: (row
    blocks * ROWS + 2) rows of W + 2 (``tile_cells`` in csrc/dwconv.cu)."""
    return (_row_blocks(rows) * ROWS + 2) * (W + 2)


def cell_floats(groups: int) -> int:
    """Floats a cell takes in shared memory: the tile's channels and 4 more
    (``cell_floats``)."""
    return groups * GROUP_CHANNELS + 4


def smem_bytes(groups: int, rows: int, W: int) -> int:
    """Shared memory of a block: its groups' weights and two buffers of a
    tile's input (the tile it sums and the next, on its way)."""
    weights = GROUP_CHANNELS * GROUP_CHANNELS * 9
    return 4 * (groups * weights + 2 * tile_cells(rows, W) * cell_floats(groups))


@functools.lru_cache(maxsize=64)
def choose_tile(B: int, H: int, W: int, groups: int, sms: int) -> Tile:
    """The kernel's tile for B images of H x W with ``groups`` groups on a
    card of ``sms`` SMs: as many groups (a power of two up to
    ``MAX_TILE_GROUPS``) and then as many rows (a multiple of ``ROWS``, or
    the whole image) as keep a tile's items (one a thread: a column of
    ``ROWS`` rows of a group) within ``TILE_WORK``; then, while there are
    fewer than two tiles an SM, bands of half as many rows, down to
    ``ROWS``, and after that half as many groups.  Raises where even one
    group over ``ROWS`` rows does not fit in shared memory."""
    items = lambda g, rows: g * _row_blocks(rows) * W  # noqa: E731
    tile_groups, rows = 1, min(H, ROWS) if H else 1
    while (tile_groups * 2 <= min(groups, MAX_TILE_GROUPS)
           and items(tile_groups * 2, rows) <= TILE_WORK):
        tile_groups *= 2
    while rows < H and items(tile_groups, min(H, rows + ROWS)) <= TILE_WORK:
        rows = min(H, rows + ROWS)
    tiles = lambda: B * -(-H // rows) * -(-groups // tile_groups)  # noqa: E731
    while tiles() < 2 * sms:
        if rows > ROWS:
            rows = ROWS * -(-_row_blocks(rows) // 2)
        elif tile_groups > 1:
            tile_groups //= 2
        else:
            break
    if smem_bytes(tile_groups, rows, W) > _SMEM_LIMIT:
        raise ValueError(f"dwconv3x3_gelu: a {H}x{W} image is too wide for the kernel's tile")
    threads = min(MAX_THREADS, -(-items(tile_groups, rows) // 32) * 32)
    return Tile(tile_groups, rows, threads)


def dwconv3x3_gelu_plain(tokens: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor], H: int, W: int) -> torch.Tensor:
    """GELU(grouped 3x3 conv(tokens) + bias) as (B, N, C), N = H * W, with
    ``F.conv2d`` ("same" padding, groups = C / weight.shape[1]) and
    ``imageops.gelu_exact``: MixFFN's formulation."""
    B, N, C = tokens.shape
    x = imageops.conv2d(tokens.transpose(1, 2).reshape(B, C, H, W), weight, bias, 1, "same",
                        C // weight.shape[1])
    return imageops.gelu_exact(x.reshape(B, C, N).transpose(1, 2))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def kernel_takes(tokens: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> bool:
    """Whether ``dwconv3x3_gelu`` launches the kernel: a CUDA call in f32
    that needs no gradient.  Any other call takes the plain version."""
    return (tokens.device.type == "cuda" and not _needs_grad(tokens, weight, bias)
            and all(t is None or t.dtype == torch.float32 for t in (tokens, weight, bias)))


def dwconv3x3_gelu(tokens: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                   H: int, W: int) -> torch.Tensor:
    """GELU(grouped 3x3 conv(tokens) + bias) as (B, N, C), from the (B, N, C)
    tokens, the OIHW weight (C, C / groups, 3, 3) and the bias (C,) or None.

    Calls that ``kernel_takes`` launch ``mixffn_dwconv3x3_gelu_kernel``
    (``dwconv3x3_gelu_cuda``); the others take ``dwconv3x3_gelu_plain``.
    ``dwconv3x3_gelu.launches`` counts launches."""
    if kernel_takes(tokens, weight, bias):
        return dwconv3x3_gelu_cuda(tokens, weight, bias, H, W)
    return dwconv3x3_gelu_plain(tokens, weight, bias, H, W)


dwconv3x3_gelu.launches = 0


def dwconv3x3_gelu_cuda(tokens: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], H: int, W: int) -> torch.Tensor:
    """The kernel's launch: f32 CUDA tensors, 8 channels a group, no
    gradient; raises on anything else."""
    name = "dwconv3x3_gelu"
    if tokens.dim() != 3:
        raise ValueError(f"{name}: tokens must be (B, N, C), got {tuple(tokens.shape)}")
    B, N, C = tokens.shape
    expected = {"tokens": (tokens, (B, H * W, C)),
                "weight": (weight, (C, GROUP_CHANNELS, 3, 3)),
                "bias": (bias, (C,))}
    for arg, (t, shape) in expected.items():
        if t is None:
            continue
        if tuple(t.shape) != shape or t.device != tokens.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)} on {t.device}, expected {shape} "
                             f"on a CUDA device ({GROUP_CHANNELS} channels a group)")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} is {t.dtype}; the kernel takes float32 only")
    if C % GROUP_CHANNELS:
        raise ValueError(f"{name}: C = {C} is not a multiple of {GROUP_CHANNELS}")
    if _needs_grad(tokens, weight, bias):
        raise RuntimeError(f"{name} has no backward; call it under torch.no_grad()")
    tokens, weight = tokens.contiguous(), weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    if tokens.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError(f"{name}: tokens and weight must be 16-byte aligned (the kernel's "
                         "float4 loads)")
    sms = torch.cuda.get_device_properties(tokens.device).multi_processor_count
    tile = choose_tile(B, H, W, C // GROUP_CHANNELS, sms)
    out = torch.empty(B, N, C, dtype=torch.float32, device=tokens.device)
    with torch.cuda.device(tokens.device):
        status = _build.library().evfly_dwconv3x3_gelu(
            tokens.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, H, W, C, tile.groups, tile.rows, tile.threads,
            _build.stream_of(tokens.device))
    _build.check(name, status)
    dwconv3x3_gelu.launches += 1
    return out
