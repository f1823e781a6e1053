"""E-RAFT's separable ConvGRU as two CUDA kernels a half-step.

``models.eraft.SepConvGRU`` (RAFT's) runs a ConvGRU with 1x5 convolutions,
then one with 5x1, each over ``[h, x]`` (128 hidden and 256 input channels)
to 128 channels.  On the card cuDNN ran them as a 32x32-tile implicit GEMM
at about a quarter of the f32 peak, with the concatenations, sigmoids, tanh
and the update as separate kernels.  ``sepconvgru`` runs each half-step as
two hand-written kernels (``csrc/sepconvgru.cu``): ``sepconvgru_zr_conv_kernel``
(z and r as one GEMM of 256 output channels; it writes z and r h) and
``sepconvgru_q_conv_kernel`` (q over [r h, x]; it writes the new h).  Both
read h, r h and x in place in NCHW.  They replace no Pallas kernel: the JAX
package has no E-RAFT.

The route is decided from what the call shows: CPU tensors, a call that
needs a gradient (the kernels have no backward) and any dtype but f32 take
the plain version, ``sepconvgru_plain`` (exactly SepConvGRU's formulation of
before: ``F.conv2d``, ``torch.cat``, sigmoid, tanh); every other CUDA call
launches the kernels, which raise on what they do not take.
``sepconvgru.launches`` counts kernel launches (four a call).

The kernels read the weights packed (``pack``): z's and r's stacked, taps
next to the input channels, output channels innermost.  A ``WeightCache``
packs them at the first call that launches the kernels and again only after
a weight changes, never at a graph's replay, into the tensors it packed
before, so that a captured graph replays the new weights.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build, imageops

TAPS = 5             # a half-step's kernel: (1, 5) or (5, 1)
HALO = 2             # (TAPS - 1) / 2 positions on each side
CHANNELS = 4         # output channels a thread (kTN in csrc/sepconvgru.cu)
# by axis (1x5, 5x1): the positions a thread (places in csrc/sepconvgru.cu:
# a 1x5 line is padded to a multiple of 20) and the lines a thread
# (lines_a_thread: a 5x1 thread holds a float4 of neighbouring columns)
PLACES = (20, 4)
LINES_A_THREAD = (1, 4)
MAX_THREADS = 512    # threads a block (kMaxThreads): 128 registers a thread
# a block may opt in to 227 KB (232,448 bytes) of shared memory; keep 1 KiB
_SMEM_LIMIT = 232448 - 1024

# (wz, bz, wr, br, wq, bq) of one half-step: OIHW weights (C_h, C_h + C_x, 1,
# 5) or (C_h, C_h + C_x, 5, 1), biases (C_h,)
Half = Tuple[torch.Tensor, ...]


class Tile(NamedTuple):
    """A launch's tile: a block of ``lines`` lines (rows for 1x5, columns for
    5x1, a multiple of 4) by ``positions`` positions along the axis (a
    multiple of ``PLACES``) by ``channels`` output channels; ``k_groups``
    groups of threads splitting each chunk of ``chunk`` input channels;
    ``warp_lines`` neighbouring place groups (lines or column quads) of one
    channel group a run of threads."""
    lines: int
    positions: int
    channels: int
    k_groups: int
    chunk: int
    warp_lines: int


class Packed(NamedTuple):
    """One half-step's weights as the kernels read them."""
    axis: int            # 0: (1, 5) along W; 1: (5, 1) along H
    w_zr: torch.Tensor   # (C_h + C_x, 5, 2 C_h): z's output channels, then r's
    b_zr: torch.Tensor   # (2 C_h,)
    w_q: torch.Tensor    # (C_h + C_x, 5, C_h)
    b_q: torch.Tensor    # (C_h,)


def line_stride(positions: int) -> int:
    """1x5: floats of a staged line, positions + 8, or 4 more where that is a
    multiple of 8 (``line_stride`` in csrc/sepconvgru.cu)."""
    ls = positions + 4 * HALO
    return ls + 4 if ls % 8 == 0 else ls


def row_stride(lines: int) -> int:
    """5x1: floats of a staged row, the lines padded to a multiple of 4."""
    return -(-lines // 4) * 4


def threads(tile: Tile, axis: int) -> int:
    """Threads of a block: K groups x place groups x channel groups."""
    return tile.k_groups * _place_groups(tile, axis) * (tile.channels // CHANNELS)


def _place_groups(tile: Tile, axis: int) -> int:
    return tile.lines // LINES_A_THREAD[axis] * (tile.positions // PLACES[axis])


def smem_bytes(tile: Tile, axis: int, W: int) -> int:
    """Shared memory of a block along ``axis`` in an image W wide: two
    buffers (a chunk's slab and weights) and the table of a channel's staged
    units; after the sums, the K groups' partial sums and the tile of
    outputs (``evfly_sepconvgru_conv``)."""
    bl, bp, bn, ks, kc, _ = tile
    if axis == 0:
        vec = 4 if W % 4 == 0 else 1
        chan, units = bl * line_stride(bp), bl * (bp + 4 * HALO) // vec
    else:
        vec = 4 if W % 4 == 0 and bl % 4 == 0 else 1
        chan, units = (bp + 2 * HALO) * row_stride(bl), (bp + 2 * HALO) * bl // vec
    stage = kc * (chan + TAPS * bn)
    sums = threads(tile, axis) * PLACES[axis] * LINES_A_THREAD[axis] * CHANNELS if ks > 1 else 0
    return 4 * max(2 * stage + 2 * units, sums + bn * (bl * bp + 1))


def tile_fits(tile: Tile, axis: int, W: int, n: int, c_a: int, c_x: int) -> bool:
    """Whether the kernels take ``tile`` along ``axis`` in an image W wide
    for a GEMM of ``n`` output channels over c_a + c_x input channels (the
    checks of ``evfly_sepconvgru_conv``)."""
    bl, bp, bn, ks, kc, wpg = tile
    P, quads = PLACES[axis], bn // CHANNELS
    if (bl < 1 or bl % LINES_A_THREAD[axis] or bp < P or bp % P
            or bn < CHANNELS or bn % CHANNELS or quads & (quads - 1) or n % bn or ks < 1
            or kc < ks or kc % ks or c_a % kc or c_x % kc or wpg < 1 or wpg > 32
            or wpg & (wpg - 1)):
        return False
    return (_place_groups(tile, axis) % wpg == 0 and threads(tile, axis) <= MAX_THREADS
            and smem_bytes(tile, axis, W) <= _SMEM_LIMIT)


# the rule's constants, from a sweep of tiles at E-RAFT's 60x80 on the H100
# (PERF.md): the share of the SMs the grid aims to cover with one block each,
# the channels a block starts from, and the input channels a chunk at most
GRID_SHARE = 0.9
CHANNELS_A_BLOCK = 64
MAX_CHUNK = 32


@functools.lru_cache(maxsize=64)
def choose_tile(zr: bool, axis: int, B: int, H: int, W: int, c_a: int, c_x: int,
                sms: int) -> Tile:
    """The tile of one kernel (``zr``: the z r GEMM of 2 c_a output channels,
    else q's of c_a) along ``axis`` over B images of H x W on a card of
    ``sms`` SMs: the largest blocks that still make ``GRID_SHARE`` of an SM's
    worth of blocks, each with as many K groups as fit.

    A line is padded to a multiple of ``PLACES`` (the positions a thread).
    A block starts from whole lines (up to 128 positions), one line (1x5)
    or two column quads (5x1), and ``CHANNELS_A_BLOCK`` channels.  While the grid is
    short of ``GRID_SHARE`` sms blocks: positions down to 5 P (to a divisor
    of the padded line), channels down to 32, positions down to P, channels
    down to 16.  Then lines doubled while the grid stays at that share.  K
    groups: 4, 2 or 1, the most that keep a block within ``MAX_THREADS``;
    ``MAX_CHUNK`` input channels a chunk (fewer where the channels or the
    shared memory ask); a warp's lines: the largest power of two up to 8 that
    divides the block's place groups.  Raises where no tile fits."""
    n = 2 * c_a if zr else c_a
    lines, length = (H, W) if axis == 0 else (W, H)
    per = LINES_A_THREAD[axis]
    P = PLACES[axis]
    full = -(-length // P) * P
    bps = [d for d in range(full, 0, -P) if full % d == 0]  # divisors of the padded line
    bp = next(d for d in bps if d <= 128)
    bl = per if axis == 0 else min(2 * per, -(-lines // per) * per)
    bn = min(CHANNELS_A_BLOCK, n)
    target = GRID_SHARE * sms

    def blocks(bl, bp, bn):
        return B * -(-lines // bl) * -(-length // bp) * (n // bn)

    def smaller(bp, floor):
        return next((d for d in bps if floor <= d < bp), None)

    while blocks(bl, bp, bn) < target:
        if smaller(bp, 5 * P):
            bp = smaller(bp, 5 * P)
        elif bn > 32 and n % (bn // 2) == 0:
            bn //= 2
        elif smaller(bp, P):
            bp = smaller(bp, P)
        elif bn > 16 and n % (bn // 2) == 0:
            bn //= 2
        else:
            break
    while bl * 2 <= -(-lines // per) * per and blocks(bl * 2, bp, bn) >= target:
        bl *= 2
    places = bl // per * (bp // P)
    wpg = 8
    while places % wpg:
        wpg //= 2
    for ks, kc in itertools.product((4, 2, 1), (MAX_CHUNK, 16, 8, 4, 2, 1)):
        tile = Tile(bl, bp, bn, ks, kc, wpg)
        if tile_fits(tile, axis, W, n, c_a, c_x):
            return tile
    raise ValueError(f"sepconvgru: no tile for {n} channels over {c_a} + {c_x} at "
                     f"{H}x{W} along axis {axis}")


def _axis(weight: torch.Tensor) -> int:
    shape = tuple(weight.shape[-2:])
    if shape == (1, TAPS):
        return 0
    if shape == (TAPS, 1):
        return 1
    raise ValueError(f"sepconvgru: a half-step's kernel is 1x{TAPS} or {TAPS}x1, got {shape}")


def sepconvgru_plain(h: torch.Tensor, x: torch.Tensor, halves: Sequence[Half]) -> torch.Tensor:
    """RAFT's SepConvGRU over h (B, C_h, H, W) and x (B, C_x, H, W) with the
    weights of its two half-steps: ``F.conv2d`` over ``torch.cat``s, sigmoid,
    tanh, the update; SepConvGRU's formulation."""
    for wz, bz, wr, br, wq, bq in halves:
        padding = (wz.shape[2] // 2, wz.shape[3] // 2)
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(imageops.conv2d(hx, wz, bz, 1, padding))
        r = torch.sigmoid(imageops.conv2d(hx, wr, br, 1, padding))
        q = torch.tanh(imageops.conv2d(torch.cat([r * h, x], 1), wq, bq, 1, padding))
        h = (1 - z) * h + z * q
    return h


def pack(halves: Sequence[Half]) -> Tuple[Packed, ...]:
    """The halves' weights in the kernels' layout (ordinary tensors, also
    under inference mode)."""
    def taps(w):  # (O, I, 1, 5) or (O, I, 5, 1) -> (I, 5, O)
        return w.reshape(w.shape[0], w.shape[1], TAPS).permute(1, 2, 0)

    with torch.inference_mode(False), torch.no_grad():
        return tuple(Packed(_axis(wz), torch.cat([taps(wz), taps(wr)], 2).contiguous(),
                            torch.cat([bz, br]).contiguous(), taps(wq).contiguous(),
                            bq.contiguous())
                     for wz, bz, wr, br, wq, bq in halves)


def _layout(packed: Sequence[Packed]) -> tuple:
    return tuple((p.axis, *((t.shape, t.dtype, t.device) for t in p[1:])) for p in packed)


class WeightCache:
    """One SepConvGRU's packed weights: packed at the first call that needs
    them, again only after a weight changes (its storage or its version
    counter, which ``load_state_dict``'s copies advance) or at ``refresh``.
    A repack of the same layout copies into the tensors packed before: a
    captured graph reads the tensors it was captured with, and so replays
    the new weights once they are packed."""

    def __init__(self):
        self._key: Optional[tuple] = None
        self._packed: Optional[Tuple[Packed, ...]] = None

    def get(self, halves: Sequence[Half]) -> Tuple[Packed, ...]:
        if self._weights_key(halves) != self._key:
            self._repack(halves)
        return self._packed

    def refresh(self, halves: Sequence[Half]) -> None:
        """Pack again now if packed before (``SepConvGRU`` calls it after
        each ``load_state_dict``, which a graph's replay would not see)."""
        if self._packed is not None:
            self._repack(halves)

    @staticmethod
    def _weights_key(halves: Sequence[Half]) -> tuple:
        return tuple((t.device, t.data_ptr(), t._version) for half in halves for t in half)

    def _repack(self, halves: Sequence[Half]) -> None:
        new = pack(halves)
        if self._packed is not None and _layout(self._packed) == _layout(new):
            with torch.inference_mode(False), torch.no_grad():
                for old_half, new_half in zip(self._packed, new):
                    for old, t in zip(old_half[1:], new_half[1:]):
                        old.copy_(t)
        else:
            self._packed = new
        self._key = self._weights_key(halves)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def kernel_takes(h: torch.Tensor, x: torch.Tensor, halves: Sequence[Half]) -> bool:
    """Whether ``sepconvgru`` launches the kernels: a CUDA call in f32 that
    needs no gradient.  Any other call takes the plain version."""
    tensors = (h, x, *(t for half in halves for t in half))
    return (h.device.type == "cuda" and not _needs_grad(*tensors)
            and all(t is None or t.dtype == torch.float32 for t in tensors))


def sepconvgru(h: torch.Tensor, x: torch.Tensor, halves: Sequence[Half],
               cache: WeightCache) -> torch.Tensor:
    """The new hidden state (B, C_h, H, W) of RAFT's SepConvGRU from h (B,
    C_h, H, W), x (B, C_x, H, W) and its two half-steps' weights.

    Calls that ``kernel_takes`` launch the kernels (``sepconvgru_cuda``, on
    the weights ``cache`` packs); the others take ``sepconvgru_plain``.
    ``sepconvgru.launches`` counts kernel launches."""
    if kernel_takes(h, x, halves):
        return sepconvgru_cuda(h, x, cache.get(halves))
    return sepconvgru_plain(h, x, halves)


sepconvgru.launches = 0


def sepconvgru_cuda(h: torch.Tensor, x: torch.Tensor, packed: Sequence[Packed]) -> torch.Tensor:
    """The kernels' two half-steps: f32 contiguous CUDA tensors on one
    device, no gradient; raises on anything else."""
    name = "sepconvgru"
    if h.dim() != 4 or x.dim() != 4 or x.shape[0] != h.shape[0] or x.shape[2:] != h.shape[2:]:
        raise ValueError(f"{name}: h and x must be (B, C, H, W) of one size, got "
                         f"{tuple(h.shape)} and {tuple(x.shape)}")
    B, c_a, H, W = h.shape
    c_x = x.shape[1]
    tensors = [("h", h, tuple(h.shape)), ("x", x, tuple(x.shape))]
    for half in packed:
        tensors += [("w_zr", half.w_zr, (c_a + c_x, TAPS, 2 * c_a)), ("b_zr", half.b_zr, (2 * c_a,)),
                    ("w_q", half.w_q, (c_a + c_x, TAPS, c_a)), ("b_q", half.b_q, (c_a,))]
    for arg, t, shape in tensors:
        if tuple(t.shape) != shape or t.device != h.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)} on {t.device}, expected "
                             f"{shape} on a CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} is {t.dtype}; the kernels take float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if arg in ("h", "x", "w_zr", "w_q") and t.data_ptr() % 16:  # read by 16-byte copies
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")
    if c_a % CHANNELS:
        raise ValueError(f"{name}: {c_a} hidden channels is not a multiple of {CHANNELS}")
    if _needs_grad(h, x):
        raise RuntimeError(f"{name} has no backward; call it under torch.no_grad()")
    z, rh = torch.empty_like(h), torch.empty_like(h)
    for half in packed:
        out = torch.empty_like(h)
        launch(True, half.axis, h, x, half.w_zr, half.b_zr, h, None, z, rh)
        launch(False, half.axis, rh, x, half.w_q, half.b_q, h, z, out, None)
        h = out
    return h


def launch(zr: bool, axis: int, a: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
           bias: torch.Tensor, h: torch.Tensor, z: Optional[torch.Tensor], out0: torch.Tensor,
           out1: Optional[torch.Tensor]) -> None:
    """One kernel over tensors ``sepconvgru_cuda`` has checked, on
    ``choose_tile``'s tile: ``zr`` the z r GEMM over [a = h, x] into out0 =
    z, out1 = r h; else the q GEMM over [a = r h, x] with the update into
    out0 = h'."""
    B, c_a, H, W = a.shape
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    tile = choose_tile(zr, axis, B, H, W, c_a, x.shape[1], sms)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(a.device):
        status = _build.library().evfly_sepconvgru_conv(
            int(zr), axis, a.data_ptr(), x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            h.data_ptr(), ptr(z), out0.data_ptr(), ptr(out1), B, H, W, c_a, x.shape[1], *tile,
            _build.stream_of(a.device))
    _build.check("sepconvgru_zr_conv_kernel" if zr else "sepconvgru_q_conv_kernel", status)
    sepconvgru.launches += 1
