"""MixFFN's grouped 3x3 convolution, bias and GELU (ops.dwconv,
csrc/dwconv.cu mixffn_dwconv3x3_gelu_kernel).

On the CPU: the plain version is MixFFN's formulation of before, bit for bit
(alone and inside ``MixFFN.forward``); the route takes the plain version for
CPU tensors, for a call that needs a gradient and for bf16, and the kernel
for an f32 call on the card that needs none (``_OnCard``, a CPU tensor that
reads as a CUDA one); the launch raises before the library on what the
kernel does not take; the tile rule; and a numpy mirror of the kernel's
bookkeeping (the weights' reordering, the staged planes with their halo, the
threads' items and stores, bands and partial chunks) against the plain
version.

On a CUDA card (``gpu`` marker, skipped here): the kernel against the plain
version within 2e-6 of the output's largest value at the serving shapes
(256 x 345 x 256 at 15x23, 256 x 96 x 512 at 8x12), at G = 16 and 1, and on
ragged shapes, its launch count, a CUDA graph capture and replay, MixFFN's
route on the card, and the raises on f64 and on 4 channels a group.
"""

import contextlib

import numpy as np
import pytest
import torch

from evfly_tpu_torch.models.vit import MixFFN
from evfly_tpu_torch.ops import dwconv, imageops
from torch_helpers import cuda_device  # noqa: F401 (fixture)

# the largest |kernel - plain| over the plain output's largest |value|
REL_TOL = 2e-6
# (B, H, W, C) of V(phi)'s two blocks at the serving batch
SERVE = ((256, 15, 23, 256), (256, 8, 12, 512))


def _problem(seed, B, H, W, C, cin=dwconv.GROUP_CHANNELS, bias=True, device="cpu"):
    """Tokens (B, H*W, C), an OIHW weight of ``cin`` channels a group and a
    bias, at the scale of MixFFN's initialisation."""
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / np.sqrt(cin * 9)
    tokens = torch.randn(B, H * W, C, generator=gen)
    weight = (torch.rand(C, cin, 3, 3, generator=gen) * 2 - 1) * bound
    b = (torch.rand(C, generator=gen) * 2 - 1) * bound if bias else None
    return tuple(None if t is None else t.to(device) for t in (tokens, weight, b))


def _before(tokens, weight, bias, H, W):
    """MixFFN's formulation before the kernel: the depthwise Conv2d's
    ``imageops.conv2d`` over the NCHW view, then ``gelu_exact``."""
    B, N, C = tokens.shape
    x = imageops.conv2d(tokens.transpose(1, 2).reshape(B, C, H, W), weight, bias, 1, "same",
                        C // weight.shape[1])
    return imageops.gelu_exact(x.reshape(B, C, N).transpose(1, 2))


def _rel_err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a CUDA one where the route looks
    (``device``); whatever is computed from it is a plain CPU tensor."""
    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def no_launch(monkeypatch):
    """Replace the kernel's launch by a recorder: the calls that reach it."""
    reached = []
    monkeypatch.setattr(dwconv, "dwconv3x3_gelu_cuda", lambda *a: reached.append(a) or a[0])
    return reached


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("B,H,W,C,bias", [
    (2, 15, 23, 256, True), (2, 8, 12, 512, True), (3, 7, 5, 256, True), (3, 1, 1, 64, True),
    (2, 7, 5, 64, False)])
def test_plain_equals_mixffn_formulation_bit_for_bit(B, H, W, C, bias):
    tokens, weight, b = _problem(10 + H, B, H, W, C, bias=bias)
    assert torch.equal(dwconv.dwconv3x3_gelu_plain(tokens, weight, b, H, W),
                       _before(tokens, weight, b, H, W))


@pytest.mark.parametrize("channels,H,W", [(32, 15, 23), (64, 8, 12)])
def test_mixffn_forward_is_unchanged_on_the_cpu(channels, H, W):
    """mlp1 -> dwconv3x3_gelu -> mlp2 gives MixFFN's outputs of before, bit
    for bit, and launches nothing."""
    ffn = MixFFN(channels, 8, torch.Generator().manual_seed(channels), "cpu")
    x = torch.randn(2, H * W, channels, generator=torch.Generator().manual_seed(1))
    before = dwconv.dwconv3x3_gelu.launches
    ref = ffn.mlp2(_before(ffn.mlp1(x), ffn.depthwise.weight, ffn.depthwise.bias, H, W))
    assert torch.equal(ffn(x, H, W), ref)
    assert dwconv.dwconv3x3_gelu.launches == before


ROUTES = {
    "cpu": (lambda t: t, contextlib.nullcontext, False),
    "gradient": (lambda t: t.as_subclass(_OnCard), contextlib.nullcontext, True),
    "bf16": (lambda t: t.to(torch.bfloat16).as_subclass(_OnCard), torch.no_grad, False),
    "f64": (lambda t: t.double().as_subclass(_OnCard), torch.no_grad, False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_takes_the_plain_version(route, no_launch):
    """CPU tensors, a call that needs a gradient (a weight that requires
    grad, grad mode on) and any dtype but f32 take the plain version."""
    cast, mode, grad = ROUTES[route]
    tokens, weight, b = _problem(20, 2, 7, 5, 64)
    weight = weight.to(cast(tokens).dtype).requires_grad_(grad)
    b = b.to(weight.dtype)
    with mode():
        assert not dwconv.kernel_takes(cast(tokens), weight, b)
        got = dwconv.dwconv3x3_gelu(cast(tokens), weight, b, 7, 5)
    assert not no_launch
    ref = _before(tokens.to(weight.dtype), weight, b, 7, 5)
    assert torch.equal(got, ref)
    if grad:
        got.sum().backward()
        assert weight.grad is not None


@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode, contextlib.nullcontext])
def test_route_takes_the_kernel_for_f32_on_the_card(mode, no_launch):
    """An f32 call on the card that needs no gradient reaches the kernel's
    launch: under no_grad, inference_mode, or with no tensor requiring grad."""
    tokens, weight, b = _problem(21, 2, 7, 5, 64)
    with mode():
        assert dwconv.kernel_takes(tokens.as_subclass(_OnCard), weight, b)
        dwconv.dwconv3x3_gelu(tokens.as_subclass(_OnCard), weight, b, 7, 5)
    assert len(no_launch) == 1


RAISES = {"f64": (ValueError, "float32"), "4 channels a group": (ValueError, "8 channels a group"),
          "cpu": (ValueError, "on a CUDA device"), "shape": (ValueError, "tokens is"),
          "gradient": (RuntimeError, "no backward")}


@pytest.mark.parametrize("case", list(RAISES))
def test_launch_raises_before_the_library(case, monkeypatch):
    """The launch checks what it is given before it builds or calls the
    library: f64, 4 channels a group, a CPU tensor, tokens of another
    shape than H*W, and a call that needs a gradient raise."""
    monkeypatch.setattr(dwconv._build, "library", lambda *a: pytest.fail("library reached"))
    cin = 4 if case == "4 channels a group" else dwconv.GROUP_CHANNELS
    tensors = _problem(22, 2, 7, 5, 64, cin=cin)
    if case == "f64":
        tensors = [t.double() for t in tensors]
    if case != "cpu":
        tensors = [t.as_subclass(_OnCard) for t in tensors]
    tokens, weight, b = tensors
    weight.requires_grad_(case == "gradient")
    error, match = RAISES[case]
    with pytest.raises(error, match=match):
        dwconv.dwconv3x3_gelu_cuda(tokens, weight, b, 6 if case == "shape" else 7, 5)


def test_tiles_of_the_model_shapes():
    """4 groups and about three warps of work a tile at the serving batch (a
    band of ROWS rows of 15x23, the whole 8x12); bands of ROWS rows and
    fewer groups at the streaming batches, for two tiles an SM where the
    shape has that many."""
    sms = 132
    assert dwconv.choose_tile(256, 15, 23, 32, sms) == dwconv.Tile(4, 4, 96)
    assert dwconv.choose_tile(256, 8, 12, 64, sms) == dwconv.Tile(4, 8, 96)
    for B, H, W, groups in ((16, 15, 23, 32), (16, 8, 12, 64), (1, 15, 23, 32), (1, 8, 12, 64)):
        tile = dwconv.choose_tile(B, H, W, groups, sms)
        blocks = B * -(-H // tile.rows) * -(-groups // tile.groups)
        assert blocks >= 2 * sms or (tile.groups == 1 and tile.rows == min(H, dwconv.ROWS))


@pytest.mark.parametrize("B,H,W,groups", [
    (256, 15, 23, 32), (256, 8, 12, 64), (16, 15, 23, 32), (1, 8, 12, 64), (3, 7, 5, 32),
    (3, 1, 1, 32), (2, 60, 90, 4), (1, 120, 300, 3), (4, 33, 17, 5)])
def test_every_tile_fits_the_block(B, H, W, groups):
    tile = dwconv.choose_tile(B, H, W, groups, 132)
    assert dwconv.smem_bytes(tile.groups, tile.rows, W) <= dwconv._SMEM_LIMIT
    assert tile.threads % 32 == 0 and 32 <= tile.threads <= dwconv.MAX_THREADS
    assert tile.threads % (2 * tile.groups) == 0
    assert 1 <= tile.groups <= min(groups, dwconv.MAX_TILE_GROUPS) and 1 <= tile.rows <= H


def test_a_too_wide_image_raises():
    with pytest.raises(ValueError, match="too wide"):
        dwconv.choose_tile(1, 8, 4000, 4, 132)


def _mirror(tokens, weight, bias, H, W, tile, resident):
    """numpy mirror of ``mixffn_dwconv3x3_gelu_kernel``'s bookkeeping: a grid
    of ``resident`` blocks rounded down to a multiple of the chunks of
    groups, each block its chunk's weights reordered into (group, ky, kx, i,
    o) once, then its tiles t = block + k grid in turn, each staged float4
    by float4 by the threads' slots into a zero-padded (cell, channel)
    buffer with the band's halo and summed item by item (group, row block,
    column) in the kernel's order in f32, the bias added last, then stored.
    Unwritten shared memory reads as NaN; every output must be written
    once."""
    x, w = tokens.numpy().reshape(-1), weight.numpy().reshape(-1)
    B, N, C = tokens.shape
    b = np.zeros(C, np.float32) if bias is None else bias.numpy()
    R, RS, groups = dwconv.ROWS, W + 2, C // 8
    S, Q = dwconv.cell_floats(tile.groups), 2 * tile.groups
    cells = dwconv.tile_cells(tile.rows, W)
    bands, chunks = -(-H // tile.rows), -(-groups // tile.groups)
    n_tiles = B * bands * chunks
    grid = min(n_tiles, chunks * max(1, resident // chunks))
    assert tile.threads % Q == 0
    y = np.full((B, N, C), np.nan, np.float32)
    writes = np.zeros((B, N, C), np.int64)
    for blk in range(grid):
        g0 = blk % chunks * tile.groups
        ng = min(tile.groups, groups - g0)
        s_w = np.full(tile.groups * 576, np.nan, np.float32)
        f = np.arange(ng * 576)
        oc, rem = f // 72, f % 72
        i, tap = rem // 9, rem % 9
        s_w[(oc >> 3) * 576 + (tap * 8 + i) * 8 + (oc & 7)] = w[g0 * 576 + f]
        for t in range(blk, n_tiles, grid):
            rest = t // chunks
            bi, y0 = rest // bands, rest % bands * tile.rows
            rows = min(tile.rows, H - y0)
            buf = np.full(cells * S, np.nan, np.float32)
            for tid in range(tile.threads):
                q, step = tid % Q, tile.threads // Q
                if q >= ng * 2:
                    continue
                cell = np.arange(tid // Q, cells, step)
                ry, rx = cell // RS, cell % RS
                yy, xx = y0 - 1 + ry, rx - 1
                inside = (ry <= rows + 1) & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                src = bi * H * W * C + g0 * 8 + 4 * q + (yy * W + xx) * C
                for j in range(4):
                    buf[cell * S + 4 * q + j] = np.where(inside, x[np.where(inside, src + j, 0)],
                                                         0)
            row_blocks = -(-rows // R)
            per_group = row_blocks * W
            it = np.arange(ng * per_group)
            gi, rem = it // per_group, it % per_group
            rb, col = rem // W, rem % W
            c0 = (g0 + gi) * 8
            acc = np.zeros((len(it), R, 8), np.float32)
            base = (rb * R * RS + col) * S + gi * 8
            for ky in range(3):
                for kx in range(3):
                    for h in range(2):
                        xv = np.stack([np.stack([buf[base + ((r + ky) * RS + kx) * S + 4 * h + j]
                                                 for j in range(4)], 1) for r in range(R)], 1)
                        for ii in range(4):
                            wv = np.stack([s_w[gi * 576 + ((ky * 3 + kx) * 8 + 4 * h + ii) * 8 + o]
                                           for o in range(8)], 1)
                            for r in range(R):
                                acc[:, r] += xv[:, r, ii, None] * wv
            acc += b[c0[:, None] + np.arange(8)][:, None, :]  # the bias last
            out = torch.nn.functional.gelu(torch.from_numpy(acc)).numpy()
            for r in range(R):
                ok = rb * R + r < rows
                pix = (y0 + rb[ok] * R + r) * W + col[ok]
                chans = c0[ok][:, None] + np.arange(8)
                y[bi, pix[:, None], chans] = out[ok, r]
                writes[bi, pix[:, None], chans] += 1
    assert (writes == 1).all()
    return torch.from_numpy(y)


# (B, H, W, C), the tile, the bias, the blocks resident at once
MIRROR_CASES = {
    "block 1 at the serving tile": ((2, 15, 23, 256), dwconv.Tile(4, 4, 96), True, 40),
    "block 2 at the serving tile": ((2, 8, 12, 512), dwconv.Tile(4, 8, 96), True, 40),
    "block 1 in whole images": ((2, 15, 23, 256), dwconv.Tile(2, 15, 192), True, 40),
    "block 1 in bands": ((2, 15, 23, 256), dwconv.choose_tile(2, 15, 23, 32, 132), True, 264),
    "ragged 7x5": ((3, 7, 5, 256), dwconv.choose_tile(3, 7, 5, 32, 132), True, 264),
    "1x1": ((3, 1, 1, 64), dwconv.choose_tile(3, 1, 1, 8, 132), True, 264),
    "a partial chunk, two bands, no bias": ((2, 20, 9, 24), dwconv.Tile(2, 16, 32), False, 5),
    "fewer blocks than chunks": ((2, 8, 12, 512), dwconv.Tile(8, 8, 128), True, 3),
}


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_kernel_mirror_matches_plain(case):
    (B, H, W, C), tile, bias, resident = MIRROR_CASES[case]
    tokens, weight, b = _problem(30 + H, B, H, W, C, bias=bias)
    ref = dwconv.dwconv3x3_gelu_plain(tokens, weight, b, H, W)
    assert _rel_err(_mirror(tokens, weight, b, H, W, tile, resident), ref) <= REL_TOL


# ------------------------------------------------------------------ the card


@pytest.fixture
def full_f32(cuda_device):
    """Full f32 for the plain version's cuDNN convolution (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda_device
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,C", [
    *SERVE, (16, 15, 23, 256), (16, 8, 12, 512), (1, 15, 23, 256), (1, 8, 12, 512),
    (3, 7, 5, 256), (3, 1, 1, 256)])
def test_kernel_matches_plain_on_gpu(full_f32, B, H, W, C):
    tokens, weight, b = _problem(40 + B + H, B, H, W, C, device=full_f32)
    before = dwconv.dwconv3x3_gelu.launches
    with torch.no_grad():
        got = dwconv.dwconv3x3_gelu(tokens, weight, b, H, W)
        ref = dwconv.dwconv3x3_gelu_plain(tokens, weight, b, H, W)
    torch.cuda.synchronize()
    assert dwconv.dwconv3x3_gelu.launches == before + 1
    assert got.shape == ref.shape and _rel_err(got, ref) <= REL_TOL


@pytest.mark.gpu
def test_kernel_replays_in_a_cuda_graph(full_f32):
    """The launch captured in a CUDA graph and replayed on new tokens."""
    B, H, W, C = SERVE[1]
    tokens, weight, b = _problem(50, B, H, W, C, device=full_f32)
    static = tokens.clone()
    with torch.no_grad():
        dwconv.dwconv3x3_gelu(static, weight, b, H, W)  # warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = dwconv.dwconv3x3_gelu(static, weight, b, H, W)
        for seed in (51, 52, 53):
            tokens, _, _ = _problem(seed, B, H, W, C, device=full_f32)
            static.copy_(tokens)
            graph.replay()
            ref = dwconv.dwconv3x3_gelu_plain(tokens, weight, b, H, W)
            torch.cuda.synchronize()
            assert _rel_err(out, ref) <= REL_TOL


@pytest.mark.gpu
def test_mixffn_routes_on_the_card(full_f32):
    """MixFFN on the card: under no_grad through the kernel, matching the
    plain formulation; under autograd through cuDNN, with a backward."""
    ffn = MixFFN(32, 8, torch.Generator().manual_seed(5), full_f32)
    x = torch.randn(4, 15 * 23, 32, generator=torch.Generator().manual_seed(6)).to(full_f32)
    before = dwconv.dwconv3x3_gelu.launches
    with torch.no_grad():
        got = ffn(x, 15, 23)
        mid = _before(ffn.mlp1(x), ffn.depthwise.weight, ffn.depthwise.bias, 15, 23)
        ref = ffn.mlp2(mid)
    assert dwconv.dwconv3x3_gelu.launches == before + 1
    assert _rel_err(got, ref) <= REL_TOL
    trained = ffn(x, 15, 23)
    trained.sum().backward()
    assert dwconv.dwconv3x3_gelu.launches == before + 1
    assert ffn.depthwise.weight.grad is not None and _rel_err(trained.detach(), ref) <= REL_TOL


@pytest.mark.gpu
def test_kernel_raises_on_f64_and_on_4_channels_a_group(full_f32):
    tokens, weight, b = _problem(60, 2, 7, 5, 64, device=full_f32)
    with torch.no_grad(), pytest.raises(ValueError, match="float32"):
        dwconv.dwconv3x3_gelu_cuda(tokens.double(), weight.double(), b.double(), 7, 5)
    tokens, weight, b = _problem(61, 2, 7, 5, 64, cin=4, device=full_f32)
    before = dwconv.dwconv3x3_gelu.launches
    with torch.no_grad(), pytest.raises(ValueError, match="8 channels a group"):
        dwconv.dwconv3x3_gelu(tokens, weight, b, 7, 5)
    assert dwconv.dwconv3x3_gelu.launches == before
