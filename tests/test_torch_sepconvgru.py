"""E-RAFT's separable ConvGRU as two CUDA kernels a half-step (ops.sepconvgru,
csrc/sepconvgru.cu sepconvgru_zr_conv_kernel and sepconvgru_q_conv_kernel).

On the CPU: the plain version is SepConvGRU's formulation of before, bit for
bit (each half-step, both, and inside the module); the route takes the plain
version for CPU tensors, for a call that needs a gradient and for any dtype
but f32, and the kernels for an f32 call on the card that needs none
(``_OnCard``, a CPU tensor that reads as a CUDA one); the launch raises
before the library on what the kernels do not take; the weights' packed
layout and its cache, which a load refills in place; the tile rule; E-RAFT at 128x160 against the
benchmark's plain reference, with the refinement span's ``gru_kernel``
count.

On a CUDA card (``gpu`` marker, skipped here): both kernels and the whole
call against the plain version at 60x80 and at ragged shapes, E-RAFT's
captured step with the kernels against the eager plain step at 480x640 over
three chained windows, with 48 launches a step, and the captured step
replaying weights loaded after its capture.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from evfly_tpu_torch.models import eraft
from evfly_tpu_torch.ops import imageops, sepconvgru as sg
from evfly_tpu_torch.stream.pipeline import StreamingPipeline
from evfly_tpu_torch.utils import profiling
from perfbench.reference import eraft as ref
from torch_helpers import cuda_device  # noqa: F401 (fixture)

C_H, C_X = eraft.HIDDEN_DIM, 128 + eraft.HIDDEN_DIM
# the largest |kernels - plain| over the plain output's largest |value|: the
# kernels sum in another order than cuDNN (both read 2e-7 to 9e-7 of the
# f64 result at 60x80), and a half-step's rounding passes through sigmoid,
# tanh and the update
REL_TOL = 4e-6
# the sweep's fastest tiles at E-RAFT's 60x80 on the H100's 132 SMs (PERF.md):
# (z r, axis) -> Tile(lines, positions, channels, K groups, chunk, warp lines)
ERAFT_TILES = {(True, 0): (2, 80, 64, 4, 32, 8), (False, 0): (1, 80, 64, 4, 32, 4),
               (True, 1): (8, 20, 64, 2, 32, 2), (False, 1): (8, 20, 32, 4, 32, 2)}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gru(seed, device="cpu"):
    return eraft.SepConvGRU(torch.Generator().manual_seed(seed), torch.device(device))


def _inputs(seed, B, H, W, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    h = torch.tanh(torch.randn(B, C_H, H, W, generator=gen))
    x = torch.relu(torch.randn(B, C_X, H, W, generator=gen))
    return h.to(device), x.to(device)


def _before(gru, h, x, halves=(1, 2)):
    """SepConvGRU.forward before the kernels, over the given half-steps."""
    for i in halves:
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(getattr(gru, f"convz{i}")(hx))
        r = torch.sigmoid(getattr(gru, f"convr{i}")(hx))
        q = torch.tanh(getattr(gru, f"convq{i}")(torch.cat([r * h, x], 1)))
        h = (1 - z) * h + z * q
    return h


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


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
    """Replace the kernels' launch by a recorder: the calls that reach it."""
    reached = []
    monkeypatch.setattr(sg, "sepconvgru_cuda", lambda *a: reached.append(a) or a[0])
    return reached


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("halves", [(1,), (2,), (1, 2)], ids=["1x5", "5x1", "both"])
def test_plain_equals_sepconvgrus_formulation_bit_for_bit(halves):
    gru = _gru(3)
    h, x = _inputs(4, 1, 16, 20)
    weights = [gru.halves()[i - 1] for i in halves]
    with torch.no_grad():
        assert torch.equal(sg.sepconvgru_plain(h, x, weights), _before(gru, h, x, halves))


@pytest.mark.parametrize("B,H,W", [(1, 16, 20), (2, 7, 9)])
def test_the_modules_forward_is_unchanged_on_the_cpu(B, H, W):
    """SepConvGRU's forward gives its outputs of before, bit for bit, with a
    gradient and without, and launches nothing."""
    gru = _gru(5)
    h, x = _inputs(6, B, H, W)
    before = sg.sepconvgru.launches
    with torch.no_grad():
        assert torch.equal(gru(h, x), _before(gru, h, x))
    out = gru(h, x)
    assert torch.equal(out.detach(), _before(gru, h, x).detach())
    out.sum().backward()
    assert gru.convq2.weight.grad is not None
    assert sg.sepconvgru.launches == before


def _route_call(route):
    """(h, x, halves, mode) of a call that ``route`` describes."""
    gru = _gru(7)
    h, x = _inputs(8, 1, 6, 10)
    halves = [tuple(t.detach() for t in half) for half in gru.halves()]
    mode = torch.no_grad
    if route == "gradient":  # weights that require grad, grad mode on
        halves = [tuple(t.clone().requires_grad_(True) for t in half) for half in halves]
        mode = contextlib.nullcontext
    elif route in ("bf16", "f64"):
        dtype = torch.bfloat16 if route == "bf16" else torch.float64
        h, x = h.to(dtype), x.to(dtype)
        halves = [tuple(t.to(dtype) for t in half) for half in halves]
    if route != "cpu":
        h, x = h.as_subclass(_OnCard), x.as_subclass(_OnCard)
    return h, x, halves, mode


@pytest.mark.parametrize("route", ["cpu", "gradient", "bf16", "f64"])
def test_route_takes_the_plain_version(route, no_launch):
    """CPU tensors, a call that needs a gradient and any dtype but f32 take
    the plain version; the counter does not move."""
    h, x, halves, mode = _route_call(route)
    cache = sg.WeightCache()
    before = sg.sepconvgru.launches
    with mode():
        assert not sg.kernel_takes(h, x, halves)
        got = sg.sepconvgru(h, x, halves, cache)
        want = sg.sepconvgru_plain(h.as_subclass(torch.Tensor), x.as_subclass(torch.Tensor),
                                   halves)
    assert not no_launch and sg.sepconvgru.launches == before
    assert torch.equal(got, want)
    if route == "gradient":
        got.sum().backward()
        assert halves[1][4].grad is not None


@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode, contextlib.nullcontext])
def test_route_takes_the_kernels_for_f32_on_the_card(mode, no_launch):
    """An f32 call on the card that needs no gradient reaches the kernels'
    launch with the packed weights: under no_grad, inference_mode, or with
    no tensor requiring grad."""
    h, x, halves, _ = _route_call("f32")
    cache = sg.WeightCache()
    with mode():
        assert sg.kernel_takes(h, x, halves)
        sg.sepconvgru(h, x, halves, cache)
    (call,) = no_launch
    packed = call[2]
    assert [p.axis for p in packed] == [0, 1]
    assert packed is cache.get(halves)


def test_the_module_reaches_the_kernels_on_the_card(no_launch):
    """SepConvGRU under no_grad, its tensors on the card: the kernels."""
    gru = _gru(9)
    h, x = _inputs(10, 1, 6, 10)
    with torch.no_grad():
        gru(h.as_subclass(_OnCard), x.as_subclass(_OnCard))
    assert len(no_launch) == 1


RAISES = {"f64": (ValueError, "float32"), "cpu": (ValueError, "on a CUDA device"),
          "shape": (ValueError, "one size"), "weight shape": (ValueError, "w_q is"),
          "contiguity": (ValueError, "not contiguous"), "alignment": (ValueError, "x is not 16"),
          "gradient": (RuntimeError, "no backward")}


@pytest.mark.parametrize("case", list(RAISES))
def test_launch_raises_before_the_library(case, monkeypatch):
    """The launch checks what it is given before it builds or calls the
    library: f64, a CPU tensor, x of another size than h, a packed weight of
    another shape, a tensor that is not contiguous, a contiguous x one float
    past a 16-byte boundary, and a call that needs a gradient raise."""
    monkeypatch.setattr(sg._build, "library", lambda *a: pytest.fail("library reached"))
    h, x = _inputs(11, 1, 6, 10)
    packed = list(sg.pack(_gru(12).halves()))
    if case == "f64":
        h, x = h.double(), x.double()
    if case == "shape":
        x = x[:, :, :5]
    if case == "weight shape":
        packed[1] = packed[1]._replace(w_q=packed[1].w_q[:, :, :64])
    if case == "contiguity":
        h = h.transpose(2, 3).contiguous().transpose(2, 3)
    if case == "alignment":
        x = torch.empty(x.numel() + 4)[1:1 + x.numel()].view_as(x).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    if case == "gradient":
        h.requires_grad_(True)
    if case != "cpu":
        h, x = h.as_subclass(_OnCard), x.as_subclass(_OnCard)
        packed = [sg.Packed(p.axis, *(t.as_subclass(_OnCard) for t in p[1:])) for p in packed]
    error, match = RAISES[case]
    with pytest.raises(error, match=match):
        sg.sepconvgru_cuda(h, x, packed)


def test_pack_stacks_z_and_r_taps_next_to_the_channels():
    halves = _gru(13).halves()
    packed = sg.pack(halves)
    for (wz, bz, wr, br, wq, bq), p, axis in zip(halves, packed, (0, 1)):
        assert p.axis == axis
        assert p.w_zr.shape == (C_H + C_X, 5, 2 * C_H) and p.w_q.shape == (C_H + C_X, 5, C_H)
        taps = lambda w: w.reshape(C_H, C_H + C_X, 5)  # noqa: E731
        for c, k, o in ((0, 0, 0), (200, 3, 17), (383, 4, 127)):
            assert p.w_zr[c, k, o] == taps(wz)[o, c, k]
            assert p.w_zr[c, k, C_H + o] == taps(wr)[o, c, k]
            assert p.w_q[c, k, o] == taps(wq)[o, c, k]
        assert torch.equal(p.b_zr, torch.cat([bz, br])) and torch.equal(p.b_q, bq)
        assert not p.w_zr.requires_grad and p.w_zr.is_contiguous()
    with pytest.raises(ValueError, match="1x5 or 5x1"):
        sg.pack([(t[:, :, :, :3] if t.dim() == 4 else t for t in halves[0])])


def test_weights_are_packed_once_and_again_after_a_load():
    """The cache packs at its first use, returns the same tensors while the
    weights stay, and ``load_params`` packs the new weights at once into the
    same tensors (those a captured step reads, which no call asks for the
    cache again), also under inference mode."""
    model = eraft.ERAFT(device="cpu", sensor_hw=(128, 160))
    gru = model.update_block.gru
    cache = gru._packed
    with torch.inference_mode():
        first = cache.get(gru.halves())
        assert cache.get(gru.halves()) is first
    assert not first[0].w_zr.is_inference()
    ptrs = [t.data_ptr() for half in first for t in half[1:]]
    old = first[1].w_q.clone()
    sd = {k: v for k, v in ref.init_weights(14, "cpu").items()}
    model.load_params(sd)
    assert cache._key == cache._weights_key(gru.halves())   # packed by the load itself
    want = sg.pack(gru.halves())
    for got_half, want_half in zip(first, want):
        for got, t in zip(got_half[1:], want_half[1:]):
            assert torch.equal(got, t)
    assert not torch.equal(first[1].w_q, old)
    assert cache.get(gru.halves()) is first
    assert [t.data_ptr() for half in first for t in half[1:]] == ptrs


def test_a_load_before_the_first_use_packs_nothing():
    model = eraft.ERAFT(device="cpu", sensor_hw=(128, 160))
    model.load_params(ref.init_weights(17, "cpu"))
    assert model.update_block.gru._packed._packed is None


def test_an_edit_in_place_is_packed_into_the_same_tensors():
    """An edit that advances a weight's version (an optimizer step, a copy)
    is packed at the next call into the tensors packed before."""
    gru = _gru(18)
    cache = sg.WeightCache()
    first = cache.get(gru.halves())
    ptr = first[0].b_zr.data_ptr()
    with torch.no_grad():
        gru.convr1.bias.add_(1.0)
    assert cache.get(gru.halves()) is first and first[0].b_zr.data_ptr() == ptr
    assert torch.equal(first[0].b_zr, torch.cat([gru.convz1.bias, gru.convr1.bias]))


def test_weights_of_another_layout_are_packed_anew():
    """Weights of another dtype or storage size get new packed tensors."""
    gru = _gru(19)
    cache = sg.WeightCache()
    first = cache.get(gru.halves())
    gru.double()
    second = cache.get(gru.halves())
    assert second is not first and second[0].w_zr.dtype == torch.float64
    assert first[0].w_zr.dtype == torch.float32


@pytest.mark.parametrize("zr,axis", list(ERAFT_TILES))
def test_the_tiles_at_erafts_shape(zr, axis):
    """At 60x80 on 132 SMs the rule picks the sweep's fastest tile, which
    fits the kernel, and makes 120 blocks (0.9 of an SM's worth each)."""
    tile = sg.choose_tile(zr, axis, 1, 60, 80, C_H, C_X, 132)
    assert tile == sg.Tile(*ERAFT_TILES[(zr, axis)])
    n = 2 * C_H if zr else C_H
    assert sg.tile_fits(tile, axis, 80, n, C_H, C_X)
    lines, length = (60, 80) if axis == 0 else (80, 60)
    assert -(-lines // tile.lines) * -(-length // tile.positions) * n // tile.channels == 120


@pytest.mark.parametrize("B,H,W", [(1, 60, 80), (2, 37, 53), (1, 36, 52), (1, 16, 20),
                                   (3, 9, 12), (1, 120, 160), (1, 7, 5), (1, 1, 1)])
def test_every_chosen_tile_fits(B, H, W):
    for zr in (True, False):
        for axis in (0, 1):
            tile = sg.choose_tile(zr, axis, B, H, W, C_H, C_X, 132)
            assert sg.tile_fits(tile, axis, W, 2 * C_H if zr else C_H, C_H, C_X)
            assert 1 <= sg.threads(tile, axis) <= sg.MAX_THREADS
            assert tile.positions % sg.PLACES[axis] == 0


def test_no_tile_raises():
    with pytest.raises(ValueError, match="no tile"):
        sg.choose_tile(True, 0, 1, 60, 80, 6, 256, 132)


def test_eraft_at_128x160_matches_the_reference_with_the_plain_gru(monkeypatch):
    """E-RAFT's forward on the CPU against perfbench's plain reference (as
    tests/test_torch_eraft.py holds it), the refinement span counting
    ``gru_kernel`` 0: the plain route."""
    monkeypatch.setattr(ref, "FLOW_HEAD_SCALE", 1.0)
    sd = ref.init_weights(15, "cpu")
    model = eraft.ERAFT(device="cpu", sensor_hw=(128, 160))
    model.load_params({k: v.clone() for k, v in sd.items()}).eval()
    gen = torch.Generator().manual_seed(16)
    prev, cur = (torch.randn(eraft.BINS, 128, 160, generator=gen) * 0.3 for _ in range(2))
    init = torch.randn(2, 16, 20, generator=gen)
    profiling.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        low, up = model(prev[None], cur[None], init[None])
    (refine,) = [r for r in profiling.spans() if r.name == "evfly.eraft.refine"]
    assert refine.counts == {"iterations": eraft.ITERATIONS, "gru_kernel": 0}
    with torch.no_grad():
        want_low, want_up, _ = ref.forward(sd, prev, cur, init)
    assert _rel_err(low[0], want_low) < 2e-5 and _rel_err(up[0], want_up) < 2e-5


# ------------------------------------------------------------------ the card


@pytest.fixture
def full_f32(cuda_device):
    """Full f32 for the plain version's cuDNN convolutions (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda_device
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W", [(1, 60, 80), (2, 37, 53), (1, 36, 52), (3, 9, 12)])
def test_kernels_match_plain_on_gpu(full_f32, B, H, W):
    """Each kernel alone (z and r h; the update from the plain z and r h),
    and the whole call, against the plain version; 60x80 is E-RAFT's 1/8
    map, the others leave a partial tile on each side (and 53 a row that is
    not 16-byte aligned)."""
    gru = _gru(20, full_f32)
    h, x = _inputs(21 + H, B, H, W, full_f32)
    halves = gru.halves()
    packed = sg.pack(halves)
    with torch.no_grad():
        for (wz, bz, wr, br, wq, bq), p in zip(halves, packed):
            pad = (wz.shape[2] // 2, wz.shape[3] // 2)
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(imageops.conv2d(hx, wz, bz, 1, pad))
            rh = torch.sigmoid(imageops.conv2d(hx, wr, br, 1, pad)) * h
            q = torch.tanh(imageops.conv2d(torch.cat([rh, x], 1), wq, bq, 1, pad))
            want = (1 - z) * h + z * q
            got_z, got_rh, got = (torch.full_like(h, float("nan")) for _ in range(3))
            sg.launch(True, p.axis, h, x, p.w_zr, p.b_zr, h, None, got_z, got_rh)
            sg.launch(False, p.axis, rh, x, p.w_q, p.b_q, h, z, got, None)
            torch.cuda.synchronize()
            assert _rel_err(got_z, z) <= REL_TOL and _rel_err(got_rh, rh) <= REL_TOL
            assert _rel_err(got, want) <= REL_TOL
        before = sg.sepconvgru.launches
        got = gru(h, x)
        want = sg.sepconvgru_plain(h, x, halves)
    torch.cuda.synchronize()
    assert sg.sepconvgru.launches == before + 4
    assert _rel_err(got, want) <= REL_TOL


@pytest.mark.gpu
def test_kernels_raise_on_f64_on_gpu(full_f32):
    gru = _gru(22, full_f32)
    h, x = _inputs(23, 1, 6, 10, full_f32)
    with torch.no_grad(), pytest.raises(ValueError, match="float32"):
        sg.sepconvgru_cuda(h.double(), x.double(), sg.pack(gru.halves()))


def _window(seed, n, sensor):
    import numpy as np
    r = np.random.default_rng(seed)
    x = r.integers(0, sensor[1], n).astype(np.int16)
    y = r.integers(0, sensor[0], n).astype(np.int16)
    p = r.choice(np.array([-1, 1], np.int8), n)
    t = np.sort(r.integers(0, 100000, n)) + 10 ** 12
    return x, y, p, t


@pytest.mark.gpu
def test_captured_step_with_the_kernels_against_the_eager_plain_step_on_gpu(full_f32,
                                                                            monkeypatch):
    """At 480x640 over three chained windows (no flow, a cold start, a warm
    start): the captured step, whose GRU runs as the kernels (48 launches in
    an eager step: 12 iterations x 2 half-steps x 2 kernels; none at a
    replay), against the eager step with the plain GRU, within the 1/8 and
    the upsampled flow's TOL of tests/test_torch_eraft.py, with its flow head
    at PyTorch's default draws (the benchmark's scaled head moves the flow
    by hundredths of a pixel, which RAFT's absolute coordinates hold to
    about 1e-4 of it)."""
    monkeypatch.setattr(ref, "FLOW_HEAD_SCALE", 1.0)
    sd = ref.init_weights(24, full_f32)
    sensor = eraft.SENSOR_HW

    def model():
        m = eraft.ERAFT(device=full_f32, sensor_hw=sensor)
        m.load_params({k: v.clone() for k, v in sd.items()}).eval()
        return m.set_rectify_map(ref.rectify_map(9, sensor, full_f32))

    graphed = StreamingPipeline(model(), device=full_f32)
    eager_kernels = StreamingPipeline(model(), device=full_f32, graph=False)
    plain = StreamingPipeline(model(), device=full_f32, graph=False)
    windows = [_window(30 + k, 300_000, sensor) for k in range(3)]
    for k, window in enumerate(windows):
        before = sg.sepconvgru.launches
        e = eager_kernels.step_events(*window)
        torch.cuda.synchronize()
        assert sg.sepconvgru.launches == before + 48
        g = graphed.step_events(*window)
        with monkeypatch.context() as m:
            m.setattr(sg, "kernel_takes", lambda *a: False)
            launches = sg.sepconvgru.launches
            want = plain.step_events(*window)
            assert sg.sepconvgru.launches == launches
        assert float(g[2]) == float(want[2]) == float(e[2]) == (k > 0)
        if k:
            for got in (g, e):
                assert _rel_err(got[0], want[0]) < 2e-5 and _rel_err(got[1], want[1]) < 2e-5
    launches = sg.sepconvgru.launches
    graphed.step_events(*windows[-1])
    torch.cuda.synchronize()
    assert sg.sepconvgru.launches == launches   # a replay launches through the graph


@pytest.mark.gpu
def test_captured_step_replays_weights_loaded_after_the_capture_on_gpu(full_f32, monkeypatch):
    """New weights loaded (``load_params``) into a model whose step was
    captured reach the next replays, the ConvGRU kernels' packed weights
    too: two windows after the load against the eager plain step that
    loaded the same weights at the same point, with no second capture."""
    monkeypatch.setattr(ref, "FLOW_HEAD_SCALE", 1.0)
    sensor = eraft.SENSOR_HW
    first, second = ref.init_weights(25, full_f32), ref.init_weights(26, full_f32)
    rect = ref.rectify_map(9, sensor, full_f32)

    def model():
        m = eraft.ERAFT(device=full_f32, sensor_hw=sensor)
        return m.load_params({k: v.clone() for k, v in first.items()}).eval().set_rectify_map(rect)

    graphed, plain = (StreamingPipeline(model(), device=full_f32, graph=g) for g in (True, False))
    windows = [_window(40 + k, 300_000, sensor) for k in range(4)]
    for k, window in enumerate(windows):
        if k == 2:
            for pipe in (graphed, plain):
                pipe.model.load_params({n: v.clone() for n, v in second.items()})
        g = graphed.step_events(*window)
        with monkeypatch.context() as m:
            m.setattr(sg, "kernel_takes", lambda *a: False)
            want = plain.step_events(*window)
        if k:
            assert _rel_err(g[0], want[0]) < 2e-5 and _rel_err(g[1], want[1]) < 2e-5, k
    assert sum(graphed.stats.captures.values()) == 1
