"""E-RAFT (evfly_tpu_torch/models/eraft.py), its voxel grid
(ops/voxelizer.py) and its streaming step (stream/pipeline.py) against the
benchmark's plain reference (perfbench/reference/eraft.py, written from the
equations), on seeded weights at the published widths on the CPU.  The
frames are 128x160: RAFT's lookup normalises each level's coordinates by
its side less one, so the fourth level needs two cells a side (a 1/8 map of
at least 16).

- the voxel grid equals the reference's: padding left out, the truncation
  toward zero of a rectified coordinate in (-1, 0), a window with no time
  span, one nonzero cell, nonzero cells of zero spread;
- the lookup's channel order against an explicit loop over (level, a, b);
- the forward interpolation against a loop: strict bounds, ties to the
  lowest index, no kept source;
- the convex upsampling against an explicit sum;
- three chained windows through the pipeline's eager step: no flow, a cold
  start, a warm start, against the reference;
- the state_dict's names are RAFT's module tree, and the parameter count
  the configuration's;
- on a CUDA card (``gpu`` marker, skipped here): the captured step against
  the eager one at 480x640, and a replay's marks adding up to 85-105% of
  the replay timed by CUDA events.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from evfly_tpu_torch.configs import EvflyConfig
from evfly_tpu_torch.models import eraft
from evfly_tpu_torch.models.common import module_param_count
from evfly_tpu_torch.models.registry import build_model
from evfly_tpu_torch.ops.voxelizer import voxel_grid
from evfly_tpu_torch.stream.pipeline import StreamingPipeline
from evfly_tpu_torch.utils import profiling
from perfbench.reference import eraft as ref

from torch_helpers import cuda_device  # noqa: F401  (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SENSOR = (128, 160)
TOL = 2e-5


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def published_flow_head(monkeypatch):
    """The flow head at PyTorch's default draws: the benchmark's scaled head
    (``FLOW_HEAD_SCALE``, for its 20 s runs) moves a few windows' flow by
    hundredths of a pixel, which RAFT's absolute coordinates hold to about
    1e-4 of it, not to TOL."""
    monkeypatch.setattr(ref, "FLOW_HEAD_SCALE", 1.0)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _window(seed, n, sensor=SENSOR, span=100000):
    r = np.random.default_rng(seed)
    x = r.integers(0, sensor[1], n).astype(np.int16)
    y = r.integers(0, sensor[0], n).astype(np.int16)
    p = r.choice(np.array([-1, 1], np.int8), n)
    t = np.sort(r.integers(0, span, n)) + 10 ** 12
    return x, y, p, t


def _cols(window):
    return [torch.as_tensor(v) for v in window]


def _model(sd, device="cpu", sensor=SENSOR, seed=9):
    m = eraft.ERAFT(device=device, sensor_hw=sensor)
    m.load_params({k: v.clone() for k, v in sd.items()}).eval()
    return m.set_rectify_map(ref.rectify_map(seed, sensor, device))


@pytest.mark.parametrize("case", ["plain", "padded", "one_time"])
def test_the_voxel_grid_equals_the_references(case):
    n = 5000
    cols = _cols(_window(3, n, span=1 if case == "one_time" else 100000))
    rect = ref.rectify_map(4, SENSOR)
    real = n - 1200 if case == "padded" else n
    if case == "one_time":
        cols[3][:] = cols[3][0]                  # no time span: u = 0, every event in bin 0
    want = ref.voxel_grid(*(c[:real] for c in cols), rect)
    got = voxel_grid(*cols, real, rect, 15)
    assert torch.equal(got, want)
    assert (got != 0).sum() > 1000
    assert case != "one_time" or got[2:].abs().sum() == 0


def _splat(xr, yr, t, pol, bins=5, hw=(6, 8)):
    """The voxel grid of events at rectified (xr, yr) (a map holding them
    at the pixels (i, 0))."""
    n = len(xr)
    rect = torch.zeros(*hw, 2)
    for i, (a, b) in enumerate(zip(xr, yr)):
        rect[i, 0] = torch.tensor([a, b])
    x, y = torch.zeros(n, dtype=torch.int16), torch.arange(n, dtype=torch.int16)
    p, tt = torch.tensor(pol, dtype=torch.int8), torch.tensor(t)
    got = voxel_grid(x, y, p, tt, n, rect, bins)
    assert torch.equal(got, ref.voxel_grid(x, y, p, tt, rect, bins))
    return got


def test_the_voxel_grid_truncates_toward_zero():
    # x = -0.3: corners 0 and 1 (int(-0.3) = 0) with weights 0.7 and -0.3; y and t on
    # the grid.  The two cells normalise to +-1/sqrt(2) (mean 0.2, spread sqrt(0.5)).
    g = _splat([-0.3], [2.0], [0], [1])
    nz = g.nonzero().tolist()
    assert nz == [[0, 2, 0], [0, 2, 1]]
    assert g[0, 2, 0] == pytest.approx(0.5 / 0.5 ** 0.5, rel=1e-6)
    assert g[0, 2, 1] == pytest.approx(-0.5 / 0.5 ** 0.5, rel=1e-6)


@pytest.mark.parametrize("case", ["one_cell", "zero_spread", "none"])
def test_the_voxel_grid_without_a_spread(case):
    if case == "one_cell":   # n = 1: std is NaN, so v - m = 0
        g = _splat([3.0], [2.0], [5], [1])
    elif case == "zero_spread":  # two cells of 1: std 0, so v - m = 0 each
        g = _splat([3.0, 5.0], [2.0, 4.0], [0, 40], [1, 1])
    else:  # every contribution off the grid
        g = _splat([-2.5], [2.0], [0], [1])
    assert torch.equal(g, torch.zeros_like(g))


def test_the_lookups_channel_order_against_a_loop():
    torch.manual_seed(0)
    h, w = 16, 20
    f1, f2 = torch.randn(1, 256, h, w), torch.randn(1, 256, h, w)
    pyramid = eraft.corr_pyramid(f1, f2)
    assert [tuple(p.shape[-2:]) for p in pyramid] == [(16, 20), (8, 10), (4, 5), (2, 2)]
    coords = torch.stack(torch.meshgrid(torch.arange(w).float(), torch.arange(h).float(),
                                        indexing="xy"))[None] + 3 * torch.randn(1, 2, h, w)
    m = eraft.ERAFT(device="cpu", sensor_hw=(8 * h, 8 * w))
    _, delta = m._grid(h, w, torch.device("cpu"))
    got = eraft.lookup(pyramid, coords, delta)[0]
    assert got.shape == (324, h, w)
    levels = [p[:, 0] for p in pyramid]
    for i, lv in enumerate(levels):
        for a in range(9):
            for b in range(9):
                x = coords[0, 0].reshape(-1, 1) / 2 ** i + (a - 4)
                y = coords[0, 1].reshape(-1, 1) / 2 ** i + (b - 4)
                want = ref.bilinear(lv, x, y).reshape(h, w)
                assert float((got[81 * i + 9 * a + b] - want).abs().max()) < 1e-5


def _interpolate_loop(flow):
    _, h, w = flow.shape
    src = []
    for y in range(h):
        for x in range(w):
            dx, dy = float(flow[0, y, x]), float(flow[1, y, x])
            x1, y1 = np.float32(x) + np.float32(dx), np.float32(y) + np.float32(dy)
            if 0 < x1 < w and 0 < y1 < h:
                src.append((x1, y1, dx, dy))
    out = np.zeros((2, h, w), np.float32)
    if not src:
        return out
    for y in range(h):
        for x in range(w):
            best = None
            for x1, y1, dx, dy in src:   # the first of equal distances stays
                ex, ey = np.float32(x) - x1, np.float32(y) - y1
                d = np.float32(ex * ex) + np.float32(ey * ey)
                if best is None or d < best[0]:
                    best = (d, dx, dy)
            out[:, y, x] = best[1:]
    return out


@pytest.mark.parametrize("case", ["random", "bounds", "ties", "none_kept"])
def test_the_forward_interpolation_against_a_loop(case):
    h, w = 5, 6
    g = torch.Generator().manual_seed(1)
    flow = 2 * torch.randn(2, h, w, generator=g)
    if case == "bounds":     # landing on 0 or on the far edge: dropped
        flow[0, 1, 1], flow[1, 2, 3] = -1.0, 2.0
        flow[0, 3, 2], flow[1, 4, 4] = 4.0, 1.0
    if case == "ties":       # sources at whole pixels: many targets halfway between two
        flow = torch.randint(-1, 2, (2, h, w), generator=g).float()
    if case == "none_kept":
        flow = torch.full((2, h, w), 40.0)
    got = eraft.forward_interpolate(flow[None])[0]
    want = torch.from_numpy(_interpolate_loop(flow))
    assert torch.equal(got, want)
    assert torch.equal(ref.forward_interpolate(flow), want)
    if case == "none_kept":
        assert got.abs().sum() == 0


def test_the_convex_upsampling_against_a_sum():
    g = torch.Generator().manual_seed(2)
    h, w = 2, 3
    flow, mask = torch.randn(1, 2, h, w, generator=g), torch.randn(1, 576, h, w, generator=g)
    got = eraft.convex_upsample(flow, mask)[0]
    padded = F.pad(8 * flow[0], (1, 1, 1, 1))
    want = torch.zeros(2, 8 * h, 8 * w)
    for y in range(h):
        for x in range(w):
            for i in range(8):
                for j in range(8):
                    logits = mask[0, [k * 64 + i * 8 + j for k in range(9)], y, x]
                    weight = torch.softmax(logits, 0)
                    for k in range(9):
                        dy, dx = divmod(k, 3)
                        want[:, 8 * y + i, 8 * x + j] += weight[k] * padded[:, y + dy, x + dx]
    assert float((got - want).abs().max()) < 1e-5
    assert float((ref.upsample(flow[0], mask[0]) - want).abs().max()) < 1e-5


def test_three_chained_windows_no_flow_cold_warm():
    sd = ref.init_weights(5, "cpu")
    model = _model(sd)
    rect = model.rectify_map.clone()
    pipe = StreamingPipeline(model, device="cpu")
    assert pipe.input_hw == SENSOR and pipe.frame_shape() == (15, *SENSOR)
    prev = init = None
    seen = 0
    for k in range(3):
        window = _window(20 + k, [3000, 9000, 2200][k])
        flow, low, valid = pipe.step_events(*window)
        voxel = ref.voxel_grid(*_cols(window), rect)
        assert torch.equal(pipe.hidden[0], voxel)
        assert float(valid) == (k > 0)
        if k == 0:
            assert flow.abs().sum() == 0 and low.abs().sum() == 0
        else:
            with torch.no_grad():
                want = ref.stream_step(sd, voxel, prev, init, seen)
            assert _rel(flow[0], want[0]) < TOL and _rel(low[0], want[1]) < TOL
        assert torch.equal(pipe.hidden[1][0], ref.forward_interpolate(low[0]))
        prev, init, seen = voxel, pipe.hidden[1][0].clone(), min(seen + 1, 2)
        assert int(pipe.hidden[2]) == seen
    assert eraft.ERAFT.stats(pipe.hidden) == {"windows": 3, "cold_starts": 1, "warm_starts": 1}
    assert float(init.abs().max()) > 0   # the third window started warm from a flow
    assert pipe.stats.events == 14200
    pipe.reset()
    assert eraft.ERAFT.stats(pipe.hidden)["windows"] == 0


def test_the_state_dict_is_rafts_and_the_parameter_count_the_configurations():
    conf = json.loads((ROOT / "perfbench" / "configs" / "eraft.json").read_text())
    model = build_model(EvflyConfig(model_type="ERAFT"), device="cpu")
    assert isinstance(model, eraft.ERAFT)
    keys = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert keys == set(ref.shapes())
    for name in ("fnet.conv1.weight", "fnet.layer2.0.downsample.0.weight",
                 "cnet.layer3.0.norm3.running_var", "cnet.layer3.0.downsample.1.running_var",
                 "update_block.encoder.convc1.weight", "update_block.gru.convq2.bias",
                 "update_block.flow_head.conv2.weight", "update_block.mask.2.weight"):
        assert name in keys
    assert not any(k.startswith("fnet") and ("norm" in k or "downsample.1" in k) for k in keys)
    assert model.state_dict()["update_block.gru.convz1.weight"].shape == (128, 384, 1, 5)
    assert model.state_dict()["update_block.encoder.convc1.weight"].shape == (256, 324, 1, 1)
    assert "rectify_map" not in model.state_dict()
    assert module_param_count(model) == conf["parameters"] == ref.param_count() == 5332800
    assert dict(eraft.layer_counts(model)) == conf["parameters_by_part"] == ref.param_parts()
    hidden = model.init_hidden()
    assert sum(t.numel() * t.element_size() for t in hidden) == conf["state_bytes_per_stream"]
    assert model.stream_io.time_bins == conf["time_bins"] == ref.BINS
    assert eraft.ITERATIONS == conf["iterations"] == ref.ITERATIONS


@pytest.mark.gpu
def test_graph_against_eager_and_marks_time_a_replayed_eraft_step_on_gpu(cuda_device):
    """At 480x640: three windows through a captured pipeline and through an
    eager one agree (the 1/8 and the upsampled flow within TOL of the
    largest value); a captured step's top-level marks resolve to positive
    device intervals and add up to 85-105% of the replay timed by CUDA
    events around it."""
    sd = ref.init_weights(6, cuda_device)
    graphed = StreamingPipeline(_model(sd, cuda_device, eraft.SENSOR_HW), device=cuda_device)
    eager = StreamingPipeline(_model(sd, cuda_device, eraft.SENSOR_HW), device=cuda_device,
                              graph=False)
    for k in range(3):
        window = _window(30 + k, 300_000, eraft.SENSOR_HW)
        g, e = graphed.step_events(*window), eager.step_events(*window)
        assert float(g[2]) == float(e[2]) == (k > 0)
        if k:
            assert _rel(g[0], e[0]) < TOL and _rel(g[1], e[1]) < TOL
    (slot,) = graphed._steps.slots.values()
    names = [m[0] for m in slot.marks.marks]
    top = ("evfly.frame", "evfly.eraft.encode", "evfly.eraft.corr", "evfly.eraft.refine",
           "evfly.eraft.upsample", "evfly.eraft.warm")
    assert [n for n in names if n in top] == list(top)
    assert names.count("evfly.eraft.lookup") == eraft.ITERATIONS
    replay_ms = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        slot.graph.replay()
        end.record()
        end.synchronize()
        replay_ms.append(start.elapsed_time(end))
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            graphed.step_events(*window)[0].cpu()
    records = profiling.spans()
    roots = [r for r in records if r.name == "evfly.stream.step"]
    assert len(roots) == 3
    for root in roots:
        marks = [r for r in records if r.root == root.id and r.host is None]
        assert len(marks) == len(names)
        assert all(r.device_ms > 0 and 0 <= r.device[0] for r in marks)
        lookups = [r.counts for r in marks if r.name == "evfly.eraft.lookup"]
        assert lookups[0] == {"levels": 4, "radius": 4, "positions": 4800}
        share = sum(r.device_ms for r in marks if r.name in top) / float(np.median(replay_ms))
        assert 0.85 <= share <= 1.05, (share, replay_ms)
