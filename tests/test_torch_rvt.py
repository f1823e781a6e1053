"""RVT-B (evfly_tpu_torch/models/rvt.py), its stacked histogram
(ops/voxelizer.py) and its streaming step (stream/pipeline.py) against the
benchmark's plain reference (perfbench/reference/rvt.py, written from the
model's equations), on seeded weights at small sizes on the CPU:

- the window and grid partitions round-trip exactly, and a grid group holds
  the tokens H/gh rows and W/gw columns apart;
- one partition attention block, one stage with its LSTM, and the whole
  model over 3 chained windows within f32 tolerances (TOL of the
  reference's largest value);
- the histogram exactly: timestamp ties, the clip, padding and events
  outside the frame;
- the pipeline's eager step over 3 windows against the reference;
- ``build_model`` builds RVT-B at the published widths, with the
  configuration's parameter count;
- on a CUDA card (``gpu`` marker, skipped here): a replayed step's marks
  (frame, downsample, attention, lstm, head) add up to 85-105% of the
  replay timed by CUDA events.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from evfly_tpu_torch.configs import EvflyConfig
from evfly_tpu_torch.models import rvt
from evfly_tpu_torch.models.common import module_param_count
from evfly_tpu_torch.models.registry import build_model
from evfly_tpu_torch.ops.voxelizer import stacked_histogram
from evfly_tpu_torch.stream.pipeline import BatchedStreamingPipeline, StreamingPipeline
from evfly_tpu_torch.utils import profiling
from perfbench.reference import rvt as ref

from torch_helpers import cuda_device  # noqa: F401  (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SENSOR, FRAME, PART = (128, 128), (64, 64), (2, 2)
TOL = 2e-5


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _model(sd, device="cpu", frame=FRAME, part=PART):
    m = rvt.RVT(device=device, sensor_hw=(2 * frame[0], 2 * frame[1]), frame_hw=frame,
                partition=part)
    return m.load_params({k: v.clone() for k, v in sd.items()}).eval()


def _window(seed, n, sensor=SENSOR, ties=False):
    r = np.random.default_rng(seed)
    x = r.integers(0, sensor[1], n).astype(np.int16)
    y = r.integers(0, sensor[0], n).astype(np.int16)
    p = r.choice(np.array([-1, 1], np.int8), n)
    t = np.sort(r.integers(0, 50 if ties else 50000, n)) + 10 ** 12
    return x, y, p, t


@pytest.mark.parametrize("kind", ["window", "grid"])
@pytest.mark.parametrize("hw,part", [((12, 20), (6, 10)), ((16, 16), (2, 2)), ((8, 12), (4, 3))])
def test_partitions_round_trip_exactly(kind, hw, part):
    x = torch.randn(2, *hw, 5)
    split, join = rvt.PARTITIONS[kind]
    t = split(x, part)
    assert t.shape == (2 * hw[0] * hw[1] // (part[0] * part[1]), part[0] * part[1], 5)
    assert torch.equal(join(t, part, x.shape), x)


def test_a_grid_group_holds_tokens_spread_over_the_map():
    H, W, part = 12, 20, (6, 10)
    rows = torch.arange(H)[:, None].expand(H, W)
    cols = torch.arange(W)[None, :].expand(H, W)
    pos = torch.stack([rows, cols], -1)[None].float()
    grid = rvt.grid_partition(pos, part)[0]
    window = rvt.window_partition(pos, part)[0]
    assert grid[:, 0].unique().tolist() == list(range(0, H, H // part[0]))
    assert grid[:, 1].unique().tolist() == list(range(0, W, W // part[1]))
    assert window[:, 0].unique().tolist() == list(range(part[0]))
    assert window[:, 1].unique().tolist() == list(range(part[1]))


@pytest.mark.parametrize("kind", ["window", "grid"])
def test_a_partition_block_matches_the_reference(kind):
    sd = ref.init_weights(1, "cpu")
    model = _model(sd)
    z = torch.randn(1, 16, 16, 64)
    with torch.no_grad():
        got = getattr(model.stages[0], kind)(z)
        want = ref.block(z, sd, f"stages.0.{kind}", kind, PART)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("s", [0, 3])
def test_a_stage_with_its_lstm_matches_the_reference(s):
    sd = ref.init_weights(2, "cpu")
    model = _model(sd)
    cin = 20 if s == 0 else rvt.STAGE_DIMS[s - 1]
    hw = (64, 64) if s == 0 else (4, 4)
    x = torch.randn(1, cin, *hw)
    state = tuple(torch.randn(1, rvt.STAGE_DIMS[s], *model.map_hw(s + 1)) for _ in range(2))
    with torch.no_grad():
        h, (h2, c) = model.stages[s](x, state)
        rh, (_, rc) = ref.stage(x, sd, s, state, PART)
    assert _rel(h, rh) < TOL and _rel(c, rc) < TOL and h is h2


def test_the_model_over_three_chained_windows_matches_the_reference():
    sd = ref.init_weights(3, "cpu")
    model = _model(sd)
    hidden, rhidden = None, None
    with torch.no_grad():
        for k in range(3):
            frame = ref.histogram(*(torch.as_tensor(v) for v in _window(k, 4000)),
                                  frame_hw=FRAME)
            raw, dec, hidden = model(frame[None], hidden)
            rraw, rdec, rhidden = ref.forward(sd, frame[None], rhidden, PART)
            assert raw.shape == (1, 84, 8)
            assert _rel(raw, rraw) < TOL and _rel(dec, rdec) < TOL
            for got, want in zip(hidden, rhidden):
                assert _rel(got[0], want[0]) < TOL and _rel(got[1], want[1]) < TOL


@pytest.mark.parametrize("case", ["plain", "ties", "clipped", "padded", "outside", "one_time"])
def test_the_histogram_equals_the_reference_exactly(case):
    n = 6000
    x, y, p, t = _window(7, n, ties=case == "ties")
    if case == "clipped":
        x[: n // 2], y[: n // 2] = 5, 9       # 3,000 events on one pixel, clipped at 10
    if case == "outside":
        x[::7] = 300                          # past the sensor: outside the frame
    if case == "one_time":
        t[:] = t[0]                           # a window with no time span: all in bin 0
    cols = [torch.as_tensor(v) for v in (x, y, p, t)]
    want = ref.histogram(*cols, frame_hw=FRAME)
    real = n
    if case == "padded":
        real = n - 1500
        want = ref.histogram(*(c[:real] for c in cols), frame_hw=FRAME)
    got = stacked_histogram(*cols, real, 10, FRAME, 2, 10.0)
    assert torch.equal(got, want)
    assert got.max() <= 10 and (case != "clipped" or got.max() == 10)
    later_bins = [i for i in range(20) if i % 10]
    assert got.sum() > 0 and (case != "one_time" or got[later_bins].sum() == 0)


def test_the_pipelines_eager_step_matches_the_reference():
    sd = ref.init_weights(4, "cpu")
    pipe = StreamingPipeline(_model(sd), device="cpu")
    assert pipe.input_hw == SENSOR and pipe.frame_shape() == (20, *FRAME)
    hidden = None
    for k in range(3):
        window = _window(10 + k, [900, 5000, 2100][k])
        decoded, raw = pipe.step_events(*window)
        frame = ref.histogram(*(torch.as_tensor(v) for v in window), frame_hw=FRAME)
        with torch.no_grad():
            rraw, rdec, hidden = ref.forward(sd, frame[None], hidden, PART)
        assert _rel(raw, rraw[0]) < TOL and _rel(decoded, rdec[0]) < TOL
        for got, want in zip(pipe.hidden, hidden):
            assert _rel(got[1], want[1]) < TOL
    assert pipe.stats.events == 8000 and pipe.stats.padded_events == 1024 + 8192 + 4096
    with pytest.raises(ValueError):
        pipe.step_events(*window[:3])
    with pytest.raises(NotImplementedError):
        BatchedStreamingPipeline(_model(sd), 2, device="cpu")


def test_build_model_builds_rvt_b_with_the_configurations_parameter_count():
    conf = json.loads((ROOT / "perfbench" / "configs" / "rvt.json").read_text())
    model = build_model(EvflyConfig(model_type="RVT"), device="cpu")
    assert isinstance(model, rvt.RVT)
    assert module_param_count(model) == conf["parameters"] == ref.param_count() == 18538776
    assert dict(rvt.layer_counts(model)) == conf["parameters_by_part"]
    assert round(conf["parameters"] / 1e6, 1) == 18.5
    assert model.frame_hw == tuple(conf["frame_hw"]) == ref.FRAME_HW
    assert model.stream_io.sensor_hw == tuple(conf["sensor_hw"])
    hidden = model.init_hidden()
    assert sum(t.numel() * 4 for hc in hidden for t in hc) == conf["state_bytes_per_stream"]


@pytest.mark.gpu
def test_graph_marks_time_a_replayed_rvt_step_on_gpu(cuda_device):
    """A captured RVT step's marks resolve to positive device intervals of
    each traced replay and add up to 85-105% of the replay timed by CUDA
    events around it; each stage's marks carry their counts."""
    sd = ref.init_weights(5, cuda_device)
    pipe = StreamingPipeline(_model(sd, cuda_device, rvt.FRAME_HW, rvt.PARTITION),
                             device=cuda_device)
    window = _window(3, 200_000, rvt.SENSOR_HW)
    pipe.step_events(*window)[0].cpu()
    (slot,) = pipe._steps.slots.values()
    names = [m[0] for m in slot.marks.marks]
    assert names[0] == "evfly.frame" and names[-1] == "evfly.rvt.head"
    assert names.count("evfly.rvt.attention") == 4
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
            pipe.step_events(*window)[0].cpu()
    records = profiling.spans()
    roots = [r for r in records if r.name == "evfly.stream.step"]
    assert len(roots) == 3
    for root in roots:
        marks = [r for r in records if r.root == root.id and r.host is None]
        assert len(marks) == len(names)
        assert all(r.device_ms > 0 and 0 <= r.device[0] for r in marks)
        att = [r.counts for r in marks if r.name == "evfly.rvt.attention"]
        assert [c["stage"] for c in att] == [1, 2, 3, 4]
        assert att[0]["tokens"] == 96 * 160 and att[0]["partitions"] == 256
        share = sum(r.device_ms for r in marks) / float(np.median(replay_ms))
        assert 0.85 <= share <= 1.05, (share, replay_ms)
