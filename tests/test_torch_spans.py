"""The port's spans and counters (evfly_tpu_torch.utils.profiling, the
streaming pipeline's ``stats``), on the CPU under ``torch.profiler``:

- with no profiler recording, ``span`` is one shared no-op and keeps no
  record;
- an eager streaming step records ``evfly.stream.step`` holding
  ``evfly.stream.fill`` (its ``events`` and ``bucket``), ``evfly.frame``,
  ``evfly.depth`` and ``evfly.head``, each under the name of a profiler
  range whose interval holds the record's host interval;
- ``stats`` counts steps per graph key and real against padded events;
- both train steps (chunk DP and per chunk) record ``evfly.train.forward``,
  ``evfly.train.backward`` and ``evfly.train.update`` once a step;
- on a CUDA card (``gpu`` marker, skipped here): a replayed graph's marks
  resolve to positive device intervals that add up to 85-105% of the
  graph's replay timed by CUDA events (under a profiler of the host alone:
  CUPTI's kernel tracing adds a gap of 1-3 us after every kernel of a
  replay, which the marks would count).

The joint model runs at 190x190, the smallest frame its UNet takes.  The
profiler's timestamps are on the Unix clock and the records' on
``time.perf_counter``; a record's interval is compared after shifting it by
the two clocks' offset, read beside the trace, within ``CLOCK_SLACK_S`` (the
profiler maps its clock to Unix time by a fitted line)."""

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.vitfly import ConvNet
from evfly_tpu_torch.parallel.data_parallel import make_dp_chunked_train_step
from evfly_tpu_torch.parallel.mesh import Mesh
from evfly_tpu_torch.stream.pipeline import (BatchedStreamingPipeline, StreamingPipeline,
                                             event_bucket)
from evfly_tpu_torch.train import stepfn
from evfly_tpu_torch.utils import profiling
from torch_dp_cases import CONVNET_HW, CONVNET_LOSS, LR, chunk_idxs, resident_split, torch_split
from torch_helpers import cuda_device  # noqa: F401 (fixture)

HW = (190, 190)
CLOCK_SLACK_S = 50e-6
LAYERS = ("evfly.stream.fill", "evfly.frame", "evfly.depth", "evfly.head")


@pytest.fixture(autouse=True)
def no_records():
    torch.set_num_threads(2)
    profiling.clear()
    yield
    profiling.clear()


def _joint(device="cpu"):
    return OrigUNet_w_VITFLY_ViTLSTM(
        generator=torch.Generator().manual_seed(5), device=device, input_shape=[1, 1, *HW],
        num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0], velpred=0, form_BEV=2,
        evs_min_cutoff=0.0, skip_type="interp").eval()


def _window(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, HW[1], n).astype(np.float32),
            rng.uniform(0, HW[0], n).astype(np.float32),
            rng.choice([-1, 1], n).astype(np.int32))


def _unix_minus_perf_s():
    """time.time() - time.perf_counter(), the least of a few readings'
    spreads taken."""
    best = None
    for _ in range(5):
        a = time.perf_counter()
        u = time.time_ns() * 1e-9
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) / 2)
    return best[1]


def test_span_is_a_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("evfly.a", events=3)
    assert profiling.span("evfly.b") is first
    with profiling.span("evfly.a", events=3):
        with profiling.span("evfly.b"):
            pass
    assert profiling.spans() == []


@pytest.mark.parametrize("n", [700, 3000])
def test_an_eager_step_records_its_layers_inside_the_profilers_ranges(n):
    pipe = StreamingPipeline(_joint(), input_hw=HW, device="cpu", graph=False)
    pipe.step_events(*_window(1, 500))   # no profiler: no records
    assert profiling.spans() == []
    offset = _unix_minus_perf_s()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.step_events(*_window(2, n))
    records = profiling.spans()
    (root,) = [r for r in records if r.parent is None]
    assert root.name == "evfly.stream.step" and root.root == root.id
    children = [r for r in records if r is not root]
    assert sorted(r.name for r in children) == sorted(LAYERS)
    assert all(r.parent == root.id and r.root == root.id for r in children)
    (fill,) = [r for r in children if r.name == "evfly.stream.fill"]
    assert fill.counts == {"events": n, "bucket": event_bucket(n)}
    assert all(r.device is None for r in records)   # the CPU: no device intervals

    start_s = prof.profiler.kineto_results.trace_start_ns() * 1e-9
    ranges = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith("evfly."):
            ranges[e.name].append((start_s + e.time_range.start * 1e-6,
                                   start_s + e.time_range.end * 1e-6))
    assert sorted(ranges) == sorted((root.name,) + LAYERS)
    for r in records:
        (lo, hi), = ranges[r.name]
        assert r.host[0] < r.host[1]
        assert lo - CLOCK_SLACK_S <= r.host[0] + offset
        assert r.host[1] + offset <= hi + CLOCK_SLACK_S


def test_stats_count_steps_and_real_against_padded_events():
    pipe = StreamingPipeline(_joint(), input_hw=HW, device="cpu")
    sizes = (700, 1024, 1025, 3000, 0)
    for i, n in enumerate(sizes):
        pipe.step_events(*_window(10 + i, n))
    pipe.step_frame(np.zeros(HW, np.float32))
    stats = pipe.stats
    by_size = collections.Counter()
    for key, steps in stats.steps.items():
        by_size[(key.kind, key.size)] += steps
    assert by_size == {("events", 1024): 3, ("events", 2048): 1, ("events", 4096): 1,
                       ("frame", HW[0] * HW[1]): 1}
    assert not stats.captures   # the CPU runs eagerly: nothing captured
    assert stats.events == sum(sizes)
    assert stats.padded_events == sum(event_bucket(n) for n in sizes)
    batched = BatchedStreamingPipeline(_joint(), 2, input_hw=HW, device="cpu")
    for _ in range(2):
        batched.step_frames(np.zeros((2, *HW), np.float32))
    assert list(batched.stats.steps.values()) == [2] and batched.stats.events == 0


def _dp_step():
    model = ConvNet(generator=torch.Generator().manual_seed(3), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = make_dp_chunked_train_step(model, "vitfly", opt, Mesh(1, 0, torch.device("cpu")),
                                      4, 1, 1, **CONVNET_LOSS)
    data = torch_split(resident_split(30, 24, 24, CONVNET_HW, 4, depth_input=True))
    return lambda i: step(data, chunk_idxs(40 + i, 4, 4, 24, 24, 1, 1), None)


def _chunk_step():
    model = ConvNet(generator=torch.Generator().manual_seed(3), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = stepfn.make_train_step(model, "vitfly", opt, num_out_channels=1,
                                  batch_fn=stepfn.make_batch_slicer(4, 1, 1), **CONVNET_LOSS)
    data = torch_split(resident_split(30, 24, 24, CONVNET_HW, 4, depth_input=True))
    return lambda i: step(data, {"start": 4 * i, "ev_start": 4 * i, "n_valid": 4}, None)


@pytest.mark.parametrize("make", [_dp_step, _chunk_step], ids=["chunk_dp", "per_chunk"])
def test_a_train_step_records_each_phase_once(make):
    step = make()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(2):
            step(i)
    records = profiling.spans()
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["evfly.train.step"] * 2
    for root in roots:
        phases = sorted(r.name for r in records if r.parent == root.id)
        assert phases == ["evfly.train.backward", "evfly.train.forward", "evfly.train.update"]
        inside = [r for r in records if r.root == root.id and r is not root]
        assert all(root.host[0] <= r.host[0] <= r.host[1] <= root.host[1] for r in inside)
    if make is _dp_step:
        # chunk_idxs' last chunk is padding: 3 real chunks a step
        assert [r.counts for r in records if r.name == "evfly.train.forward"] == [
            {"chunks": 3}] * 2


@pytest.mark.gpu
def test_graph_marks_time_a_replayed_step_on_gpu(cuda_device):
    """A captured step's marks (frame, depth, head) resolve to positive
    device intervals of each traced replay, and add up to 85-105% of the
    graph's replay timed by CUDA events around it."""
    pipe = StreamingPipeline(_joint(cuda_device), input_hw=HW, device=cuda_device)
    window = _window(3, 5000)
    pipe.step_events(*window)[0].cpu()
    (slot,) = pipe._steps.slots.values()
    assert [m[0] for m in slot.marks.marks] == ["evfly.frame", "evfly.depth", "evfly.head"]
    assert list(pipe.stats.captures.values()) == [1]
    replay_ms = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        slot.graph.replay()
        end.record()
        end.synchronize()
        replay_ms.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            pipe.step_events(*window)[0].cpu()
    records = profiling.spans()
    roots = [r for r in records if r.name == "evfly.stream.step"]
    assert len(roots) == 3
    for root in roots:
        marks = [r for r in records if r.root == root.id and r.host is None]
        assert sorted(r.name for r in marks) == ["evfly.depth", "evfly.frame", "evfly.head"]
        assert all(r.device_ms > 0 and 0 <= r.device[0] for r in marks)
        assert all(r.device[1] <= root.device[1] for r in marks)
        share = sum(r.device_ms for r in marks) / float(np.median(replay_ms))
        assert 0.85 <= share <= 1.05, (share, replay_ms)
