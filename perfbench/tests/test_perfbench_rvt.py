"""The benchmark's pieces for RVT-B (``rvt.detect.g1``) and the closed loop
(``joint.closed_loop.g16``), on the CPU at small sizes:

* the RVT reference against the port's plain path (the published 6x10
  partition at 192x320, the histogram exactly);
* the histogram's bytes against hand-worked values;
* the new readers (``attention_ms``, ``convlstm_ms``, ``dethead_ms``,
  ``render_ms``, ``hist_roofline``) on hand-made records, None where their
  span is absent;
* both checks through a whole run (the closed loop's on
  ``joint.stream.g16``'s cell: it has no cell of its own): the sound program correct, and
  each planted fault not: RVT's grid attention dropped, its window and grid
  swapped, one stage's state not carried; the closed loop's state
  unchanged and its answer altered.  The reference in TF32 (the control)
  failing the limits is the ``gpu`` case (TF32 exists only on the card).
"""

import copy
import json
import time

import numpy as np
import pytest
import torch

from evfly_tpu_torch.models import rvt as port
from evfly_tpu_torch.ops.voxelizer import stacked_histogram
from evfly_tpu_torch.utils import profiling
import evfly_tpu_torch.stream.pipeline as pipeline
from perfbench import harness, tracing
from perfbench.counts import rvt as counts
from perfbench.metrics import (attention_ms, convlstm_ms, dethead_ms, hist_roofline,
                               render_ms)
from perfbench.reference import rvt as ref
from perfbench.tests import cells

RVT, LOOP = "rvt.detect.g1", "joint.closed_loop.g16"
SMALL = {
    RVT: ({"sensor_hw": [128, 128], "frame_hw": [64, 64], "partition": [2, 2]},
          {"pool": 4, "events_per_window": {"law": "log_uniform", "lo": 300, "hi": 3000},
           "check_start_steps": 2, "check_samples": 2, "trace_steps": 2, "warmup_rounds": 1}),
    LOOP: ({"input_hw": [190, 190]},
           {"streams": 2, "batches": 2, "max_steps": 30, "warmup_ticks": 1, "units_per_step": 2,
            "check_start_steps": 2, "check_samples": 2, "trace_steps": 2}),
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cell(workload, seed=11):
    """The cell cut to CPU sizes; the closed loop, whose traffic and limits
    are kept without a cell in BENCHMARK.json (PERF.md section 7), runs on
    joint.stream.g16's cell."""
    if workload == LOOP:
        cell = harness.load_cell(cells.ROOT, "joint.stream.g16", seed, 0.0, False)
        cell.name = LOOP
        cell.traffic = json.loads((cells.ROOT / "perfbench" / "traffic" /
                                   "closed_loop.g16.json").read_text())
        cell.limits = json.loads((cells.ROOT / "perfbench" / "limits" /
                                  f"{LOOP}.json").read_text())
    else:
        cell = harness.load_cell(cells.ROOT, workload, seed, 0.0, False)
    config, traffic = SMALL[workload]
    cell.config = {**cell.config, **config}
    cell.traffic = {**copy.deepcopy(cell.traffic), **traffic}
    cell.device = torch.device("cpu")
    return cell


def test_the_reference_matches_the_ports_plain_path_at_the_published_partition():
    sd = ref.init_weights(21, "cpu")
    frame_hw = (192, 320)
    model = port.RVT(device="cpu", sensor_hw=(384, 640), frame_hw=frame_hw).load_params(
        {k: v.clone() for k, v in sd.items()}).eval()
    r = np.random.default_rng(0)
    n = 20000
    ev = [torch.as_tensor(v) for v in (r.integers(0, 640, n).astype(np.int16),
                                       r.integers(0, 384, n).astype(np.int16),
                                       r.choice(np.array([-1, 1], np.int8), n),
                                       np.sort(r.integers(0, 50000, n)))]
    frame = ref.histogram(*ev, frame_hw=frame_hw)
    assert torch.equal(stacked_histogram(*ev, n, 10, frame_hw), frame)
    with torch.no_grad():
        raw, dec, hidden = model(frame[None])
        rraw, rdec, rhidden = ref.forward(sd, frame[None])
    assert raw.shape == rraw.shape == (1, 24 * 40 + 12 * 20 + 6 * 10, 8)
    scale = lambda t: float(t.abs().max())  # noqa: E731
    assert float((raw - rraw).abs().max()) < 2e-5 * scale(rraw)
    assert float((dec - rdec).abs().max()) < 2e-5 * scale(rdec)
    for (h, c), (rh, rc) in zip(hidden, rhidden):
        assert float((c - rc).abs().max()) < 2e-5 * scale(rc)


def test_the_histograms_bytes():
    n_bytes, ops = counts.hist(1000)
    assert n_bytes == 13 * 1000 + 4 * 20 * 384 * 640 and ops == 1000
    assert counts.hist(0, 2, 4, 5) == (4 * 4 * 4 * 5, 0)


def _ctx(steps, least_s=None):
    s = tracing.reduce([], [], steps=steps, window_s=1.0, least_s=least_s or {})
    return tracing.Context(s, steps=0, seconds=0.0, step_times=[], peaks={})


def _rec(rid, name, root, device_ms=None, **counts):
    device = None if device_ms is None else (1.0, 1.0 + device_ms)
    return profiling.Record(rid, name, None if rid == root else root, root, None, counts, device)


def _detect_steps():
    out = []
    for k in range(2):
        root = 100 * k
        out.append(profiling.Record(root, "evfly.stream.step", None, root, (0.0, 0.01), {},
                                    (0.0, 8.0)))
        out.append(_rec(root + 1, "evfly.frame", root, 0.25 + 0.05 * k))
        for s in range(4):
            out.append(_rec(root + 10 + s, "evfly.rvt.attention", root, 0.5 + s, stage=s + 1,
                            tokens=10, partitions=2))
            out.append(_rec(root + 20 + s, "evfly.rvt.lstm", root, 0.1, stage=s + 1, tokens=10))
        out.append(_rec(root + 30, "evfly.rvt.head", root, 1.5 + k))
    return out


def test_the_readers_on_hand_made_records(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: _detect_steps())
    ctx = _ctx(2, {"hist": 2 * 0.1e-3})
    assert attention_ms.read(ctx) == pytest.approx(0.5 + 1.5 + 2.5 + 3.5)
    assert convlstm_ms.read(ctx) == pytest.approx(0.4)
    assert dethead_ms.read(ctx) == pytest.approx(2.0)
    # 0.1 ms least a step over 0.275 device ms a step of evfly.frame
    assert hist_roofline.read(ctx) == pytest.approx(100 * 0.1 / 0.275)
    assert render_ms.read(ctx) is None
    renders = [_rec(7 + i, "evfly.sim.render", 7 + i, 1.0 + i) for i in range(3)]
    monkeypatch.setattr(profiling, "spans", lambda: renders)
    assert render_ms.read(ctx) == pytest.approx(2.0)
    assert hist_roofline.read(ctx) is None and attention_ms.read(ctx) is None
    monkeypatch.setattr(profiling, "spans", lambda: _detect_steps())
    assert hist_roofline.read(_ctx(2)) is None  # no work counted: nothing to read


def test_the_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    for reader in (attention_ms, convlstm_ms, dethead_ms, render_ms, hist_roofline):
        assert reader.read(_ctx(2, {"hist": 1e-4})) is None


def grid_dropped(mp):
    orig = port.PartitionBlock.forward
    mp.setattr(port.PartitionBlock, "forward",
               lambda self, z: z if self.kind == "grid" else orig(self, z))


def window_grid_swapped(mp):
    mp.setitem(port.PARTITIONS, "window", (port.grid_partition, port.grid_unpartition))
    mp.setitem(port.PARTITIONS, "grid", (port.window_partition, port.window_unpartition))


def stage_state_not_carried(mp):
    orig = port.Stage.forward

    def forward(self, x, state):
        if self.index == 2:
            state = tuple(torch.zeros_like(t) for t in state)
        return orig(self, x, state)

    mp.setattr(port.Stage, "forward", forward)


def _clone(nest):
    if isinstance(nest, (tuple, list)):
        return type(nest)(_clone(t) for t in nest)
    return None if nest is None else nest.clone()


def loop_state_unchanged(mp):
    orig = pipeline._step_body
    mp.setattr(pipeline, "_step_body",
               lambda model, hidden, *a, **k: orig(model, _clone(hidden), *a, **k))


def loop_answer_altered(mp):
    orig = pipeline.stream_step

    def altered(*a, **k):
        vel, depth, hidden = orig(*a, **k)
        return vel + 1e-3, depth, hidden

    mp.setattr(pipeline, "stream_step", altered)


FAULTS = {
    (RVT, "grid_dropped"): grid_dropped,
    (RVT, "window_grid_swapped"): window_grid_swapped,
    (RVT, "stage_state_not_carried"): stage_state_not_carried,
    (LOOP, "state_unchanged"): loop_state_unchanged,
    (LOOP, "answer_altered"): loop_answer_altered,
}


def _run(cell):
    return harness.run_cell(cell, time.perf_counter(), max_steps=cells.STEPS)


@pytest.mark.parametrize("workload", [RVT, LOOP])
def test_the_sound_program_is_correct(workload):
    result = _run(small_cell(workload))
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_a_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[workload, fault](monkeypatch)
    result = _run(small_cell(workload))
    assert not result["correct"], result["checks"]


@pytest.mark.gpu
def test_the_control_fails_rvts_limits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 exists only there)")
    cell = harness.load_cell(cells.ROOT, RVT, 5, 0.0, False)
    cell.traffic = {**cell.traffic, "pool": 8, "check_samples": 2, "check_start_steps": 2}
    cell.device = torch.device("cuda", 0)
    driver = harness.importlib.import_module("perfbench.drivers.stream_detect").Driver(cell)
    driver.setup()
    harness.window(driver, 0.0, 6)
    driver.free_program()
    correct, checks = harness.judge(driver.control(), cell.limits)
    assert not correct, checks
