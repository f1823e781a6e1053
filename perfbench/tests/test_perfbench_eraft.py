"""The benchmark's pieces for E-RAFT (``eraft.flow.g1``), on the CPU at small
sizes (128x160, every width as published):

* the E-RAFT reference against the port's plain path (the voxel grid
  exactly, the model's two flows within f32 tolerances);
* the voxel grid's, the correlation's and the lookups' bytes and operations
  against hand-worked values;
* the new readers (``voxel_roofline``, ``corr_roofline``,
  ``lookup_roofline``, ``encode_ms``, ``refine_ms``, ``warm_ms``) on
  hand-made records, None where their span is absent;
* the check through a whole run: the sound program correct, and each
  planted fault not: no warm start, the lookup's offsets in the natural
  order, one pyramid level dropped, 11 iterations, the current window used
  as the previous one, the normalisation over all cells.  The reference in
  TF32 (the control) failing the limits is the ``gpu`` case (TF32 exists
  only on the card): the control, and TF32 alone (the voxel grid summed in
  f64 on both sides) failing ``flow`` or ``low``.

Every case runs the cell's weights, the flow head's last layer drawn at
``reference.eraft.FLOW_HEAD_SCALE``.
"""

import copy
import time

import numpy as np
import pytest
import torch

from evfly_tpu_torch.models import eraft as port
from evfly_tpu_torch.ops import voxelizer
from evfly_tpu_torch.utils import profiling
from perfbench import harness, tracing
from perfbench.counts import eraft as counts
from perfbench.metrics import (corr_roofline, encode_ms, lookup_roofline, refine_ms,
                               voxel_roofline, warm_ms)
from perfbench.reference import eraft as ref
from perfbench.tests import cells

FLOW = "eraft.flow.g1"
SMALL = ({"sensor_hw": [128, 160]},
         {"pool": 4, "events_per_window": {"law": "log_uniform", "lo": 3000, "hi": 30000},
          "check_start_steps": 2, "check_samples": 2, "trace_steps": 2, "warmup_rounds": 1})


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cell(seed=11):
    cell = harness.load_cell(cells.ROOT, FLOW, seed, 0.0, False)
    config, traffic = SMALL
    cell.config = {**cell.config, **config}
    cell.traffic = {**copy.deepcopy(cell.traffic), **traffic}
    cell.device = torch.device("cpu")
    return cell


def test_the_reference_matches_the_ports_plain_path():
    sd = ref.init_weights(21, "cpu")
    hw = (128, 160)
    rect = ref.rectify_map(22, hw)
    model = port.ERAFT(device="cpu", sensor_hw=hw).load_params(
        {k: v.clone() for k, v in sd.items()}).eval().set_rectify_map(rect)
    r = np.random.default_rng(0)
    grids = []
    for n in (20000, 7000):
        ev = [torch.as_tensor(v) for v in (r.integers(0, 160, n).astype(np.int16),
                                           r.integers(0, 128, n).astype(np.int16),
                                           r.choice(np.array([-1, 1], np.int8), n),
                                           np.sort(r.integers(0, 100000, n)))]
        grid = ref.voxel_grid(*ev, rect)
        assert torch.equal(voxelizer.voxel_grid(*ev, n, model.rectify_map, 15), grid)
        grids.append(grid)
    init = torch.randn(2, 16, 20, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        low, up = model(grids[0][None], grids[1][None], init[None])
        rlow, rup, _ = ref.forward(sd, grids[0], grids[1], init)
    assert up.shape == (1, 2, 128, 160) and low.shape == (1, 2, 16, 20)
    scale = lambda t: float(t.abs().max())  # noqa: E731
    assert float((low[0] - rlow).abs().max()) < 2e-5 * scale(rlow)
    assert float((up[0] - rup).abs().max()) < 2e-5 * scale(rup)


def test_the_counts():
    # 13 bytes an event and 8 of its map entry; the grid written, read and written
    assert counts.voxel(1000, 2, 4, 5) == (21 * 1000 + 12 * 40, 32 * 1000 + 80)
    # two 3-channel 2x2 maps; levels of 16 and 4 values; 2 x 4 x 4 x 3 operations
    assert counts.corr(2, 2, 3, 2) == (4 * (2 * 3 * 4 + 16 + 4), 96)
    assert counts.corr()[1] == 2 * 4800 ** 2 * 256
    # radius 1 on a 2x2 map: each position's window clipped to the 2x2 level
    assert counts.lookup(2, 2, 1, 1) == (4 * (16 + 36), 8 * 36)
    # two levels of 4x4 and 2x2, radius 1: level 0 windows [p - 1, p + 2] clipped, of 3,
    # 4, 3, 2 cells an axis; level 1 (centres 0, 0, 1, 1) of 2 each
    assert counts.lookup(4, 4, 2, 1) == (4 * (12 * 12 + 8 * 8 + 2 * 16 * 9), 8 * 2 * 16 * 9)


def _ctx(steps, least_s=None):
    s = tracing.reduce([], [], steps=steps, window_s=1.0, least_s=least_s or {})
    return tracing.Context(s, steps=0, seconds=0.0, step_times=[], peaks={})


def _rec(rid, name, root, device_ms=None, **kw):
    device = None if device_ms is None else (1.0, 1.0 + device_ms)
    return profiling.Record(rid, name, None if rid == root else root, root, None, kw, device)


def _flow_steps():
    out = []
    for k in range(2):
        root = 100 * k
        out.append(profiling.Record(root, "evfly.stream.step", None, root, (0.0, 0.03), {},
                                    (0.0, 25.0)))
        out.append(_rec(root + 1, "evfly.frame", root, 0.5 + 0.1 * k))
        out.append(_rec(root + 2, "evfly.eraft.encode", root, 6.0))
        out.append(_rec(root + 3, "evfly.eraft.corr", root, 0.4))
        out.append(_rec(root + 4, "evfly.eraft.refine", root, 12.0 + k, iterations=12))
        for i in range(12):
            out.append(_rec(root + 10 + i, "evfly.eraft.lookup", root, 0.1, levels=4,
                            radius=4, positions=4800))
        out.append(_rec(root + 30, "evfly.eraft.warm", root, 0.3))
    return out


def test_the_readers_on_hand_made_records(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: _flow_steps())
    ctx = _ctx(2, {"voxel": 2 * 0.02e-3, "corr": 2 * 0.2e-3, "lookup": 2 * 0.06e-3})
    assert encode_ms.read(ctx) == pytest.approx(6.0)
    assert refine_ms.read(ctx) == pytest.approx(12.5)
    assert warm_ms.read(ctx) == pytest.approx(0.3)
    # 0.02 ms least a step over 0.55 device ms a step of evfly.frame
    assert voxel_roofline.read(ctx) == pytest.approx(100 * 0.02 / 0.55)
    assert corr_roofline.read(ctx) == pytest.approx(50.0)
    # 12 lookups of 0.1 ms a step against 0.06 ms least
    assert lookup_roofline.read(ctx) == pytest.approx(5.0)
    assert voxel_roofline.read(_ctx(2)) is None   # no work counted: nothing to read
    monkeypatch.setattr(profiling, "spans", lambda: [])
    for reader in (encode_ms, refine_ms, warm_ms, voxel_roofline, corr_roofline,
                   lookup_roofline):
        assert reader.read(ctx) is None


def test_the_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    ctx = _ctx(2, {"voxel": 1e-5, "corr": 1e-4, "lookup": 1e-4})
    for reader in (encode_ms, refine_ms, warm_ms, voxel_roofline, corr_roofline,
                   lookup_roofline):
        assert reader.read(ctx) is None


def no_warm_start(mp):
    orig = port.ERAFT.forward
    mp.setattr(port.ERAFT, "forward",
               lambda self, a, b, init=None: orig(self, a, b, torch.zeros_like(init)))


def natural_offsets(mp):
    orig = port.lookup
    mp.setattr(port, "lookup", lambda pyramid, coords, delta: orig(pyramid, coords,
                                                                   delta.flip(-1)))


def level_dropped(mp):
    orig = port.corr_pyramid

    def pyramid(f1, f2, levels=port.LEVELS):
        out = orig(f1, f2, levels)
        return out[:-1] + [torch.zeros_like(out[-1])]

    mp.setattr(port, "corr_pyramid", pyramid)


def eleven_iterations(mp):
    mp.setattr(port, "ITERATIONS", 11)


def current_as_previous(mp):
    orig = port.ERAFT.forward
    mp.setattr(port.ERAFT, "forward", lambda self, a, b, init=None: orig(self, b, b, init))


def normalised_over_all_cells(mp):
    mp.setattr(voxelizer, "_normalise_nonzero",
               lambda v: ((v - v.mean()) / v.std()).to(torch.float32))


FAULTS = {f.__name__: f for f in (no_warm_start, natural_offsets, level_dropped,
                                  eleven_iterations, current_as_previous,
                                  normalised_over_all_cells)}


def _run(cell):
    return harness.run_cell(cell, time.perf_counter(), max_steps=cells.STEPS)


def test_the_sound_program_is_correct():
    cell = small_cell()
    cell.trace = True
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["checks"]["warm"]["value"] == 0.0
    assert {"mfu.flow", "fill_ms.flow", "pad_share.flow"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run(small_cell())
    assert not result["correct"], result["checks"]


@pytest.mark.gpu
def test_the_control_fails_erafts_limits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 exists only there)")
    cell = harness.load_cell(cells.ROOT, FLOW, 5, 0.0, False)
    cell.traffic = {**cell.traffic, "pool": 8, "check_samples": 2}
    cell.device = torch.device("cuda", 0)
    driver = harness.importlib.import_module("perfbench.drivers.stream_flow").Driver(cell)
    driver.setup()
    harness.window(driver, 0.0, 6)
    driver.free_program()
    program, control = driver.check(), driver.control()
    tf32_alone = driver.control(voxel_f32=False)
    assert harness.judge(program, cell.limits)[0], program
    assert not harness.judge(control, cell.limits)[0], control
    assert tf32_alone["voxel"] == 0.0, tf32_alone
    assert not harness.judge(tf32_alone, cell.limits)[0], tf32_alone
