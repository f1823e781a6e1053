"""The trace reader: the idle share from the union of intervals, the kernel
classes, the breakdown, and the readers over a synthetic summary."""

import pytest

from perfbench import tracing
from perfbench.metrics import device_idle, k1_roofline, launches_per_step, mfu


def test_union_merges_overlaps():
    assert tracing.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == [(0, 3), (5, 6)]
    assert tracing.covered([(0, 2), (1, 3), (5, 6)]) == 4


def test_overlapping_kernels_keep_the_idle_share_in_range():
    # three streams' kernels overlap: their durations add up to more than the
    # window (a share of -0.8 by sums); the union is 8 of 10 s
    ops = [(0.0, 6.0, "a"), (1.0, 7.0, "b"), (2.0, 8.0, "c")]
    s = tracing.reduce(ops, [], steps=1, window_s=10.0, least_s={})
    assert sum(e - b for b, e, _ in ops) > s.window_s
    assert s.busy_s == pytest.approx(8.0)
    share = device_idle.read(_ctx(s, steps=1, seconds=10.0))
    assert 0.0 <= share <= 100.0 and share == pytest.approx(20.0)


def test_the_idle_share_leaves_out_the_profilers_overhead():
    # the profiler stretched 2 traced steps to 20 s; unprofiled, the window
    # ran 5 steps in 25 s: 8 busy s a step of 12.5 s is 36% idle, not 60%
    s = tracing.reduce([(0.0, 8.0, "a"), (10.0, 18.0, "b")], [], steps=2, window_s=20.0,
                       least_s={})
    assert device_idle.read(_ctx(s, steps=5, seconds=62.5)) == pytest.approx(36.0)


def test_classes_breakdown_and_gaps():
    ops = [(0.0, 1.0, "hist_frame_cluster_kernel<8>"), (0.5, 1.5, "lstm_cluster_kernel<128>"),
           (3.0, 4.0, "Memcpy HtoD (Pageable -> Device)"), (6.0, 7.0, "sm90_xmma_fprop_conv")]
    host = [(0.0, 10.0, "perfbench.step"), (1.6, 2.9, "aten::copy_"), (4.0, 6.0, "cudaGraphLaunch")]
    s = tracing.reduce(ops, host, steps=2, window_s=10.0, least_s={"k1": 0.5})
    assert s.kernels == 3
    assert s.class_s == {"k1": 1.0, "lstm": 1.0, "conv": 1.0}
    assert dict(s.breakdown["idle_gaps"]) == {"aten::copy_": 1.5, "cudaGraphLaunch": 2.0}
    assert len(s.breakdown["device_ops"]) == 4
    ctx = _ctx(s)
    assert k1_roofline.read(ctx) == pytest.approx(50.0)
    assert launches_per_step.read(ctx) == 1.5


def test_a_reader_with_nothing_to_read_is_silent():
    s = tracing.reduce([], [], steps=3, window_s=1.0, least_s={"k1": 1e-6})
    ctx = _ctx(s)
    assert k1_roofline.read(ctx) is None
    assert launches_per_step.read(ctx) is None
    assert device_idle.read(ctx) is None
    assert mfu.read(ctx) is None


def test_host_at_takes_the_innermost_span():
    spans = [(0, 10, "outer"), (2, 5, "mid"), (3, 4, "inner"), (6, 7, "other")]
    assert tracing.host_at([1, 3.5, 4.5, 6.5, 8, 11], spans) == [
        "outer", "inner", "mid", "other", "outer", "host"]


def _ctx(summary, steps=0, seconds=0.0):
    return tracing.Context(summary, steps=steps, seconds=seconds, step_times=[],
                           peaks={"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12})
