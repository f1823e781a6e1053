"""The readers of the program's spans (``metrics/_spans.py`` and the ten
metrics over it) on hand-made records: each value, and None where its span
is absent or the program keeps no records."""

import pytest

from evfly_tpu_torch.utils import profiling
from perfbench import tracing
from perfbench.metrics import (backward_ms, depth_ms, dispatch_ms, fill_ms, forward_ms,
                               frame_ms, head_ms, pad_share, replay_ms, update_ms)

READERS = (frame_ms, depth_ms, head_ms, fill_ms, replay_ms, pad_share, dispatch_ms,
           forward_ms, backward_ms, update_ms)


def _ctx(steps):
    s = tracing.reduce([], [], steps=steps, window_s=1.0, least_s={})
    return tracing.Context(s, steps=0, seconds=0.0, step_times=[], peaks={})


def _rec(rid, name, root, host_ms=None, device_ms=None, parent=None, **counts):
    host = None if host_ms is None else (10.0 * rid, 10.0 * rid + host_ms * 1e-3)
    device = None if device_ms is None else (1.0, 1.0 + device_ms)
    return profiling.Record(rid, name, parent if parent is not None else (
        None if rid == root else root), root, host, counts, device)


def _stream_steps():
    """Three streaming steps; the last one's marks never read (device None),
    as a step whose graph was not replayed again before the records were."""
    out = []
    for k, (n, bucket, marks) in enumerate([(700, 1024, (0.5, 4.0, 1.0)),
                                            (3000, 4096, (0.7, 4.2, 1.2)),
                                            (1024, 1024, None)]):
        root = 100 * k
        out += [_rec(root, "evfly.stream.step", root, host_ms=6.0),
                _rec(root + 1, "evfly.stream.fill", root, host_ms=0.1 + k, events=n,
                     bucket=bucket),
                _rec(root + 2, "evfly.stream.replay", root, host_ms=0.8)]
        for j, name in enumerate(("evfly.frame", "evfly.depth", "evfly.head")):
            out.append(_rec(root + 3 + j, name, root,
                            device_ms=None if marks is None else marks[j]))
    return out


@pytest.fixture
def kept(monkeypatch):
    """Hand the readers the given records as the program's."""
    def use(records):
        monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return use


def test_streaming_readers(kept):
    kept(_stream_steps())
    ctx = _ctx(3)
    # device ms over the two steps whose marks were read
    assert frame_ms.read(ctx) == pytest.approx(0.6)
    assert depth_ms.read(ctx) == pytest.approx(4.1)
    assert head_ms.read(ctx) == pytest.approx(1.1)
    # host ms over all three
    assert fill_ms.read(ctx) == pytest.approx((0.1 + 1.1 + 2.1) / 3)
    assert replay_ms.read(ctx) == pytest.approx(0.8)
    assert pad_share.read(ctx) == pytest.approx(100.0 * (6144 - 4724) / 6144)
    for reader in (dispatch_ms, forward_ms, backward_ms, update_ms):
        assert reader.read(ctx) is None


def test_a_layer_in_two_spans_of_a_step_adds_up(kept):
    kept([_rec(0, "evfly.stream.step", 0, host_ms=5.0),
          _rec(1, "evfly.frame", 0, device_ms=0.25), _rec(2, "evfly.frame", 0, device_ms=0.5)])
    assert frame_ms.read(_ctx(1)) == pytest.approx(0.75)


def test_serving_reader(kept):
    records = []
    for k in range(2):
        records += [_rec(10 * k, "evfly.frame", 10 * k, host_ms=0.25, device_ms=0.5),
                    _rec(10 * k + 1, "evfly.head", 10 * k + 1, host_ms=7.0, device_ms=9.0)]
    kept(records)
    assert dispatch_ms.read(_ctx(2)) == pytest.approx(7.25)
    assert dispatch_ms.read(_ctx(0)) is None
    assert frame_ms.read(_ctx(2)) == pytest.approx(0.5)   # each its own step here


def test_training_readers(kept):
    records = []
    for k in range(2):
        root = 10 * k
        records += [_rec(root, "evfly.train.step", root, host_ms=250.0),
                    _rec(root + 1, "evfly.train.forward", root, host_ms=80.0 + k, chunks=8),
                    _rec(root + 2, "evfly.depth", root, host_ms=50.0, parent=root + 1),
                    _rec(root + 3, "evfly.train.backward", root, host_ms=120.0),
                    _rec(root + 4, "evfly.train.update", root, host_ms=30.0)]
    kept(records)
    ctx = _ctx(2)
    assert forward_ms.read(ctx) == pytest.approx(80.5)
    assert backward_ms.read(ctx) == pytest.approx(120.0)
    assert update_ms.read(ctx) == pytest.approx(30.0)
    for reader in (frame_ms, head_ms, fill_ms, replay_ms, pad_share, dispatch_ms):
        assert reader.read(ctx) is None


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.split(".")[-1])
def test_nothing_to_read_is_silent(kept, monkeypatch, reader):
    kept([])
    assert reader.read(_ctx(3)) is None
    # a program that keeps no records at all
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(_ctx(3)) is None
