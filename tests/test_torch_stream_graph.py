"""The port's streaming step over static buffers (evfly_tpu_torch.stream.pipeline).

On CUDA a pipeline replays one CUDA graph per step; on the CPU it runs the
same step on the same static buffers eagerly: a window of N events padded
to ``event_bucket(N)`` events with pol 0, the hidden state written in place.
Here, on the CPU:

- the padded step against the JAX package's ``StreamingPipeline`` (one jit
  program per step, K1's Pallas kernel in interpret mode) with the trained
  joint model at 260x346, over windows of several sizes (three buckets,
  one window exactly a bucket's size, one empty), state carried, and
  against the port's own step on the unpadded window (``stream_step`` on
  ``event_histogram``), in both percentile modes;
- the state stays in the same tensors through steps, resets and masks;
- every setting that picks a kernel or an algorithm at capture changes the
  graph key, and a changed setting takes a new slot;
- a capture that fails raises and leaves no graph behind;
- the warm-up and the capture run under cuDNN's algorithm search, the
  other cuDNN flags and the precision untouched, and the search flag is
  restored after a capture that succeeds or fails;
- on a CUDA card (``gpu`` marker, skipped here): the graph step against the
  eager step, both event buckets, ``step_frame`` and ``step_frames``; the
  joint model's graph step captured under the search against its eager
  step at G = 1 and G = 16.

Tolerances, as tests/test_torch_stream.py: velocity, depth and every h
within 1e-4, every c within 1e-4 x max(1, max|c|) against JAX; against the
port's own unpadded step the same bounds (the frames are equal bit for bit,
so the steps differ at most by the order of float operations).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evfly_tpu.stream import pipeline as jpipeline
from evfly_tpu_torch import graphs, set_precision
from evfly_tpu_torch.precision import get_precision
from evfly_tpu_torch.models import recurrent
from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.ops import lstm_fused, voxelizer
from evfly_tpu_torch.stream import BatchedStreamingPipeline, StreamingPipeline
from evfly_tpu_torch.stream import pipeline
from evfly_tpu_torch.stream.pipeline import GraphKey, event_bucket, stream_step
from test_torch_stream import HW, _assert_state_close, models  # noqa: F401 (fixture)
from torch_helpers import cuda_device  # noqa: F401 (fixture)

ATOL = 1e-4
# window sizes: bucket 1,024 (below and at it), 2,048, 4,096, and an empty window
SIZES = (700, 1024, 1025, 3000, 0)


def _window(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, HW[1], n).astype(np.float32),
            rng.uniform(0, HW[0], n).astype(np.float32),
            rng.choice([-1, 1], n).astype(np.int32))


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def _close_c(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def _clone(hidden):
    """A copy of a hidden-state nest."""
    if hidden is None:
        return None
    if isinstance(hidden, (tuple, list)):
        return type(hidden)(_clone(h) for h in hidden)
    return hidden.clone()


def _assert_states_close(got, ref):
    """Two port hidden states: every h within ATOL, every c relative."""
    (unet_g, _), (h_g, c_g) = got
    (unet_r, _), (h_r, c_r) = ref
    for (hg, cg), (hr, cr) in zip(unet_g, unet_r):
        _close(hg, hr.numpy())
        _close_c(cg, cr.numpy())
    _close(h_g, h_r.numpy())
    _close_c(c_g, c_r.numpy())


@pytest.mark.parametrize("n,bucket", [(0, 1024), (1, 1024), (1024, 1024), (1025, 2048),
                                      (5000, 8192), (8192, 8192), (8193, 16384)])
def test_event_bucket(n, bucket):
    assert event_bucket(n) == bucket


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "bisection"])
def test_padded_step_matches_jax_and_the_unpadded_step(models, fast):
    """step_events over windows of SIZES events, state carried: against the
    JAX pipeline's step_events, and against stream_step on the unpadded
    window's event_histogram with its own state."""
    jm, jparams, model = models
    jpipe = jpipeline.StreamingPipeline(jm, jparams, desvel=4.0, fast_percentile=fast)
    pipe = StreamingPipeline(model, desvel=4.0, fast_percentile=fast, device="cpu")
    assert not pipe.graph
    hidden = _clone(pipe.hidden)
    desvel = torch.tensor([4.0])
    for i, n in enumerate(SIZES):
        ex, ey, ep = _window(20 + i, n)
        vt, dt = pipe.step_events(ex, ey, ep)
        vj, dj = jpipe.step_events(jnp.asarray(ex), jnp.asarray(ey), jnp.asarray(ep))
        assert vt.shape == (3,) and dt.shape == HW
        _close(vt, vj)
        _close(dt, dj)
        _assert_state_close(pipe.hidden, jpipe.hidden)
        with torch.inference_mode():
            frame = voxelizer.event_histogram(ex, ey, ep, *HW, device="cpu")
            vu, du, hidden = stream_step(model, frame, desvel, hidden, True, fast)
        _close(vt, vu.numpy())
        _close(dt, du.numpy())
        _assert_states_close(pipe.hidden, hidden)
    assert sorted(key.size for key in pipe._steps.slots) == [1024, 2048, 4096]


def test_padded_events_of_any_pol_type_give_the_same_step(models):
    """pol as int32, int64, float and the sign of larger integers: the
    same padded buffers, so the same velocity, bit for bit."""
    _, _, model = models
    ex, ey, ep = _window(3, 900)
    outs = []
    for pol in (ep, ep.astype(np.int64), ep.astype(np.float32) * 0.5, ep.astype(np.int64) * 7):
        pipe = StreamingPipeline(model, fast_percentile=True, device="cpu")
        outs.append(pipe.step_events(ex, ey, pol)[0])
        assert torch.equal(pipe._steps.slots[pipe.graph_key("events", 1024)].inputs["pol"][:900],
                           torch.from_numpy(ep))
    for v in outs[1:]:
        assert torch.equal(v, outs[0])


def test_step_events_takes_one_window(models):
    _, _, model = models
    pipe = StreamingPipeline(model, device="cpu")
    ex, ey, ep = _window(4, 10)
    with pytest.raises(ValueError, match="one window"):
        pipe.step_events(ex[None], ey[None], ep[None])
    with pytest.raises(ValueError, match="one window"):
        pipe.step_events(ex, ey[:5], ep)


def _ptrs(hidden):
    return [t.data_ptr() for t in pipeline._leaves(hidden)]


def test_state_stays_in_place_through_steps_resets_and_masks(models):
    _, _, model = models
    pipe = StreamingPipeline(model, fast_percentile=True, device="cpu")
    ptrs = _ptrs(pipe.hidden)
    frame = np.full(HW, 0.2, np.float32)
    pipe.step_frame(frame)
    pipe.step_events(*_window(5, 300))
    assert _ptrs(pipe.hidden) == ptrs
    assert any(bool(t.abs().max() > 0) for t in pipeline._leaves(pipe.hidden))
    pipe.reset()
    assert _ptrs(pipe.hidden) == ptrs
    assert all(bool((t == 0).all()) for t in pipeline._leaves(pipe.hidden))

    batched = BatchedStreamingPipeline(model, 3, fast_percentile=True, device="cpu")
    ptrs = _ptrs(batched.hidden)
    frames = np.stack([frame] * 3)
    batched.step_frames(frames)
    before = _clone(batched.hidden)
    batched.step_frames(frames, np.array([False, True, False]))
    assert _ptrs(batched.hidden) == ptrs
    # stream 1 restarted from zeros: its state is a first step's state again
    for t, b in zip(pipeline._leaves(batched.hidden), pipeline._leaves(before)):
        _close_c(t[1], b[0].numpy())


def test_desvel_change_between_steps_is_seen(models):
    """desvel set between steps scales the next step and enters its input,
    as the JAX pipeline reads ``self.desvel`` at every step."""
    _, _, model = models
    frame = np.full(HW, 0.2, np.float32)
    pipe = StreamingPipeline(model, desvel=4.0, device="cpu")
    pipe.step_frame(frame)
    pipe.desvel = 3.0
    vel, _ = pipe.step_frame(frame)
    f = torch.from_numpy(frame)
    with torch.inference_mode():
        _, _, hidden = stream_step(model, f, torch.tensor([4.0]), model.init_hidden())
        ref, _, _ = stream_step(model, f, torch.tensor([3.0]), hidden)
    _close(vel, ref.numpy())


# each setting that picks a kernel or an algorithm at capture, as a change
# to make under monkeypatch
SETTINGS = {
    "precision": lambda mp, pipe: set_precision("tf32"),
    "set_fused_lstm": lambda mp, pipe: recurrent.set_fused_lstm(False),
    "lstm.mode": lambda mp, pipe: mp.setattr(pipe.model.vitfly_vitlstm.lstm, "mode",
                                             "wavefront"),
    "K1 route": lambda mp, pipe: mp.setattr(voxelizer, "k1_route",
                                            lambda h, w, t: voxelizer.BAND_ROUTE),
    "K4/K5 route": lambda mp, pipe: mp.setattr(lstm_fused, "choose_route", lambda h, l: "l2"),
    "fast_percentile": lambda mp, pipe: mp.setattr(pipe, "fast_percentile", True),
}


@pytest.fixture
def restore_settings():
    yield
    set_precision("highest")
    recurrent.set_fused_lstm(True)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_each_setting_changes_the_graph_key(models, monkeypatch, restore_settings, setting):
    _, _, model = models
    pipe = StreamingPipeline(model, device="cpu")
    base = pipe.graph_key("events", 1024)
    assert base == pipe.graph_key("events", 1024)
    SETTINGS[setting](monkeypatch, pipe)
    assert pipe.graph_key("events", 1024) != base


def test_event_bucket_and_streams_change_the_graph_key(models):
    _, _, model = models
    pipe = StreamingPipeline(model, device="cpu")
    assert pipe.graph_key("events", 1024) != pipe.graph_key("events", 2048)
    assert pipe.graph_key("events", 1024) != pipe.graph_key("frame", 1024)
    b2 = BatchedStreamingPipeline(model, 2, device="cpu")
    b3 = BatchedStreamingPipeline(model, 3, device="cpu")
    assert b2.graph_key("frames", b2.G) != b3.graph_key("frames", b3.G)
    assert isinstance(b2.graph_key("frames", 2), GraphKey)


def test_a_changed_setting_takes_a_new_slot(models, restore_settings):
    """Stepping under another precision takes (and keeps) a slot of its
    own; stepping under the first again reuses the first slot."""
    _, _, model = models
    pipe = StreamingPipeline(model, fast_percentile=True, device="cpu")
    window = _window(6, 200)
    pipe.step_events(*window)
    first = dict(pipe._steps.slots)
    set_precision("tf32")
    pipe.step_events(*window)
    assert len(pipe._steps.slots) == 2
    set_precision("highest")
    pipe.step_events(*window)
    assert len(pipe._steps.slots) == 2
    assert all(pipe._steps.slots[k] is v for k, v in first.items())


class _FailingGraph:
    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        raise RuntimeError("capture failed")

    def __exit__(self, *exc):
        return False


def test_a_failed_capture_raises_and_leaves_no_graph(monkeypatch):
    """graphs.Steps with graphs on: a capture that raises propagates, the slot
    keeps no graph, and the state is as before the warm-up."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _NullContext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", _FailingGraph)
    state = [torch.zeros(3)]
    steps = graphs.Steps(torch.device("cuda"), True, state)
    assert steps.graph
    calls = []

    def body():
        calls.append(1)
        state[0].add_(1.0)
        return (state[0] * 2, None)

    key = GraphKey("frame", 1, "highest", (True, False), True, (), None)
    with pytest.raises(RuntimeError, match="capture failed"):
        steps.run(key, lambda: graphs.Slot({}, body), lambda bufs: None)
    assert steps.slots[key].graph is None
    assert len(calls) == graphs.WARMUP_STEPS
    assert torch.equal(state[0], torch.zeros(3))


def _cudnn_flags():
    cudnn = torch.backends.cudnn
    return (cudnn.benchmark, cudnn.allow_tf32, cudnn.enabled, cudnn.deterministic,
            get_precision())


class _Graph:
    def replay(self):
        pass


@pytest.fixture
def restore_benchmark():
    saved = torch.backends.cudnn.benchmark
    yield
    torch.backends.cudnn.benchmark = saved


@pytest.mark.parametrize("fails", [False, True], ids=["captured", "failed"])
@pytest.mark.parametrize("earlier", [False, True], ids=["heuristic", "search"])
def test_the_warmup_and_the_capture_run_under_cudnns_search(monkeypatch, restore_benchmark,
                                                             earlier, fails):
    """graphs.Steps with graphs on: every warm-up step and the capture see
    cudnn.benchmark True, the other cuDNN flags and the precision as
    before; the flag reads its earlier value after a capture that succeeds
    and after one that raises; ``searched`` counts the capture once."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _NullContext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _FailingGraph if fails else
                        (lambda graph: _NullContext()))
    torch.backends.cudnn.benchmark = earlier
    before = _cudnn_flags()
    seen = []
    state = [torch.zeros(3)]

    def body():
        seen.append(_cudnn_flags())
        return (state[0] * 2, None)

    steps = graphs.Steps(torch.device("cuda"), True, state)
    key = GraphKey("frame", 1, "highest", (True, False), True, (), None)
    run = lambda: steps.run(key, lambda: graphs.Slot({}, body), lambda bufs: None)  # noqa: E731
    if fails:
        with pytest.raises(RuntimeError, match="capture failed"):
            run()
        assert len(seen) == graphs.WARMUP_STEPS and not steps.stats.searched
    else:
        for _ in range(3):
            run()
        assert len(seen) == graphs.WARMUP_STEPS + 1
        assert steps.stats.searched[key] == steps.stats.captures[key] == 1
        assert steps.stats.steps[key] == 3
    assert all(flags == (True, *before[1:]) for flags in seen)
    assert _cudnn_flags() == before


class _Stream:
    def wait_stream(self, other):
        pass


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _joint(dev):
    cfg = dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
               input_shape=[1, 1, *HW], velpred=0, form_BEV=2, evs_min_cutoff=0.0,
               skip_type="interp")
    return OrigUNet_w_VITFLY_ViTLSTM(device=dev, **cfg).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["stacked", "wavefront"])
def test_graph_step_matches_the_eager_step_on_gpu(cuda_device, mode):
    """step_events (two buckets), step_frame and step_frames (a reset
    mask) replayed as graphs against the same steps run eagerly."""
    model = _joint(cuda_device)
    model.vitfly_vitlstm.lstm.mode = mode
    g = StreamingPipeline(model, device=cuda_device)
    e = StreamingPipeline(model, device=cuda_device, graph=False)
    assert g.graph and not e.graph
    for i, n in enumerate((5000, 1500, 5000, 700)):
        window = tuple(torch.as_tensor(v, device=cuda_device) for v in _window(30 + i, n))
        for (a, b) in zip(g.step_events(*window), e.step_events(*window)):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
        _assert_states_close(_cpu(g.hidden), _cpu(e.hidden))
    frame = torch.full(HW, 0.2, device=cuda_device)
    for (a, b) in zip(g.step_frame(frame), e.step_frame(frame)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    assert len(g._steps.slots) == 4 and all(s.graph is not None
                                            for s in g._steps.slots.values())
    bg = BatchedStreamingPipeline(model, 4, device=cuda_device)
    be = BatchedStreamingPipeline(model, 4, device=cuda_device, graph=False)
    frames = torch.full((4, *HW), 0.2, device=cuda_device)
    for mask in (None, None, torch.tensor([False, True, False, True], device=cuda_device)):
        for (a, b) in zip(bg.step_frames(frames, mask), be.step_frames(frames, mask)):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("streams", [1, 16])
def test_graph_step_captured_under_the_search_matches_the_eager_step_on_gpu(cuda_device,
                                                                            streams):
    """The joint model's graph step, its convolutions' algorithms picked by
    cuDNN's search at the capture's warm-up (the graph steps first, so no
    shape of it ran under the heuristic before), against the eager step
    under the heuristic; cudnn.benchmark and the precision flags read as
    before the capture."""
    model = _joint(cuda_device)
    before = _cudnn_flags()
    assert not before[0]
    gen = torch.Generator(device=cuda_device).manual_seed(streams)
    if streams == 1:
        g = StreamingPipeline(model, device=cuda_device)
        e = StreamingPipeline(model, device=cuda_device, graph=False)
        step = lambda p, f: p.step_frame(f[0])  # noqa: E731
    else:
        g = BatchedStreamingPipeline(model, streams, device=cuda_device)
        e = BatchedStreamingPipeline(model, streams, device=cuda_device, graph=False)
        step = lambda p, f: p.step_frames(f)  # noqa: E731
    for _ in range(3):
        frames = torch.where(torch.rand(streams, *HW, device=cuda_device, generator=gen) < 0.1,
                             0.2, 0.0)
        for (a, b) in zip(step(g, frames), step(e, frames)):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
        _assert_states_close(_cpu(g.hidden), _cpu(e.hidden))
        assert _cudnn_flags() == before
    (key,) = g._steps.slots
    assert g.stats.searched[key] == g.stats.captures[key] == 1


def _cpu(hidden):
    if hidden is None:
        return None
    if isinstance(hidden, (tuple, list)):
        return type(hidden)(_cpu(h) for h in hidden)
    return hidden.cpu()
