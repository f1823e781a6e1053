"""V(phi)'s serving graph: ``models.vitfly.LSTMNetVIT.forward`` replays a
CUDA graph captured for its ``ServeKey`` when the call has no autograd, is in
eval mode, starts from a zero state (``hidden`` None), takes no generator and
runs outside a graph capture; every other call runs the eager body.

On the CPU, with torch.cuda's streams, graphs and capture state stubbed as in
tests/test_torch_stream_graph.py and an input that reads as a CUDA tensor
(``_OnCard``):

- each condition of the guard, alone, keeps the call eager (and on the CPU
  every call is eager);
- the key changes with the batch shape, the precision, the fused-LSTM
  switch, the LSTM's mode, ``load_params`` and a replaced parameter; new
  weights drop the old slot of the same inputs, and only that one;
- the warm-up and the capture run under cuDNN's algorithm search, the
  caller's flag restored after a capture that succeeds or fails;
- a deep copy of a served model keeps its counters and no graph;
- ``serve_stats`` counts calls, captures and searched captures per key, and
  the count ``replayed`` lands on the ``evfly.head`` record, the serving
  graph's own spans named ``evfly.serve.*``;
- ``perfbench/metrics/graph_share.py`` reads 100, 0 and None on made-up
  records.

On a CUDA card (``gpu`` marker, skipped here): the replay against the eager
forward at (256, 1, 60, 90) within ``vitlstm.serve.b256``'s limits
(perfbench/limits), a second batch size capturing a second key; after
``load_params`` the replay against the new eager forward; a streaming
pipeline over the joint model leaving the head's serving counters empty.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from evfly_tpu_torch import set_precision
from evfly_tpu_torch.models import recurrent
from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.vitfly import LSTMNetVIT, ServeKey
from evfly_tpu_torch.stream import pipeline
from evfly_tpu_torch.stream.pipeline import StreamingPipeline
from evfly_tpu_torch.utils import profiling
from perfbench.metrics import graph_share
from torch_helpers import cuda_device  # noqa: F401 (fixture)

N = 3
# vitlstm.serve.b256's limits: the largest |program - reference| over the
# reference's largest |value|
VEL_LIMIT, STATE_LIMIT = 3.5e-5, 4.6e-5


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a CUDA one where the guard and the key
    look (``is_cuda``, ``device``); whatever is computed from it is a plain
    CPU tensor."""
    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    def replay(self):
        pass


class _FailingGraph:
    def __init__(self, graph):
        pass

    def __enter__(self):
        raise RuntimeError("capture failed")

    def __exit__(self, *exc):
        return False


@pytest.fixture
def card(monkeypatch):
    """torch.cuda's streams and graphs as stand-ins: a capture runs the body
    once, a replay does nothing.  Yields the monkeypatch."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(pipeline, "_WARMUP_STREAMS", {})
    saved = torch.backends.cudnn.benchmark
    yield monkeypatch
    torch.backends.cudnn.benchmark = saved
    set_precision("highest")
    recurrent.set_fused_lstm(True)


@pytest.fixture(autouse=True)
def no_records():
    profiling.clear()
    yield
    profiling.clear()


def _model(seed=0):
    return LSTMNetVIT(generator=torch.Generator().manual_seed(seed), device="cpu").eval()


def _inputs(seed=1, n=N):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(n, 1, 60, 90, generator=gen), torch.full((n, 1), 4.0)


def _zeros(lead=()):
    return torch.zeros(*lead, 3, 128), torch.zeros(*lead, 3, 128)


def _eager(model, img, desvel):
    """The forward from a given zero state: the eager body whatever the
    call's mode."""
    with torch.no_grad():
        vel, (h, c) = model(img, desvel, None, _zeros())
    return vel, h, c


def _assert_equal(got, ref):
    vel, (h, c) = got
    for a, b in zip((vel, h, c), ref):
        torch.testing.assert_close(a.detach(), b, atol=1e-6, rtol=0)


def _served(model):
    return sum(model.serve_stats.steps.values())


GUARD = {
    "grad on": lambda card, model, img, desvel: model(img, desvel),
    "train()": lambda card, model, img, desvel: _no_grad(model.train(), img, desvel),
    "hidden given": lambda card, model, img, desvel: _no_grad(model, img, desvel,
                                                              hidden=_zeros()),
    "generator given": lambda card, model, img, desvel: _no_grad(
        model, img, desvel, generator=torch.Generator().manual_seed(0)),
    "inside a capture": lambda card, model, img, desvel: _inside_capture(card, model, img,
                                                                        desvel),
    "on the CPU": lambda card, model, img, desvel: _no_grad(model, img.as_subclass(torch.Tensor),
                                                            desvel),
}


def _no_grad(model, img, desvel, **kwargs):
    with torch.no_grad():
        return model(img, desvel, **kwargs)


def _inside_capture(card, model, img, desvel):
    card.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    return _no_grad(model, img, desvel)


@pytest.mark.parametrize("case", list(GUARD))
def test_each_condition_of_the_guard_keeps_the_call_eager(card, case):
    model = _model()
    img, desvel = _inputs()
    ref = _eager(model, img, desvel)
    got = GUARD[case](card, model, img.as_subclass(_OnCard), desvel)
    _assert_equal(got, ref)
    assert _served(model) == 0 and model._serving is None


@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode])
def test_a_call_that_meets_the_guard_is_served(card, mode):
    model = _model()
    img, desvel = _inputs()
    ref = _eager(model, img, desvel)
    with mode():
        got = model(img.as_subclass(_OnCard), desvel)
    _assert_equal(got, ref)
    key = model.serve_key(img.as_subclass(_OnCard), desvel)
    assert model.serve_stats.steps == {key: 1} and model.serve_stats.captures == {key: 1}
    assert got[0].is_inference() == (mode is torch.inference_mode)


# each change that must capture anew, made to the model under the card fixture
KEY_CHANGES = {
    "batch": lambda card, model: None,
    "precision": lambda card, model: set_precision("tf32"),
    "set_fused_lstm": lambda card, model: recurrent.set_fused_lstm(False),
    "lstm.mode": lambda card, model: card.setattr(model.lstm, "mode", "wavefront"),
    "load_params": lambda card, model: model.load_params(
        {k: v.clone() for k, v in model.state_dict().items()}),
    "replaced parameter": lambda card, model: setattr(
        model.nn_fc2, "bias", torch.nn.Parameter(model.nn_fc2.bias.detach().clone())),
}


@pytest.mark.parametrize("change", list(KEY_CHANGES))
def test_each_change_changes_the_serve_key(card, change):
    model = _model()
    img, desvel = _inputs(n=N + 1 if change == "batch" else N)
    base = model.serve_key(*_inputs())
    assert isinstance(base, ServeKey) and base == model.serve_key(*_inputs())
    KEY_CHANGES[change](card, model)
    key = model.serve_key(img, desvel)
    assert key != base
    weights_only = change in ("load_params", "replaced parameter")
    assert (key._replace(weights=()) == base._replace(weights=())) == weights_only


def test_new_weights_drop_the_old_slot_of_the_same_inputs(card):
    """load_params between calls: the slot of the same inputs is replaced
    (one slot, two captures); a slot of other inputs stays until its
    inputs come again."""
    model = _model()
    small, large = _inputs(n=N), _inputs(n=N + 2)
    serve = lambda x: _no_grad(model, x[0].as_subclass(_OnCard), x[1])  # noqa: E731
    serve(small)
    serve(large)
    first = dict(model._serving.slots)
    model.load_params({k: v.clone() for k, v in model.state_dict().items()})
    serve(small)
    slots = model._serving.slots
    assert len(slots) == 2 and sum(model.serve_stats.captures.values()) == 3
    (kept,) = [k for k in first if k in slots]
    assert kept.inputs[0][0][0] == N + 2 and slots[kept] is first[kept]
    serve(large)
    assert len(slots) == 2 and not set(first) & set(slots)


def test_a_copy_of_a_served_model_keeps_its_counters_and_no_graph(card):
    """copy.deepcopy of a model that served (as bf16_accept's cast does):
    the copy's slots are empty, its counters a copy, and it serves by a
    capture of its own."""
    model = _model()
    img, desvel = _inputs()
    _no_grad(model, img.as_subclass(_OnCard), desvel)
    twin = copy.deepcopy(model)
    assert twin._serving.slots == {} and len(model._serving.slots) == 1
    assert twin.serve_stats == model.serve_stats and twin.serve_stats is twin._serving.stats
    _assert_equal(_no_grad(twin, img.as_subclass(_OnCard), desvel), _eager(model, img, desvel))
    assert sum(twin.serve_stats.captures.values()) == 2
    assert sum(model.serve_stats.captures.values()) == 1


@pytest.mark.parametrize("fails", [False, True], ids=["captured", "failed"])
@pytest.mark.parametrize("earlier", [False, True], ids=["heuristic", "search"])
def test_the_warmup_and_the_capture_run_under_cudnns_search(card, earlier, fails):
    """Every warm-up call and the capture see cudnn.benchmark True; the
    caller's value reads again after a capture that succeeds and after one
    that raises (which leaves no graph and counts no capture)."""
    if fails:
        card.setattr(torch.cuda, "graph", _FailingGraph)
    torch.backends.cudnn.benchmark = earlier
    model = _model()
    seen = []
    head = model._head

    def recording(*args, **kwargs):
        seen.append(torch.backends.cudnn.benchmark)
        return head(*args, **kwargs)

    card.setattr(model, "_head", recording)
    img, desvel = _inputs()
    if fails:
        with pytest.raises(RuntimeError, match="capture failed"):
            _no_grad(model, img.as_subclass(_OnCard), desvel)
        assert len(seen) == pipeline.WARMUP_STEPS and not model.serve_stats.captures
        assert all(slot.graph is None for slot in model._serving.slots.values())
    else:
        for _ in range(3):
            _no_grad(model, img.as_subclass(_OnCard), desvel)
        assert len(seen) == pipeline.WARMUP_STEPS + 1
    assert all(seen) and torch.backends.cudnn.benchmark == earlier


def test_serve_stats_count_and_the_head_record_carries_replayed(card):
    """Three served calls of one shape, one of another, one eager call:
    steps, captures and searched per key; under a profiler each call's
    ``evfly.head`` record with ``replayed`` 1 or 0, the served ones holding
    ``evfly.serve.fill`` and ``evfly.serve.replay`` (and the first of a key
    ``evfly.serve.capture``), no ``evfly.stream`` span."""
    from torch.profiler import ProfilerActivity, profile

    model = _model()
    a, b = _inputs(n=N), _inputs(n=N + 1)
    with profile(activities=[ProfilerActivity.CPU]):
        for img, desvel in (a, a, b, a):
            _no_grad(model, img.as_subclass(_OnCard), desvel)
        _no_grad(model, a[0], a[1], hidden=_zeros())
    ka, kb = (model.serve_key(x[0].as_subclass(_OnCard), x[1]) for x in (a, b))
    stats = model.serve_stats
    assert stats.steps == {ka: 3, kb: 1}
    assert stats.captures == stats.searched == {ka: 1, kb: 1}
    records = profiling.spans()
    heads = [r for r in records if r.name == "evfly.head"]
    assert [r.counts for r in heads] == [{"replayed": 1}] * 4 + [{"replayed": 0}]
    names = {h.id: sorted(r.name for r in records if r.parent == h.id) for h in heads}
    assert [names[h.id] for h in heads] == [
        ["evfly.serve.capture", "evfly.serve.fill", "evfly.serve.replay"],
        ["evfly.serve.fill", "evfly.serve.replay"],
        ["evfly.serve.capture", "evfly.serve.fill", "evfly.serve.replay"],
        ["evfly.serve.fill", "evfly.serve.replay"], []]
    assert not [r for r in records if r.name.startswith("evfly.stream")]


def _head_record(rid, replayed=None, host=True):
    counts = {} if replayed is None else {"replayed": replayed}
    return profiling.Record(rid, "evfly.head", None, rid, (1.0, 1.005) if host else None,
                            counts, None if host else (0.0, 1.0))


@pytest.mark.parametrize("records,share", [
    ([_head_record(i, 1) for i in range(4)] + [_head_record(9, 0, host=False)], 100.0),
    ([_head_record(i, 0) for i in range(3)], 0.0),
    ([_head_record(0, 1), _head_record(1, 0), _head_record(2, 1), _head_record(3, 1)], 75.0),
    ([_head_record(i) for i in range(3)], None),
    ([], None),
], ids=["replayed", "eager", "mixed", "no count", "no records"])
def test_graph_share_reader(monkeypatch, records, share):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    assert graph_share.read(None) == share


# ------------------------------------------------------------------ card

def _within(got, ref):
    """Velocity, h and c within vitlstm.serve.b256's limits."""
    vel, (h, c) = got
    for a, b, limit in zip((vel, h, c), ref, (VEL_LIMIT, STATE_LIMIT, STATE_LIMIT)):
        gap = (a - b).abs().max().item()
        assert gap <= limit * b.abs().max().item(), (gap, limit)


@pytest.mark.gpu
def test_replay_matches_the_eager_forward_on_gpu(cuda_device):
    """Batches of 256 windows (a second batch of new frames replays) and of
    64 (a second key, a second capture) against the eager forward from a
    given zero state."""
    set_precision("highest")
    model = LSTMNetVIT(device=cuda_device).eval()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    zeros = tuple(t.to(cuda_device) for t in _zeros())
    with torch.inference_mode():
        for batch in (256, 256, 64):
            img = torch.rand(batch, 1, 60, 90, device=cuda_device, generator=gen)
            desvel = torch.full((batch, 1), 4.0, device=cuda_device)
            got = model(img, desvel)
            vel, (h, c) = model(img, desvel, None, zeros)
            _within(got, (vel, h, c))
    stats = model.serve_stats
    assert sorted(stats.steps.values()) == [1, 2] and sorted(stats.captures.values()) == [1, 1]
    assert stats.searched == stats.captures and len(model._serving.slots) == 2


@pytest.mark.gpu
def test_replay_after_load_params_matches_the_new_eager_forward_on_gpu(cuda_device):
    set_precision("highest")
    model = LSTMNetVIT(device=cuda_device).eval()
    other = LSTMNetVIT(generator=torch.Generator().manual_seed(7), device="cpu").state_dict()
    img = torch.rand(256, 1, 60, 90, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(1))
    desvel = torch.full((256, 1), 4.0, device=cuda_device)
    zeros = tuple(t.to(cuda_device) for t in _zeros())
    with torch.inference_mode():
        before = model(img, desvel)[0]
    model.load_params(other)
    with torch.inference_mode():
        got = model(img, desvel)
        vel, (h, c) = model(img, desvel, None, zeros)
    _within(got, (vel, h, c))
    assert (got[0] - before).abs().max().item() > 1e-3
    assert len(model._serving.slots) == 1 and sum(model.serve_stats.captures.values()) == 2


@pytest.mark.gpu
def test_the_streaming_graph_leaves_the_serving_graph_off_on_gpu(cuda_device):
    """A one-stream pipeline over the joint model (its head called with the
    carried state, inside the step's capture and its warm-up): the head's
    serving counters stay empty."""
    model = OrigUNet_w_VITFLY_ViTLSTM(
        device=cuda_device, num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
        input_shape=[1, 1, 260, 346], velpred=0, form_BEV=2, evs_min_cutoff=0.0,
        skip_type="interp").eval()
    pipe = StreamingPipeline(model, device=cuda_device)
    rng = np.random.default_rng(3)
    for n in (3000, 700, 3000):
        pipe.step_events(rng.uniform(0, 346, n).astype(np.float32),
                         rng.uniform(0, 260, n).astype(np.float32),
                         rng.choice([-1, 1], n).astype(np.int32))
    assert sum(pipe.stats.captures.values()) == 2
    stats = model.vitfly_vitlstm.serve_stats
    assert not stats.steps and not stats.captures
