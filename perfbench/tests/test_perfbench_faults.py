"""Every cell's check, driven through a whole run on the CPU at test sizes,
with the program broken underneath: each fault the cell can have must come
out as ``correct`` false, and the sound program as true.  The faults: a step
that returns its state unchanged; half of the batch left out, the mean
taken over the rest; an answer altered where it is produced.  (No cell runs
across chips, so none can leave out the exchange between them.)"""

import pytest
import torch

from perfbench.tests import cells

import evfly_tpu_torch.models.recurrent as recurrent
import evfly_tpu_torch.models.vitfly as vitfly
import evfly_tpu_torch.ops.voxelizer as voxelizer
import evfly_tpu_torch.parallel.data_parallel as data_parallel
import evfly_tpu_torch.stream.pipeline as pipeline
import evfly_tpu_torch.train.stepfn as stepfn

G1, G16, SERVE, TRAIN = ("joint.stream.g1", "joint.stream.g16", "vitlstm.serve.b256",
                         "joint.train.dp8")
CHUNK = "train.c16"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clone(nest):
    if isinstance(nest, (tuple, list)):
        return type(nest)(_clone(t) for t in nest)
    return None if nest is None else nest.clone()


def stream_state_unchanged(mp):
    orig = pipeline._step_body
    mp.setattr(pipeline, "_step_body", lambda model, hidden, *a, **k: orig(model, _clone(hidden),
                                                                           *a, **k))


def stream_answer_altered(mp):
    orig = pipeline.stream_step

    def altered(*a, **k):
        vel, depth, hidden = orig(*a, **k)
        return vel + 1e-3, depth, hidden

    mp.setattr(pipeline, "stream_step", altered)


def g16_half_batch(mp):
    orig = pipeline.BatchedStreamingPipeline.step_frames

    def half(self, frames, reset_mask=None):
        frames = frames.clone()
        frames[frames.shape[0] // 2:] = 0
        return orig(self, frames, reset_mask)

    mp.setattr(pipeline.BatchedStreamingPipeline, "step_frames", half)


def serve_state_unchanged(mp):
    orig = recurrent.LSTM.forward

    def unchanged(self, x, hidden=None, generator=None):
        out, (h, c) = orig(self, x, hidden, generator)
        return out, (torch.zeros_like(h), torch.zeros_like(c)) if hidden is None else hidden

    mp.setattr(recurrent.LSTM, "forward", unchanged)


def serve_half_batch(mp):
    orig = voxelizer.event_histogram_scaled_resized

    def half(x, y, pol, *a, **k):
        frames = orig(x, y, pol, *a, **k).clone()
        frames[frames.shape[0] // 2:] = 0
        return frames

    mp.setattr(voxelizer, "event_histogram_scaled_resized", half)


def serve_answer_altered(mp):
    orig = vitfly.LSTMNetVIT.forward

    def altered(self, *a, **k):
        vel, h = orig(self, *a, **k)
        return vel + 1e-3, h

    mp.setattr(vitfly.LSTMNetVIT, "forward", altered)


def train_state_unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def chunk_half_batch(mp):
    orig = stepfn.make_batch_slicer

    def make(B, *a):
        get_batch = orig(B, *a)
        return lambda data, idx: {k: v[: B // 2] for k, v in get_batch(data, idx).items()}

    mp.setattr(stepfn, "make_batch_slicer", make)


def chunk_answer_altered(mp):
    orig = stepfn.make_forward_loss

    def make(*a, **k):
        forward = orig(*a, **k)

        def altered(batch, generator):
            loss, *rest = forward(batch, generator)
            return (loss * (1 + 1e-3), *rest)

        return altered

    mp.setattr(stepfn, "make_forward_loss", make)


def dp_half_batch(mp):
    orig = data_parallel.make_chunk_gather

    def make(B, *a):
        gather = orig(B, *a)

        def half(data, idxs):
            batch = gather(data, idxs)
            batch["mask"] = batch["mask"].clone()
            batch["mask"][:, B // 2:] = 0
            return batch

        return half

    mp.setattr(data_parallel, "make_chunk_gather", make)


def dp_answer_altered(mp):
    orig = data_parallel.make_chunked_forward_loss

    def make(*a, **k):
        forward = orig(*a, **k)

        def altered(batch, generator):
            losses, values = forward(batch, generator)
            return losses * (1 + 1e-3), values

        return altered

    mp.setattr(data_parallel, "make_chunked_forward_loss", make)


def train_window_step_unchanged(mp):
    """Adam steps the first steps and none of the window's."""
    orig, calls = torch.optim.Adam.step, []

    def step(self, closure=None):
        calls.append(1)
        return orig(self, closure) if len(calls) <= 3 else None

    mp.setattr(torch.optim.Adam, "step", step)


FAULTS = {
    (G1, "state_unchanged"): stream_state_unchanged,
    (G1, "answer_altered"): stream_answer_altered,
    (G16, "state_unchanged"): stream_state_unchanged,
    (G16, "half_batch"): g16_half_batch,
    (G16, "answer_altered"): stream_answer_altered,
    (SERVE, "state_unchanged"): serve_state_unchanged,
    (SERVE, "half_batch"): serve_half_batch,
    (SERVE, "answer_altered"): serve_answer_altered,
    (TRAIN, "state_unchanged"): train_state_unchanged,
    (TRAIN, "half_batch"): dp_half_batch,
    (TRAIN, "answer_altered"): dp_answer_altered,
    (TRAIN, "window_state_unchanged"): train_window_step_unchanged,
    (CHUNK, "state_unchanged"): train_state_unchanged,
    (CHUNK, "half_batch"): chunk_half_batch,
    (CHUNK, "answer_altered"): chunk_answer_altered,
}


@pytest.mark.parametrize("workload,traffic", [(G1, None), (G16, None), (SERVE, None),
                                              (TRAIN, None),
                                              *((w, t) for t, (w, _) in cells.OTHER.items())])
def test_the_sound_program_is_correct(workload, traffic):
    result = cells.run(cells.cpu_cell(workload, traffic=traffic))
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_a_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[workload, fault](monkeypatch)
    if workload in cells.OTHER:
        cell = cells.cpu_cell(cells.OTHER[workload][0], traffic=workload)
    else:
        cell = cells.cpu_cell(workload)
    result = cells.run(cell)
    assert not result["correct"], result["checks"]
