"""The port's repaired faults, on the CPU, against the JAX package where it
has a counterpart.

- Precision: ``evfly_tpu_torch.set_precision`` defaults to "highest" (the
  JAX package's ``Precision.HIGHEST``), and every entry point runs under it
  and leaves PyTorch's global TF32 flags as the caller set them.
- Autograd: ``lstm_apply`` takes the fused kernel only when no gradient is
  needed (``fused_wanted``); an eval-mode forward under autograd runs the
  plain loop, whose gradient equals JAX's.
- Dropout: inter-layer dropout applies only in training with an explicit
  ``torch.Generator``, as JAX drops out only when an ``rng`` is passed.

The card-only halves (PyTorch's default flags on the H100, the forward
under autograd on CUDA) are phases of ``chip_smoke.py``.  Tolerances: 2e-5
for the LSTM (the JAX package's own bound for it, tests/test_lstm_pallas.py),
1e-4 for LSTMNetVIT (tests/test_torch_vitfly.py) and for gradients, which
sum the same f32 products in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import evfly_tpu_torch
from evfly_tpu.models.recurrent import lstm_apply as jax_lstm_apply
from evfly_tpu.models.vitfly import LSTMNetVIT as JaxLSTMNetVIT
from evfly_tpu_torch import precision
from evfly_tpu_torch.models import recurrent
from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.port import from_jax_params
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.ops import imageops, voxelizer
from evfly_tpu_torch.stream import BatchedStreamingPipeline, StreamingPipeline

LSTM_ATOL, MODEL_ATOL = 2e-5, 1e-4


def _lstm_params(rng, input_size, hidden, layers):
    p = {}
    for l in range(layers):
        in_l = input_size if l == 0 else hidden
        p[f"weight_ih_l{l}"] = (rng.normal(size=(4 * hidden, in_l)) * 0.2).astype(np.float32)
        p[f"weight_hh_l{l}"] = (rng.normal(size=(4 * hidden, hidden)) * 0.2).astype(np.float32)
        p[f"bias_ih_l{l}"] = (rng.normal(size=(4 * hidden,)) * 0.1).astype(np.float32)
        p[f"bias_hh_l{l}"] = (rng.normal(size=(4 * hidden,)) * 0.1).astype(np.float32)
    return p


@pytest.fixture
def restore_flags():
    """PyTorch's global TF32 flags and the port's precision, as they were."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, precision.get_precision())
    yield
    cudnn.allow_tf32, matmul.allow_tf32 = saved[:2]
    precision.set_precision(saved[2])


# ------------------------------------------------------------------ precision


def test_set_precision_defaults_to_highest_and_rejects_others(restore_flags):
    assert evfly_tpu_torch.get_precision() == "highest"
    evfly_tpu_torch.set_precision("tf32")
    assert evfly_tpu_torch.get_precision() == "tf32"
    evfly_tpu_torch.set_precision("highest")
    with pytest.raises(ValueError, match="precision"):
        evfly_tpu_torch.set_precision("bf16")


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _lstmnetvit_call():
    model = LSTMNetVIT(device="cpu").eval()
    return lambda: model(torch.zeros(2, 1, 60, 90), torch.full((2, 1), 4.0))


def _joint_calls():
    hw = (196, 196)
    model = OrigUNet_w_VITFLY_ViTLSTM(input_shape=(1, 1, *hw), form_BEV=2, device="cpu")
    model.eval()
    frame = torch.zeros(hw)
    frame[10:20, 30:40] = 0.4
    pipe = StreamingPipeline(model, input_hw=hw, device="cpu")
    batched = BatchedStreamingPipeline(model, 2, input_hw=hw, device="cpu")
    ex, ey, ep = np.array([3.5, 40.2]), np.array([7.0, 50.5]), np.array([1, -1])
    return {
        "joint forward": lambda: model(frame[None, None], torch.full((1, 1), 4.0)),
        "step_frame": lambda: pipe.step_frame(frame),
        "step_events": lambda: pipe.step_events(ex, ey, ep),
        "step_frames": lambda: batched.step_frames(torch.stack([frame, frame])),
    }


def _entry_point(name):
    if name == "LSTMNetVIT":
        return _lstmnetvit_call()
    if name == "event_histogram_scaled_resized":
        x, y, p = (np.array([[3.5, 40.2]]), np.array([[7.0, 50.5]]), np.array([[1, -1]]))
        return lambda: voxelizer.event_histogram_scaled_resized(x, y, p, 64, 64, 20, 20,
                                                                device="cpu")
    return _joint_calls()[name]


ENTRY_POINTS = ["LSTMNetVIT", "joint forward", "step_frame", "step_events", "step_frames",
                "event_histogram_scaled_resized"]


@pytest.mark.parametrize("chosen,inside", [("highest", (False, False)), ("tf32", (True, True))])
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_apply_precision_and_restore_flags(entry, chosen, inside, monkeypatch,
                                                        restore_flags):
    """The flags inside an entry point's work follow ``set_precision``; the
    caller's flags (here the opposite of what the entry point sets) are
    back after it returns."""
    seen = []
    conv2d, routed = imageops.conv2d, voxelizer.hist_scaled_resized_routed

    def spy_conv2d(*args, **kwargs):
        seen.append(_flags())
        return conv2d(*args, **kwargs)

    def spy_routed(*args, **kwargs):
        seen.append(_flags())
        return routed(*args, **kwargs)

    monkeypatch.setattr(imageops, "conv2d", spy_conv2d)
    monkeypatch.setattr(voxelizer, "hist_scaled_resized_routed", spy_routed)
    call = _entry_point(entry)
    evfly_tpu_torch.set_precision(chosen)
    caller = (not inside[0], not inside[1])
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = caller
    call()
    assert seen and all(flags == inside for flags in seen)
    assert _flags() == caller


def test_precision_scope_restores_flags_after_an_exception(restore_flags):
    torch.backends.cudnn.allow_tf32 = True
    with pytest.raises(KeyError):
        with precision.precision_scope():
            assert _flags() == (False, False)
            raise KeyError("inside")
    assert torch.backends.cudnn.allow_tf32 is True


def test_precision_scope_forces_a_given_precision(restore_flags, monkeypatch):
    """A precision named to the scope (``interpolate_bilinear_mm``'s
    "highest") holds whatever ``set_precision`` chose, and the flags come
    back as they were."""
    evfly_tpu_torch.set_precision("tf32")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    seen = []
    matmul = torch.matmul

    def spy(*args):
        seen.append(_flags())
        return matmul(*args)

    with precision.precision_scope("highest"):
        assert _flags() == (False, False)
    with precision.precision_scope():
        assert _flags() == (True, True)
    with pytest.raises(ValueError):
        with precision.precision_scope("fp16"):
            pass
    monkeypatch.setattr(torch, "matmul", spy)
    imageops.interpolate_bilinear_mm(torch.ones(1, 4, 6), (8, 12))
    assert seen == [(False, False)] * 2
    assert _flags() == (True, True)


# ------------------------------------------------------------------- autograd


def test_fused_wanted_takes_the_plain_loop_when_a_gradient_is_needed():
    rng = np.random.default_rng(1)
    leaf = {k: torch.from_numpy(v).requires_grad_() for k, v in _lstm_params(rng, 9, 128, 2).items()}
    frozen = {k: v.detach() for k, v in leaf.items()}
    x = torch.zeros(3, 9)
    state = (torch.zeros(2, 128), torch.zeros(2, 128))
    assert not recurrent.fused_wanted(leaf, x, None, 128, train=False)
    with torch.no_grad():
        assert recurrent.fused_wanted(leaf, x, None, 128, train=False)
    with torch.inference_mode():
        assert recurrent.fused_wanted(leaf, x, None, 128, train=False)
    assert recurrent.fused_wanted(frozen, x, state, 128, train=False)
    assert not recurrent.fused_wanted(frozen, x.clone().requires_grad_(), None, 128, False)
    grad_state = (state[0].clone().requires_grad_(), state[1])
    assert not recurrent.fused_wanted(frozen, x, grad_state, 128, train=False)
    assert not recurrent.fused_wanted(frozen, x, None, 128, train=True)
    assert not recurrent.fused_wanted(frozen, x, None, 96, train=False)
    recurrent.set_fused_lstm(False)
    try:
        assert not recurrent.fused_wanted(frozen, x, None, 128, train=False)
    finally:
        recurrent.set_fused_lstm(True)


def test_eval_forward_under_autograd_gradient_matches_jax():
    """The gradient of sum(out) of an inference-mode (train=False) LSTM apply
    with respect to its weights and input, port against jax.grad."""
    rng = np.random.default_rng(2)
    T, input_size, hidden, layers = 7, 11, 128, 2
    p = _lstm_params(rng, input_size, hidden, layers)
    x = rng.normal(size=(T, input_size)).astype(np.float32)

    def jax_loss(params, xs):
        out, (h, c) = jax_lstm_apply(params, xs, None, layers, hidden)
        return out.sum() + c.sum()

    jgrads, jgx = jax.grad(jax_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, (h, c) = recurrent.lstm_apply(tp, tx, None, layers, hidden)
    (out.sum() + c.sum()).backward()
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrads[k]), atol=MODEL_ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=MODEL_ATOL)


# -------------------------------------------------------------------- dropout


def test_training_without_generator_has_no_dropout_like_jax_rng_none():
    rng = np.random.default_rng(3)
    T, input_size, hidden, layers = 9, 13, 64, 3
    p = _lstm_params(rng, input_size, hidden, layers)
    x = rng.normal(size=(T, input_size)).astype(np.float32)
    ref_out, (ref_h, ref_c) = jax_lstm_apply({k: jnp.asarray(v) for k, v in p.items()},
                                            jnp.asarray(x), None, layers, hidden,
                                            dropout_p=0.5, train=True, rng=None)
    out, (h, c) = recurrent.lstm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                       torch.from_numpy(x), None, layers, hidden,
                                       dropout_p=0.5, train=True)
    for a, b in ((out, ref_out), (h, ref_h), (c, ref_c)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LSTM_ATOL)


def test_dropout_with_a_seeded_generator_is_reproducible():
    rng = np.random.default_rng(4)
    T, input_size, hidden, layers = 9, 13, 64, 3
    p = {k: torch.from_numpy(v) for k, v in _lstm_params(rng, input_size, hidden, layers).items()}
    x = torch.from_numpy(rng.normal(size=(T, input_size)).astype(np.float32))

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return recurrent.lstm_apply(p, x, None, layers, hidden, dropout_p=0.5, train=True,
                                    generator=gen)

    a, b, other, none = run(7), run(7), run(8), run(None)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][1], b[1][1])
    assert not torch.equal(a[0], other[0])
    assert not torch.allclose(a[0], none[0], atol=1e-3)
    # the last layer's output is never dropped: only what feeds layers 1, 2
    assert (a[0] != 0).all()


def test_dropout_mask_keeps_one_minus_p_and_rescales():
    gen = torch.Generator().manual_seed(0)
    x = torch.full((200, 100), 2.0)
    y = imageops.dropout(x, 0.25, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.all(y[kept] == 2.0 / 0.75)


def test_lstmnetvit_training_forward_matches_jax_without_rng():
    """LSTMNetVIT in training without a generator: no dropout, the JAX
    apply with train=True and rng=None; with one, dropout from it."""
    jm = JaxLSTMNetVIT()
    jparams = jm.init(jax.random.PRNGKey(5))
    params = from_jax_params({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    model = LSTMNetVIT(device="cpu").load_params(params).train()
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (4, 1, 60, 90)).astype(np.float32)
    desvel = rng.uniform(2, 6, (4, 1)).astype(np.float32)
    vj, (hj, cj), _ = jm.apply(jparams, [jnp.asarray(img), jnp.asarray(desvel), None, None],
                               train=True, rng=None)
    with torch.no_grad():
        vt, (ht, ct) = model(torch.from_numpy(img), torch.from_numpy(desvel))
        vd, _ = model(torch.from_numpy(img), torch.from_numpy(desvel),
                      generator=torch.Generator().manual_seed(1))
        vd2, _ = model(torch.from_numpy(img), torch.from_numpy(desvel),
                       generator=torch.Generator().manual_seed(1))
    for a, b in ((vt, vj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=MODEL_ATOL)
    assert torch.equal(vd, vd2) and not torch.allclose(vd, vt, atol=1e-6)
