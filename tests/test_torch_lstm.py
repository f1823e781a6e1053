"""The port's LSTM (ops.lstm_fused, models.recurrent) against the JAX package.

The same numpy weights and sequences go through the JAX
``lstm_apply_fused(mode="stacked")`` (its Pallas kernel in interpret mode on
the CPU) and ``lstm_apply`` (lax.scan), and through the port, whose K4
wrapper takes its plain PyTorch version on CPU tensors.  atol 2e-5, and
3e-5 with a carried hidden state, are the JAX package's own bounds for the
fused kernel (tests/test_lstm_pallas.py:53,79): sums run in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evfly_tpu.models.recurrent import lstm_apply as jax_lstm_apply
from evfly_tpu.ops.lstm_pallas import lstm_apply_fused as jax_lstm_apply_fused
from evfly_tpu_torch.models import recurrent
from evfly_tpu_torch.ops import lstm_fused
from torch_helpers import cuda_device  # noqa: F401  (fixture)

ATOL, ATOL_CARRIED = 2e-5, 3e-5


def _params(rng, input_size, hidden, layers, bias=True):
    p = {}
    for l in range(layers):
        in_l = input_size if l == 0 else hidden
        p[f"weight_ih_l{l}"] = (rng.normal(size=(4 * hidden, in_l)) * 0.2).astype(np.float32)
        p[f"weight_hh_l{l}"] = (rng.normal(size=(4 * hidden, hidden)) * 0.2).astype(np.float32)
        if bias:
            p[f"bias_ih_l{l}"] = (rng.normal(size=(4 * hidden,)) * 0.1).astype(np.float32)
            p[f"bias_hh_l{l}"] = (rng.normal(size=(4 * hidden,)) * 0.1).astype(np.float32)
    return p


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _close(got, ref, atol):
    out, (h, c) = got
    rout, (rh, rc) = ref
    for a, b in ((out, rout), (h, rh), (c, rc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("bias", [True, False])
def test_plain_k4_matches_jax(layers, bias):
    rng = np.random.default_rng(layers * 10 + bias)
    T, input_size, hidden = 17, 37, 128
    p = _params(rng, input_size, hidden, layers, bias)
    x = rng.normal(size=(T, input_size)).astype(np.float32)

    got = lstm_fused.lstm_apply_fused(_torch(p), torch.from_numpy(x), None, layers, hidden)
    ref_fused = jax_lstm_apply_fused(_jax(p), jnp.asarray(x), None, layers, hidden, mode="stacked")
    ref_scan = jax_lstm_apply(_jax(p), jnp.asarray(x), None, layers, hidden)
    _close(got, ref_fused, ATOL)
    _close(got, ref_scan, ATOL)


@pytest.mark.parametrize("layers", [1, 3])
def test_plain_lstm_apply_matches_jax(layers):
    """The port's plain per-layer loop (what CPU and training take)."""
    rng = np.random.default_rng(40 + layers)
    T, input_size, hidden = 13, 21, 64
    p = _params(rng, input_size, hidden, layers)
    x = rng.normal(size=(T, input_size)).astype(np.float32)
    got = recurrent.lstm_apply(_torch(p), torch.from_numpy(x), None, layers, hidden)
    ref = jax_lstm_apply(_jax(p), jnp.asarray(x), None, layers, hidden)
    _close(got, ref, ATOL)


def test_carried_hidden_matches_jax():
    """Two T/2 segments with the state carried == one pass over T."""
    rng = np.random.default_rng(7)
    T, input_size, hidden, layers = 16, 24, 128, 3
    p = _params(rng, input_size, hidden, layers)
    x = rng.normal(size=(T, input_size)).astype(np.float32)
    tp, xt = _torch(p), torch.from_numpy(x)

    out_a, hid = lstm_fused.lstm_apply_fused(tp, xt[: T // 2], None, layers, hidden)
    out_b, hid = lstm_fused.lstm_apply_fused(tp, xt[T // 2:], hid, layers, hidden)
    ref = jax_lstm_apply(_jax(p), jnp.asarray(x), None, layers, hidden)
    _close((torch.cat([out_a, out_b]), hid), ref, ATOL_CARRIED)

    h0 = (rng.normal(size=(layers, hidden)) * 0.5).astype(np.float32)
    c0 = (rng.normal(size=(layers, hidden)) * 0.5).astype(np.float32)
    got = lstm_fused.lstm_apply_fused(
        tp, xt, (torch.from_numpy(h0), torch.from_numpy(c0)), layers, hidden)
    ref = jax_lstm_apply_fused(_jax(p), jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
                               layers, hidden, mode="stacked")
    _close(got, ref, ATOL_CARRIED)


def test_k4_wrapper_on_cpu_takes_plain_version():
    rng = np.random.default_rng(3)
    p = _torch(_params(rng, 9, 128, 2))
    before = lstm_fused.lstm_stacked.launches
    recurrent.lstm_apply(p, torch.from_numpy(rng.normal(size=(5, 9)).astype(np.float32)),
                         None, 2, 128)
    lstm_fused.lstm_apply_fused(p, torch.zeros(5, 9), None, 2, 128)
    assert lstm_fused.lstm_stacked.launches == before


def test_pack_stacked_layouts():
    rng = np.random.default_rng(5)
    p = _torch(_params(rng, 9, 128, 3))
    whh_t, wih_t, bias = lstm_fused.pack_stacked(p, 3, 128)
    assert whh_t.shape == (128, 3 * 512) and wih_t.shape == (128, 2 * 512)
    assert torch.equal(whh_t[:, 512:1024], p["weight_hh_l1"].T)
    assert torch.equal(wih_t[:, 512:], p["weight_ih_l2"].T)
    assert torch.equal(bias[:512], p["bias_ih_l1"] + p["bias_hh_l1"])


@pytest.mark.gpu
@pytest.mark.parametrize("carried", [False, True])
def test_k4_kernel_matches_plain_on_gpu(cuda_device, carried):
    rng = np.random.default_rng(11)
    T, hidden, layers = 64, 128, 3
    p = {k: v.to(cuda_device) for k, v in _torch(_params(rng, 517, hidden, layers)).items()}
    x = torch.from_numpy(rng.normal(size=(T, 517)).astype(np.float32)).to(cuda_device)
    zeros = torch.zeros(layers, hidden, device=cuda_device)
    h0 = torch.randn(layers, hidden, device=cuda_device) * 0.5 if carried else zeros
    c0 = torch.randn(layers, hidden, device=cuda_device) * 0.5 if carried else zeros
    xp0 = x @ p["weight_ih_l0"].T + p["bias_ih_l0"] + p["bias_hh_l0"]
    packed = lstm_fused.pack_stacked(p, layers, hidden)
    got = lstm_fused.lstm_stacked(xp0, *packed, h0, c0)
    ref = lstm_fused.lstm_stacked_plain(xp0, *packed, h0, c0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=ATOL_CARRIED if carried else ATOL, rtol=0)


@pytest.mark.gpu
def test_k4_rejects_hidden_not_multiple_of_128(cuda_device):
    z = torch.zeros(4, 4 * 64, device=cuda_device)
    with pytest.raises(ValueError, match="% 128"):
        lstm_fused.lstm_stacked(z, torch.zeros(64, 256, device=cuda_device),
                                torch.zeros(64, 0, device=cuda_device),
                                torch.zeros(0, device=cuda_device),
                                torch.zeros(1, 64, device=cuda_device),
                                torch.zeros(1, 64, device=cuda_device))
