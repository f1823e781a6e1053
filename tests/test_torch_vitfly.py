"""The port's V(phi) (models.vitfly.LSTMNetVIT) against the JAX package.

The same params (random from the JAX initializer, and the trained
``artifacts/pretrain_v_final.pth``) and the same numpy inputs go through the
JAX ``LSTMNetVIT.apply`` and the port's module on the CPU.  Velocity and the
LSTM state agree to atol 1e-4: both sides run f32 with the JAX package at
HIGHEST precision, and the differences are the order of f32 sums through
two transformer blocks and a 3-layer LSTM (measured ~1e-6 in velocity and
~2e-5 in (h, c) at these sizes).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evfly_tpu.models.port import load_state_dict as jax_load_state_dict
from evfly_tpu.models.port import to_params
from evfly_tpu.models.vitfly import LSTMNetVIT as JaxLSTMNetVIT
from evfly_tpu.ops.voxelizer import event_histogram_scaled_resized as jax_voxelize
from evfly_tpu_torch.models.common import param_count
from evfly_tpu_torch.models.port import from_jax_params, load_state_dict
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.ops.voxelizer import event_histogram_scaled_resized

ATOL = 1e-4
CHECKPOINT = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / "pretrain_v_final.pth"


@pytest.fixture(scope="module")
def jax_model():
    return JaxLSTMNetVIT(), jax.jit(JaxLSTMNetVIT().apply)


def _inputs(seed, n=4):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (n, 1, 60, 90)).astype(np.float32)
    desvel = rng.uniform(2, 6, (n, 1)).astype(np.float32)
    return img, desvel


def _port_model(params):
    return LSTMNetVIT(device="cpu").eval().load_params(params)


def _compare(jax_apply, jparams, model, img, desvel, hidden=None):
    jh = None if hidden is None else tuple(jnp.asarray(h) for h in hidden)
    vj, (hj, cj), _ = jax_apply(jparams, [jnp.asarray(img), jnp.asarray(desvel), None, jh])
    th = None if hidden is None else tuple(torch.tensor(np.asarray(h)) for h in hidden)
    with torch.no_grad():
        vt, (ht, ct) = model(torch.from_numpy(img), torch.from_numpy(desvel), None, th)
    assert vt.shape == (img.shape[0], 3) and ht.shape == (3, 128)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=ATOL)
    return np.asarray(hj), np.asarray(cj)


def test_param_count_and_keys(jax_model):
    model = LSTMNetVIT(device="cpu")
    sd = model.state_dict()
    assert param_count(sd) == 3_563_663
    jparams = jax_model[0].init(jax.random.PRNGKey(0))
    assert set(sd) == set(jparams)
    assert all(tuple(sd[k].shape) == tuple(jparams[k].shape) for k in sd)
    assert set(sd) == set(load_state_dict(str(CHECKPOINT)))


def test_random_params_match_jax(jax_model):
    jm, japply = jax_model
    jparams = jm.init(jax.random.PRNGKey(0))
    model = _port_model(from_jax_params({k: np.asarray(v) for k, v in jparams.items()}, "cpu"))
    img, desvel = _inputs(0)
    _compare(japply, jparams, model, img, desvel)


def test_checkpoint_matches_jax_with_carried_state(jax_model):
    _, japply = jax_model
    jparams = to_params(jax_load_state_dict(str(CHECKPOINT)))
    model = _port_model(load_state_dict(str(CHECKPOINT)))
    img, desvel = _inputs(1)
    hidden = _compare(japply, jparams, model, img[:2], desvel[:2])
    _compare(japply, jparams, model, img[2:], desvel[2:], hidden)


def test_refine_inputs_resizes_to_model_size(jax_model):
    """A sensor-size image goes through refine_inputs' bilinear resize."""
    _, japply = jax_model
    jparams = to_params(jax_load_state_dict(str(CHECKPOINT)))
    model = _port_model(load_state_dict(str(CHECKPOINT)))
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (3, 1, 130, 173)).astype(np.float32)
    _compare(japply, jparams, model, img, np.full((3, 1), 4.0, np.float32))


def test_slice_events_to_velocity_matches_jax(jax_model):
    """The whole slice: raw events at the sensor size -> K3's plain version
    -> LSTMNetVIT, against the JAX kernel (interpret mode) -> JAX model."""
    _, japply = jax_model
    H, W, B, N = 260, 346, 4, 2000
    rng = np.random.default_rng(3)
    x = rng.uniform(0, W, (B, N)).astype(np.float32)
    y = rng.uniform(0, H, (B, N)).astype(np.float32)
    p = rng.choice([-1, 1], (B, N)).astype(np.int32)
    desvel = np.full((B, 1), 4.0, np.float32)

    small_j = np.stack([
        np.asarray(jax_voxelize(jnp.asarray(x[b]), jnp.asarray(y[b]), jnp.asarray(p[b]),
                                H, W, 60, 90))
        for b in range(B)
    ])[:, None]
    jparams = to_params(jax_load_state_dict(str(CHECKPOINT)))
    vj, _, _ = japply(jparams, [jnp.asarray(small_j), jnp.asarray(desvel), None, None])

    model = _port_model(load_state_dict(str(CHECKPOINT)))
    small_t = event_histogram_scaled_resized(x, y, p, H, W, 60, 90, device="cpu")
    with torch.no_grad():
        vt, _ = model(small_t[:, None], torch.from_numpy(desvel))
    np.testing.assert_allclose(small_t.numpy(), small_j[:, 0], atol=3e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
