"""The port's streaming pipelines (evfly_tpu_torch.stream) against the JAX package.

``StreamingPipeline`` and ``BatchedStreamingPipeline`` of both packages step
the trained joint model (``artifacts/policy_best.pth``, the configuration of
tools/train_policy.py:238-241) at the sensor size 260x346 over the same
numpy windows of raw events or frames, with the state carried, in both
percentile modes.  The JAX pipelines run as the JAX package has them (one
jit program per step, the event histogram's Pallas kernel in interpret
mode); the port's take its plain versions on the CPU.

Tolerances: velocity, depth and every h within 1e-4, every c within 1e-4 x
max(1, max|c|), as in tests/test_torch_joint.py; the 97th-percentile scale
within 1e-6 (``torch.quantile`` and ``jnp.quantile`` both interpolate
linearly, in f32) and exactly equal in the bisection mode.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evfly_tpu.models import port as jport
from evfly_tpu.models.composites import OrigUNet_w_VITFLY_ViTLSTM as JaxJoint
from evfly_tpu.stream import pipeline as jpipeline
from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.port import load_state_dict
from evfly_tpu_torch.stream import BatchedStreamingPipeline, StreamingPipeline
from evfly_tpu_torch.stream import pipeline

ATOL = 1e-4
HW = (260, 346)
CHECKPOINT = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / "policy_best.pth"
ENC = {
    "num_layers": 2, "kernel_sizes": [5, 3], "kernel_strides": [2, 2],
    "out_channels": [8, 32], "activations": ["relu", "relu"],
    "pool_type": "max", "invert_pool_inputs": True,
    "pool_kernels": [2, 2], "pool_strides": [2, 2], "conv_function": "conv2d",
}
FC = {
    "num_layers": 4, "layer_sizes": [1024, 128, 16, 1],
    "activations": ["leaky_relu", "leaky_relu", "leaky_relu", "tanh"],
    "dropout_p": 0.1,
}
CONFIG = dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
              input_shape=[1, 1, *HW], velpred=0, form_BEV=2, evs_min_cutoff=0.0,
              skip_type="interp")


@pytest.fixture(scope="module")
def models():
    jm = JaxJoint(enc_params=ENC, fc_params=FC, **CONFIG)
    jparams = jport.to_params(jport.load_state_dict(str(CHECKPOINT)))
    model = OrigUNet_w_VITFLY_ViTLSTM(device="cpu", **CONFIG)
    model.load_params(load_state_dict(str(CHECKPOINT)))
    return jm, jparams, model


def _windows(seed, n, N=5000):
    rng = np.random.default_rng(seed)
    return [
        (rng.uniform(0, HW[1], N).astype(np.float32), rng.uniform(0, HW[0], N).astype(np.float32),
         rng.choice([-1, 1], N).astype(np.int32))
        for _ in range(n)
    ]


def _sparse_frames(seed, shape):
    rng = np.random.default_rng(seed)
    return ((rng.integers(-3, 4, shape) * (rng.random(shape) < 0.08)) * 0.2).astype(np.float32)


def _close_c(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def _assert_state_close(port_hidden, jax_hidden, streams=None):
    """((h_unet, None), (h, c)); the JAX batched state has (G, 1, ...) where
    the port's ConvLSTM state is (G, ...)."""
    (unet_t, _), (h_t, c_t) = port_hidden
    (unet_j, _), (h_j, c_j) = jax_hidden
    for (ht, ct), (hj, cj) in zip(unet_t, unet_j):
        hj, cj = np.asarray(hj), np.asarray(cj)
        if streams is not None:
            hj, cj = hj[:, 0], cj[:, 0]
        np.testing.assert_allclose(ht.numpy(), hj, atol=ATOL)
        _close_c(ct, cj)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
    _close_c(c_t, c_j)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "bisection"])
def test_quantile_scale_matches_jax(fast):
    frames = _sparse_frames(0, (3, 64, 86))
    frames[2] = 0.0
    frames[1, :2, :3] = np.float32(1.4)
    got = pipeline._quantile_scale(torch.from_numpy(frames), fast=fast)
    for b in range(3):
        ref = np.asarray(jpipeline._quantile_scale(jnp.asarray(frames[b]), fast=fast))
        if fast:
            np.testing.assert_array_equal(got[b].numpy(), ref)
        else:
            np.testing.assert_allclose(got[b].numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "bisection"])
def test_streaming_pipeline_matches_jax(models, fast):
    """step_events over two windows, step_frame, then reset and step again."""
    jm, jparams, model = models
    jpipe = jpipeline.StreamingPipeline(jm, jparams, desvel=4.0, fast_percentile=fast)
    pipe = StreamingPipeline(model, desvel=4.0, fast_percentile=fast, device="cpu")

    def both(step_jax, step_port):
        vj, dj = step_jax()
        vt, dt = step_port()
        assert vt.shape == (3,) and dt.shape == HW
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=ATOL)
        _assert_state_close(pipe.hidden, jpipe.hidden)
        return vt

    for ex, ey, ep in _windows(1, 2):
        both(lambda: jpipe.step_events(jnp.asarray(ex), jnp.asarray(ey), jnp.asarray(ep)),
             lambda: pipe.step_events(ex, ey, ep))
    frame = _sparse_frames(2, HW)
    both(lambda: jpipe.step_frame(jnp.asarray(frame)), lambda: pipe.step_frame(frame))
    jpipe.reset()
    pipe.reset()
    first = both(lambda: jpipe.step_frame(jnp.asarray(frame)), lambda: pipe.step_frame(frame))
    pipe.reset()
    torch.testing.assert_close(pipe.step_frame(frame)[0], first, atol=0, rtol=0)


def test_batched_pipeline_matches_jax(models):
    """G = 3 streams with their own desired speeds over 3 steps, stream 1
    reset before the third."""
    jm, jparams, model = models
    G, desvel = 3, [3.0, 4.0, 5.0]
    jpipe = jpipeline.BatchedStreamingPipeline(jm, jparams, num_streams=G, desvel=desvel,
                                               fast_percentile=True)
    pipe = BatchedStreamingPipeline(model, num_streams=G, desvel=desvel, fast_percentile=True,
                                    device="cpu")
    for step in range(3):
        frames = _sparse_frames(10 + step, (G, *HW))
        mask = np.array([False, step == 2, False])
        vj, dj = jpipe.step_frames(jnp.asarray(frames), jnp.asarray(mask))
        vt, dt = pipe.step_frames(frames, mask)
        assert vt.shape == (G, 3) and dt.shape == (G, *HW)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=ATOL)
        _assert_state_close(pipe.hidden, jpipe.hidden, streams=G)


def test_pipeline_rejects_a_model_on_another_device(models):
    _, _, model = models
    with pytest.raises(ValueError, match="not cuda"):
        StreamingPipeline(model, device="cuda")
