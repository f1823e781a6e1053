"""The port's D(theta) and joint model against the JAX package.

``models.origunet.OrigUNet`` (velpred 0) and
``models.composites.OrigUNet_w_VITFLY_ViTLSTM`` with the configuration of the
trained joint model (tools/train_policy.py:238-241) go through the JAX
package and the port on the CPU with the same params and numpy inputs, over
several frames with the hidden state carried.  The JAX side runs as two jit
programs, D(theta) and then V(phi) on ``clip(depth * 2, 0, 1)``, which is the
composite's own ``apply`` split at the hand-off.

Tolerances, as in tests/test_torch_vitfly.py: velocity, depth and every h
within 1e-4 (f32 sums in another order through a 10-conv UNet, two
transformer blocks and two recurrences); the LSTM cell state c within
1e-4 x max(1, max|c|), the bound chip_smoke.py holds it to: c is unbounded
and, with the JAX initializer's unconverged spectral-norm vectors, the
ViTLSTM's gates saturate so that max|c| grows by about 1 per frame.
"""

import pathlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

from evfly_tpu.models import origunet as jorigunet
from evfly_tpu.models.common import sub
from evfly_tpu.models.composites import OrigUNet_w_VITFLY_ViTLSTM as JaxJoint
from evfly_tpu.models.port import load_state_dict as jax_load_state_dict
from evfly_tpu.models.port import to_params
from evfly_tpu.models.recurrent import convlstm_apply as jax_convlstm_apply
from evfly_tpu.ops import imageops as jimageops
from evfly_tpu_torch.models import origunet
from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.port import from_jax_params, load_state_dict
from evfly_tpu_torch.models.recurrent import convlstm_apply
from evfly_tpu_torch.ops import imageops

ATOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parent.parent
CHECKPOINT = REPO / "artifacts" / "policy_best.pth"

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


def _config(hw):
    """The trained joint model's configuration (tools/train_policy.py:238-241)."""
    return dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
                input_shape=[1, 1, *hw], velpred=0, form_BEV=2, evs_min_cutoff=0.0,
                skip_type="interp")


def _jax_joint(hw):
    """(JAX joint model, step(params, frame, desvel, h_unet_pair, h_vit))."""
    jm = JaxJoint(enc_params=ENC, fc_params=FC, **_config(hw))
    unet = jax.jit(lambda p, x, h: jm.origunet.apply(p, [x, None, h])[1])
    vit = jax.jit(lambda p, depth, d, h: jm.vitfly_vitlstm.apply(
        p, [jnp.clip(depth * 2.0, 0.0, 1.0), d, None, h])[:2])

    def step(params, x, desvel, h_unet, h_vit):
        depth, _, h_unet = unet(sub(params, "origunet"), x, h_unet)
        vel, h_vit = vit(sub(params, "vitfly_vitlstm"), depth, desvel, h_vit)
        return vel, depth, (h_unet, h_vit)

    return jm, step


def _frames(seed, n, hw):
    """Sparse signed event frames, as the deployment loop sees them."""
    rng = np.random.default_rng(seed)
    return [
        ((rng.integers(-3, 4, (1, 1, *hw)) * (rng.random((1, 1, *hw)) < 0.08)) * 0.2
         ).astype(np.float32)
        for _ in range(n)
    ]


def _assert_hidden_close(h_port, h_jax):
    """((h_unet, None), (h, c)) of the port against the JAX state."""
    (unet_t, _), (h_t, c_t) = h_port
    (unet_j, _), (h_j, c_j) = h_jax
    for (ht, ct), (hj, cj) in zip(unet_t, unet_j):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj),
                                   atol=ATOL * max(1.0, float(np.abs(np.asarray(cj)).max())))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j),
                               atol=ATOL * max(1.0, float(np.abs(np.asarray(c_j)).max())))


def _run_and_compare(jm, jstep, jparams, model, frames):
    h_jax = jm.init_hidden()
    h_port = model.init_hidden()
    desvel = np.full((1, 1), 4.0, np.float32)
    for frame in frames:
        vj, dj, h_jax = jstep(jparams, jnp.asarray(frame), jnp.asarray(desvel), *h_jax)
        with torch.inference_mode():
            vt, (dt, _, h_port) = model(torch.from_numpy(frame), torch.from_numpy(desvel),
                                        *h_port)
        assert vt.shape == (1, 3) and dt.shape == frame.shape
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=ATOL)
        _assert_hidden_close(h_port, h_jax)


def test_unet_sizes_equal_reference_constants():
    """learner_models.py:558-580, as origunet.py:38-42 lists them."""
    skips, middle, decoded = origunet._unet_sizes(260, 346)
    assert [big for big, _ in skips] == [(25, 35), (58, 79), (124, 167), (256, 342)]
    assert [small for _, small in skips] == [(16, 26), (24, 44), (40, 80), (72, 152)]
    assert middle == (8, 13) and decoded == (68, 148)
    for hw in [(260, 346), (196, 196), (64, 86)]:
        assert origunet._unet_sizes(*hw) == jorigunet._unet_sizes(*hw)


def test_conv_transpose2d_and_max_pool2d_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 7, 9)).astype(np.float32)
    w = rng.normal(size=(6, 4, 2, 2)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    ref = np.asarray(jimageops.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                                stride=2))
    got = imageops.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b), stride=2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    ref = np.asarray(jimageops.max_pool2d(jnp.asarray(x), 2, 2))
    np.testing.assert_array_equal(imageops.max_pool2d(torch.from_numpy(x), 2, 2).numpy(), ref)


def test_convlstm_matches_jax_with_carried_state():
    """Gate order (i, f, o, g), 1x1 kernels, no bias, two layers."""
    rng = np.random.default_rng(1)
    B, T, C, H, W, dims = 2, 3, 5, 4, 6, [8, 8]
    params = {
        f"cell_list.{i}.conv.weight": (rng.normal(size=(4 * d, cin + d, 1, 1)) * 0.3
                                       ).astype(np.float32)
        for i, (cin, d) in enumerate(zip([C, 8], dims))
    }
    x = rng.normal(size=(B, T, C, H, W)).astype(np.float32)
    hidden = [tuple((rng.normal(size=(B, d, H, W)) * 0.5).astype(np.float32) for _ in "hc")
              for d in dims]
    ref, ref_states = jax_convlstm_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        [tuple(map(jnp.asarray, s)) for s in hidden], dims, (1, 1))
    got, states = convlstm_apply(
        {k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x),
        [tuple(map(torch.from_numpy, s)) for s in hidden], dims, (1, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    for (h, c), (rh, rc) in zip(states, ref_states):
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-5)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-5)


def test_joint_with_jax_initialised_params_matches_jax():
    """196x196 (the size tests/test_stream.py:76 uses), 3 frames carried."""
    hw = (196, 196)
    jm, jstep = _jax_joint(hw)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = OrigUNet_w_VITFLY_ViTLSTM(device="cpu", **_config(hw)).eval()
    model.load_params(from_jax_params({k: np.asarray(v) for k, v in jparams.items()}, "cpu"))
    _run_and_compare(jm, jstep, jparams, model, _frames(0, 3, hw))


def test_policy_best_matches_jax_at_sensor_size():
    """The trained joint weights at 260x346, 2 frames carried."""
    hw = (260, 346)
    jm, jstep = _jax_joint(hw)
    jparams = to_params(jax_load_state_dict(str(CHECKPOINT)))
    model = OrigUNet_w_VITFLY_ViTLSTM(device="cpu", **_config(hw)).eval()
    model.load_params(load_state_dict(str(CHECKPOINT)))
    assert set(model.state_dict()) == set(jparams)
    _run_and_compare(jm, jstep, jparams, model, _frames(1, 2, hw))


def test_stream_axis_is_independent_sequences():
    """(G, N, 1, H, W) through the joint model == G separate sequences
    (batch sizes differ, so convolutions sum in another order)."""
    hw = (196, 196)
    model = OrigUNet_w_VITFLY_ViTLSTM(device="cpu", **_config(hw)).eval()
    frames = np.concatenate(_frames(2, 6, hw)).reshape(3, 2, 1, *hw)
    desvel = np.full((3, 2, 1), 4.0, np.float32)
    with torch.inference_mode():
        vel, (depth, _, ((h_unet, _), (h, c))) = model(
            torch.from_numpy(frames), torch.from_numpy(desvel), *model.init_hidden(streams=3))
        for g in range(3):
            v1, (d1, _, ((hu1, _), (h1, c1))) = model(
                torch.from_numpy(frames[g]), torch.from_numpy(desvel[g]))
            torch.testing.assert_close(vel[g], v1, atol=ATOL, rtol=0)
            torch.testing.assert_close(depth[g], d1, atol=ATOL, rtol=0)
            torch.testing.assert_close(h[g], h1, atol=ATOL, rtol=0)
            torch.testing.assert_close(h_unet[0][0][g], hu1[0][0][0], atol=ATOL, rtol=0)
