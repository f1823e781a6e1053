"""The port's velocity-head pieces against the JAX package, on the CPU: the
masked ``batch_norm2d`` and ``avg_pool2d`` of ``ops.imageops``, the
``BatchNorm2d`` leaf, ``DynamicConvNet``, ``DynamicFCNet`` and
``VelPredictor`` of ``models.layers``, and ``OrigUNet`` at velpred 1, 11
and 2 (with and without the head's LSTM, deploying or not) at 190x190, the
smallest frame the UNet takes.  Each goes through both packages with one
set of params (a JAX init) on the same numpy-seeded inputs.

On the card (``gpu``, run there by tests/run_gpu_tests.py): the head's
LSTM at the shape configuration B gives it, hidden 768 and one layer, on
the L2 route of K4 and K5 (the cluster route holds H = 128 and 256 only)
against the plain loop, within 3e-5 with a carried state
(tests/test_lstm_pallas.py's bounds).

Tolerances: BatchNorm statistics and running stats within rtol 1e-5,
atol 1e-6, its outputs 1e-5 (tests/test_masked_bn.py); pooling 1e-6 (the
same sums); the head modules and OrigUNet within 1e-4
(tests/test_model_parity.py:26), the head LSTM's c within
1e-4 x max(1, max|c|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evfly_tpu.models import layers as jlayers
from evfly_tpu.models.origunet import OrigUNet as JaxOrigUNet
from evfly_tpu.ops import imageops as jimageops
from evfly_tpu_torch.models import layers
from evfly_tpu_torch.models.common import BatchNorm2d, is_trainable_key
from evfly_tpu_torch.models.origunet import OrigUNet
from evfly_tpu_torch.models.port import from_jax_params
from evfly_tpu_torch.models.recurrent import LSTM, lstm_loop
from evfly_tpu_torch.ops import imageops, lstm_fused
from torch_helpers import cuda_device  # noqa: F401 (fixture)
from torch_train_cases import HEAD_ENC, HEAD_FC, UNET, UNET_HW, few_torch_threads  # noqa: F401

ATOL = 1e-4


def _params(jmodule, seed=0):
    return {k: np.asarray(v) for k, v in jmodule.init(jax.random.PRNGKey(seed)).items()}


def _bn_inputs(seed, B=8, C=3, H=6, W=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, C, H, W)).astype(np.float32)
    weight, bias, rm = (rng.standard_normal(C).astype(np.float32) for _ in range(3))
    rv = rng.random(C).astype(np.float32) + 0.5
    return x, weight, bias, rm, rv


# ------------------------------------------------------------ imageops

@pytest.mark.parametrize("mode", ["train_masked", "train", "eval"])
def test_batch_norm2d_matches_jax(mode):
    x, weight, bias, rm, rv = _bn_inputs(1)
    mask = (np.arange(8) < 5).astype(np.float32) if mode == "train_masked" else None
    training = mode != "eval"
    ref = jimageops.batch_norm2d(jnp.asarray(x), weight, bias, rm, rv, training=training,
                                 mask=None if mask is None else jnp.asarray(mask))
    got = imageops.batch_norm2d(*(torch.from_numpy(a) for a in (x, weight, bias, rm, rv)),
                                training=training,
                                mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_batch_norm2d_masked_stats_equal_unpadded():
    """tests/test_masked_bn.py's invariant on the port: a padded batch with
    its mask gives the valid frames' outputs and running stats."""
    x, weight, bias, rm, rv = (torch.from_numpy(a) for a in _bn_inputs(2))
    n_valid = 5
    padded = torch.cat([x[:n_valid], torch.zeros_like(x[n_valid:])])
    mask = (torch.arange(8) < n_valid).float()
    out_u, m_u, v_u = imageops.batch_norm2d(x[:n_valid], weight, bias, rm, rv, training=True)
    out_p, m_p, v_p = imageops.batch_norm2d(padded, weight, bias, rm, rv, training=True,
                                            mask=mask)
    torch.testing.assert_close(m_p, m_u, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v_p, v_u, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out_p[:n_valid], out_u, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,stride", [(2, None), (3, 2), (2, 1)])
def test_avg_pool2d_matches_jax(kernel, stride):
    x = np.random.default_rng(3).standard_normal((2, 3, 9, 11)).astype(np.float32)
    ref = jimageops.avg_pool2d(jnp.asarray(x), kernel, stride)
    got = imageops.avg_pool2d(torch.from_numpy(x), kernel, stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_batchnorm_leaf_keeps_its_stats_in_buffers():
    """Running stats and the int64 counter are buffers, outside
    ``parameters()``; a training forward writes the JAX package's updates
    into them, an eval forward leaves them."""
    bn = BatchNorm2d(3, "cpu")
    assert [k for k, _ in bn.named_parameters()] == ["weight", "bias"]
    assert {k for k, _ in bn.named_buffers()} == {"running_mean", "running_var",
                                                  "num_batches_tracked"}
    assert bn.num_batches_tracked.dtype == torch.int64
    assert all(is_trainable_key(k) == (k in ("weight", "bias")) for k in bn.state_dict())
    x, *_ = _bn_inputs(4)
    mask = (np.arange(8) < 6).astype(np.float32)
    _, m, v = jimageops.batch_norm2d(jnp.asarray(x), np.ones(3, np.float32),
                                     np.zeros(3, np.float32), np.zeros(3, np.float32),
                                     np.ones(3, np.float32), training=True,
                                     mask=jnp.asarray(mask))
    bn.train()
    out = bn(torch.from_numpy(x), torch.from_numpy(mask))
    assert out.requires_grad and not bn.running_mean.requires_grad
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(m), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(v), rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    bn.eval()
    before = {k: t.clone() for k, t in bn.state_dict().items()}
    bn(torch.from_numpy(x))
    assert all(torch.equal(t, before[k]) for k, t in bn.state_dict().items())


# ------------------------------------------------------------ layers

CONV_CASES = {
    "conv2d-max": dict(conv_function="conv2d", pool_type="max"),
    "conv2d-avg": dict(conv_function="conv2d", pool_type="avg"),
    "conv2d-none": dict(conv_function="conv2d", pool_type="none"),
    "upconv2d": dict(conv_function="upconv2d", pool_type="none"),
}


def _convnets(case, in_channels=2):
    kw = dict(in_channels=in_channels, num_layers=2, kernel_sizes=[3, 2], kernel_strides=[2, 1],
              out_channels=[4, 6], activations=["relu", "leaky_relu"], pool_kernels=[2, 2],
              pool_strides=[2, 1], invert_pool_input=True, **CONV_CASES[case])
    jnet = jlayers.DynamicConvNet(**kw)
    params = _params(jnet)
    net = layers.DynamicConvNet(**kw, device="cpu")
    net.load_state_dict(from_jax_params(params, "cpu"))
    return jnet, params, net


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_dynamic_convnet_matches_jax(case):
    """Eval with the stored running stats, then training with a frame mask:
    the output, the shape arithmetic and the running stats after."""
    jnet, params, net = _convnets(case)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: v.shape for k, v in params.items()}
    x = np.random.default_rng(5).standard_normal((4, 2, 13, 17)).astype(np.float32)
    mask = np.array([1, 1, 1, 0], np.float32)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for train in (False, True):
        ref, updates = jnet.apply(jparams, jnp.asarray(x), train=train,
                                  frame_mask=jnp.asarray(mask) if train else None)
        net.train(train)
        got = net(torch.from_numpy(x), torch.from_numpy(mask) if train else None)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL)
        assert tuple(got.shape[1:]) == net.output_shape((13, 17)) == jnet.output_shape((13, 17))
    state = net.state_dict()
    assert set(updates) == {k for k in state if not is_trainable_key(k)}
    for k, v in updates.items():
        if k.endswith("num_batches_tracked"):
            assert int(state[k]) == int(v) == 1
        else:
            np.testing.assert_allclose(state[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6)


def test_dynamic_convnet_inverts_once_and_never_undoes():
    """The reference's duplicate ``invert_{i}`` name: one sign flip per
    layer before its pool, never undone, so with an identity conv, the
    initial BatchNorm and no activation, a 2x2 max pool returns minus each
    window's minimum."""
    net = layers.DynamicConvNet(1, 1, [1], [1], [1], ["none"], invert_pool_input=True,
                                device="cpu").eval()
    with torch.no_grad():
        net.layers.conv2d_0.weight.fill_(1.0)
        out = net(torch.arange(16.0).reshape(1, 1, 4, 4))
    bn_scale = 1.0 / (1.0 + 1e-5) ** 0.5
    torch.testing.assert_close(out[0, 0], -torch.tensor([[0.0, 2.0], [8.0, 10.0]]) * bn_scale)


def test_fcnet_matches_jax_and_drops_out_only_with_a_generator():
    kw = dict(input_features=12, num_layers=3, layer_sizes=[8, 5, 2],
              activations=["leaky_relu", "sigmoid", "tanh"], dropout_p=0.25)
    jnet = jlayers.DynamicFCNet(**kw)
    params = _params(jnet, 1)
    net = layers.DynamicFCNet(**kw, device="cpu")
    net.load_state_dict(from_jax_params(params, "cpu"))
    x = np.random.default_rng(6).standard_normal((4, 12)).astype(np.float32)
    ref = jnet.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), train=True)
    net.train()
    np.testing.assert_allclose(net(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    dropped = [net(torch.from_numpy(x), torch.Generator().manual_seed(9)) for _ in range(2)]
    torch.testing.assert_close(dropped[0], dropped[1], atol=0, rtol=0)
    assert not torch.allclose(dropped[0], torch.tensor(np.asarray(ref)), atol=ATOL)


@pytest.mark.parametrize("num_out", [1, 2, 3])
def test_velpredictor_matches_jax(num_out):
    """num_out 1 and 2 complete the leading component as
    sqrt(clip(1 - sum y^2, 0, 1)); 1 also sets z to 0."""
    fc = dict(HEAD_FC, layer_sizes=[16, 8, num_out])
    jhead = jlayers.VelPredictor(input_size=24, num_out=num_out, fc_params=fc)
    params = _params(jhead, 2)
    head = layers.VelPredictor(24, num_out, fc, device="cpu").eval()
    assert set(head.state_dict()) == set(params)
    head.load_state_dict(from_jax_params(params, "cpu"))
    x = np.random.default_rng(7).standard_normal((5, 2, 3, 4)).astype(np.float32) * 3
    ref, _ = jhead.apply({k: jnp.asarray(v) for k, v in params.items()}, [jnp.asarray(x)])
    got = head(torch.from_numpy(x))
    assert got.shape == (5, 3 if num_out < 3 else num_out)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL)
    if num_out == 1:
        assert got[:, 2].abs().max().item() == 0.0


# ------------------------------------------------------------ OrigUNet heads

# per velpred: the head's encoder for its tap at 190x190 (the interpolated
# depth 190x190, the decoder output 4x4, the bottleneck 512x4x4)
TAP_ENC = {
    1: dict(HEAD_ENC, num_layers=2, kernel_sizes=[5, 3], kernel_strides=[3, 2],
            out_channels=[4, 8], activations=["relu", "relu"], pool_kernels=[3, 2],
            pool_strides=[3, 2]),
    11: HEAD_ENC,
    2: dict(HEAD_ENC, out_channels=[8], pool_type="avg"),
}


def _origunets(velpred, lstm, is_deployment):
    kw = dict(UNET, velpred=velpred, num_recurrent=[1, lstm], enc_params=TAP_ENC[velpred],
              fc_params=HEAD_FC, is_deployment=is_deployment)
    jm = JaxOrigUNet(**kw)
    params = _params(jm, 3)
    model = OrigUNet(**kw, device="cpu").eval()
    model.load_state_dict(from_jax_params(params, "cpu"))
    return jm, params, model


@pytest.mark.parametrize("lstm", [0, 1], ids=["no_lstm", "lstm"])
@pytest.mark.parametrize("velpred", [1, 11, 2])
def test_origunet_heads_match_jax(velpred, lstm):
    """Two chunks of 2 frames with the state carried, then the same model
    deploying: velpred 1 and 11 still decode, 2 does not."""
    jm, params, model = _origunets(velpred, lstm, False)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in params.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    rng = np.random.default_rng(velpred + lstm)
    xs = [np.clip(rng.standard_normal((2, 1, *UNET_HW)), -1, 1).astype(np.float32)
          for _ in range(2)]
    apply = jax.jit(lambda p, x, h: jm.apply(p, [x, None, h])[:2])
    jh, th = jm.init_hidden(), model.init_hidden()
    for x in xs:
        jv, (jd, ju, jh) = apply(jparams, jnp.asarray(x), jh)
        with torch.no_grad():
            tv, (td, tu, th) = model(torch.from_numpy(x), th)
        for got, ref in ((tv, jv), (td, jd), (tu, ju)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        assert (th[1] is None) == (jh[1] is None) == (lstm == 0)
        if lstm:
            np.testing.assert_allclose(th[1][0].numpy(), np.asarray(jh[1][0]), atol=ATOL)
            c = np.asarray(jh[1][1])
            np.testing.assert_allclose(th[1][1].numpy(), c,
                                       atol=ATOL * max(1.0, float(np.abs(c).max())))
    deploy = OrigUNet(**dict(UNET, velpred=velpred, num_recurrent=[1, lstm],
                             enc_params=TAP_ENC[velpred], fc_params=HEAD_FC, is_deployment=True),
                      device="cpu").eval()
    deploy.load_state_dict(model.state_dict())
    with torch.no_grad():
        dv, (dd, du, _) = deploy(torch.from_numpy(xs[0]))
        ev, _ = model(torch.from_numpy(xs[0]))
    torch.testing.assert_close(dv, ev, atol=0, rtol=0)
    assert (dd is None) == (du is None) == (velpred == 2)


def test_origunet_head_stream_axis_is_independent_sequences():
    """(G, N, 1, H, W) through velpred 11 with the head's LSTM == G
    separate sequences, h_velpred (G, L, F)."""
    _, _, model = _origunets(11, 1, False)
    x = np.clip(np.random.default_rng(8).standard_normal((3, 2, 1, *UNET_HW)), -1, 1
                ).astype(np.float32)
    with torch.no_grad():
        hidden = model.init_hidden(streams=3)
        assert hidden[1][0].shape == (3, 1, model.velpred_lstm_size)
        vel, (_, _, (_, (h, c))) = model(torch.from_numpy(x), hidden)
        for g in range(3):
            v1, (_, _, (_, (h1, c1))) = model(torch.from_numpy(x[g]))
            torch.testing.assert_close(vel[g], v1, atol=ATOL, rtol=0)
            torch.testing.assert_close(h[g], h1, atol=ATOL, rtol=0)
            torch.testing.assert_close(c[g], c1, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["stacked", "wavefront"])
@pytest.mark.parametrize("G,T", [(1, 16), (1, 1), (16, 1)])
def test_head_lstm_takes_the_l2_route_at_hidden_768(cuda_device, mode, G, T):
    """One launch of K4 (stacked) or K5 (wavefront) on the route of H = 768,
    L = 1, the grid route since it was added (the L2 route before), with the
    empty layer-1 weights of L = 1, against ``lstm_loop`` on the card."""
    H = 768
    assert lstm_fused.choose_route(H, 1) == "grid"
    lstm = LSTM(H, H, 1, torch.Generator().manual_seed(4), cuda_device, dropout=0.1).eval()
    lstm.mode = mode
    gen = torch.Generator().manual_seed(5)
    x, h0, c0 = (torch.randn(G, *shape, generator=gen).to(cuda_device) * scale
                 for shape, scale in (((T, H), 1.0), ((1, H), 0.5), ((1, H), 0.5)))
    kernel = (lstm_fused.lstm_stacked_grid if mode == "stacked"
              else lstm_fused.lstm_wavefront_grid)
    before = kernel.launches
    with torch.no_grad():
        got = lstm(x, (h0, c0))
        ref = lstm_loop(dict(lstm.named_parameters()), x, (h0, c0), 1, H)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert lstm.packed().wih_t.shape == (H, 0) and lstm.packed().bias.shape == (0,)
    for a, b in ((got[0], ref[0]), (got[1][0], ref[1][0]), (got[1][1], ref[1][1])):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
