"""The rest of the port's model zoo (models.vitfly ``ConvNet``, ``LSTMNet``,
``ViT``, ``UNetConvLSTMNet``; models.legacy_vit ``LegacyTransformer``)
against the JAX package.

The same params (the JAX initializer's, carried across with
``port.from_jax_params``) and the same numpy inputs at 60x90 go through the
JAX ``apply`` and the port's module on the CPU: an eval forward, a
train-mode forward over a padded chunk whose frame mask reaches the
BatchNorms (the running stats and counters against JAX's ``updates``), and
an LSTM state carried from one call into the next.  Velocity and the LSTM
state agree to atol 1e-4 x max(1, max |x|), tests/test_torch_vitfly.py's
1e-4 scaled where the values pass 1 (f32 on both sides, sums in another
order through the convolutions, the transformer blocks and the LSTMs; with
the initializer's random spectral-norm vectors ViT's velocity reaches
about 650, where one f32 ulp is 6e-5); BatchNorm running stats within 1e-6 + 1e-5
relative (tests/test_masked_bn.py's bounds), counters exactly.  One train
step of ``ConvNet`` through ``train/stepfn.py`` is held against the JAX
step with tests/torch_train_cases.py's bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evfly_tpu.models import legacy_vit as jlegacy
from evfly_tpu.models import vitfly as jvitfly
from evfly_tpu_torch.models import legacy_vit, vitfly
from evfly_tpu_torch.models.common import param_count
from evfly_tpu_torch.models.port import from_jax_params
from torch_train_cases import check_train_steps, few_torch_threads  # noqa: F401
from torch_helpers import cuda_device  # noqa: F401  (fixture)

ATOL = 1e-4
# model -> its parameter count (evfly_tpu/models/vitfly.py docstrings)
ZOO = {"ConvNet": 235_269, "LSTMNet": 2_949_937, "ViT": 3_101_199,
       "UNetConvLSTMNet": 2_955_822}
WITH_LSTM = ("LSTMNet", "UNetConvLSTMNet")
WITH_BN = ("ConvNet", "LSTMNet", "UNetConvLSTMNet")


@pytest.fixture(scope="module")
def zoo():
    """name -> (JAX model, jitted eval apply, jitted train apply, params)."""
    out = {}
    for i, name in enumerate(ZOO):
        jm = getattr(jvitfly, name)()
        params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(i)).items()}
        out[name] = (jm, jax.jit(lambda p, X, jm=jm: jm.apply(p, X)),
                     jax.jit(lambda p, X, m, jm=jm: jm.apply(p, X, train=True, frame_mask=m)),
                     params)
    return out


def _inputs(seed, n=4, quat=False):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (n, 1, 60, 90)).astype(np.float32)
    desvel = rng.uniform(2, 6, (n, 1)).astype(np.float32)
    q = None
    if quat:
        q = rng.normal(size=(n, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return img, desvel, q


def _port(name, params):
    model = getattr(vitfly, name)(device="cpu")
    return model.load_params(from_jax_params(params, "cpu"))


def _run(model, img, desvel, q, hidden=None, mask=None):
    th = None if hidden is None else tuple(torch.from_numpy(np.asarray(h)) for h in hidden)
    with torch.no_grad():
        return model(torch.from_numpy(img), torch.from_numpy(desvel),
                     None if q is None else torch.from_numpy(q), th, None,
                     None if mask is None else torch.from_numpy(mask))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def _close_state(got, ref):
    if ref is None:
        assert got is None
        return
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("name", list(ZOO))
def test_param_count_and_keys(zoo, name):
    params = zoo[name][3]
    model = getattr(vitfly, name)(device="cpu")
    sd = model.state_dict()
    assert param_count(sd) == ZOO[name]
    assert set(sd) == set(params)
    assert all(tuple(sd[k].shape) == tuple(params[k].shape) for k in sd)
    assert all(sd[k].dtype == torch.int64 for k in sd if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("quat", [False, True], ids=["identity_quat", "quat"])
@pytest.mark.parametrize("name", list(ZOO))
def test_eval_forward_matches_jax(zoo, name, quat):
    _, japply, _, params = zoo[name]
    model = _port(name, params).eval()
    img, desvel, q = _inputs(1, quat=quat)
    vj, hj, _ = japply(params, [jnp.asarray(img), jnp.asarray(desvel),
                                None if q is None else jnp.asarray(q), None])
    vt, ht = _run(model, img, desvel, q)
    assert vt.shape == (4, 3)
    _close(vt, vj)
    _close_state(ht, hj)


def test_eval_forward_resizes_other_frames(zoo):
    """refine_inputs resizes a frame of another size to 60x90 first."""
    _, japply, _, params = zoo["ConvNet"]
    model = _port("ConvNet", params).eval()
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (2, 1, 52, 71)).astype(np.float32)
    desvel = np.full((2, 1), 3.0, np.float32)
    vj, _, _ = japply(params, [jnp.asarray(img), jnp.asarray(desvel), None, None])
    vt, _ = _run(model, img, desvel, None)
    _close(vt, vj)


@pytest.mark.parametrize("name", list(ZOO))
def test_train_forward_with_frame_mask_matches_jax(zoo, name):
    """Training mode over a chunk of 5 frames, 3 valid: the same velocity,
    and BatchNorm running stats moved by the valid frames alone (JAX's
    ``updates``); no dropout without a generator (JAX: without an rng)."""
    _, _, jtrain, params = zoo[name]
    model = _port(name, params).train()
    img, desvel, _ = _inputs(2, n=5)
    mask = np.array([1, 1, 1, 0, 0], np.float32)
    vj, hj, updates = jtrain(params, [jnp.asarray(img), jnp.asarray(desvel), None, None],
                             jnp.asarray(mask))
    vt, ht = _run(model, img, desvel, None, mask=mask)
    _close(vt, vj)
    _close_state(ht, hj)
    state = model.state_dict()
    assert (len(updates) > 0) == (name in WITH_BN)
    for k, v in updates.items():
        if k.endswith("num_batches_tracked"):
            assert int(state[k]) == int(v) == 1, k
        else:
            np.testing.assert_allclose(state[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("name", WITH_LSTM)
def test_hidden_state_carried(zoo, name):
    """Two chunks, the LSTM's (h, c) of the first carried into the second."""
    _, japply, _, params = zoo[name]
    model = _port(name, params).eval()
    hidden = None
    for seed in (4, 5):
        img, desvel, q = _inputs(seed, n=3, quat=True)
        jh = None if hidden is None else tuple(jnp.asarray(h) for h in hidden)
        vj, hj, _ = japply(params, [jnp.asarray(img), jnp.asarray(desvel), jnp.asarray(q), jh])
        vt, ht = _run(model, img, desvel, q, hidden)
        _close(vt, vj)
        _close_state(ht, hj)
        hidden = tuple(np.asarray(h) for h in hj)


@pytest.mark.parametrize("name", WITH_LSTM)
def test_lstm_takes_the_plain_loop(name, monkeypatch):
    """Hidden 395 and 200 are not multiples of 128: the fused kernels are
    never asked, whatever the device (recurrent.fused_wanted)."""
    from evfly_tpu_torch.models import recurrent

    model = getattr(vitfly, name)(device="cpu").eval()
    L, Hd = model.lstm.num_layers, model.lstm.hidden_size
    assert (L, Hd) == ((2, 395) if name == "LSTMNet" else (2, 200))
    params = dict(model.lstm.named_parameters())
    with torch.no_grad():
        assert not recurrent.fused_wanted(params, torch.zeros(2, 3), None, Hd, False)
    assert "bias_ih_l0" not in params


@pytest.mark.parametrize("name", list(ZOO))
def test_stream_axis(zoo, name):
    """A leading stream axis G: the same velocity as each stream alone."""
    model = _port(name, zoo[name][3]).eval()
    img, desvel, _ = _inputs(6, n=6)
    g_img = torch.from_numpy(img).reshape(2, 3, 1, 60, 90)
    g_dv = torch.from_numpy(desvel).reshape(2, 3, 1)
    with torch.no_grad():
        vel, _ = model(g_img, g_dv)
        for g in range(2):
            one, _ = model(g_img[g], g_dv[g])
            np.testing.assert_allclose(vel[g].numpy(), one.numpy(),
                                       atol=1e-5 * max(1.0, one.abs().max().item()))


# ----------------------------------------------------------- LegacyTransformer

@pytest.fixture(scope="module")
def legacy():
    jm = jlegacy.LegacyTransformer()
    rng = np.random.default_rng(8)
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(9)).items()}
    # zeros at init, as torch: perturb them so they are not compared as zeros
    params["cls_token"] = rng.normal(0, 0.02, params["cls_token"].shape).astype(np.float32)
    params["pos_embed"] = rng.normal(0, 0.02, params["pos_embed"].shape).astype(np.float32)
    return jm, params


def test_legacy_keys_and_count(legacy):
    jm, params = legacy
    sd = legacy_vit.LegacyTransformer(device="cpu").state_dict()
    assert set(sd) == set(params)
    assert all(tuple(sd[k].shape) == tuple(params[k].shape) for k in sd)
    assert param_count(sd) == sum(int(np.prod(v.shape)) for v in params.values())


def test_legacy_forward_matches_jax(legacy):
    """(3,) for batch element 0."""
    jm, params = legacy
    model = legacy_vit.LegacyTransformer(device="cpu").load_params(
        from_jax_params(params, "cpu"))
    rng = np.random.default_rng(10)
    x = rng.uniform(0, 1, (2, 1, 60, 90)).astype(np.float32)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (3,)
    _close(got, ref)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask_after_softmax"])
def test_legacy_attention_routing_and_mask(legacy, masked):
    """The attention alone on distinct value, key and query inputs: its
    first argument to the queries' projection, its third to the values',
    scaled by sqrt(embed_size), the mask (if any) after the softmax.  A
    masked entry's -1e20 carries into the output's magnitude (1e20 and
    more), which the next LayerNorm's variance overflows in f32, so the
    mask is compared here, before it."""
    jm, params = legacy
    model = legacy_vit.LegacyTransformer(device="cpu").load_params(
        from_jax_params(params, "cpu"))
    rng = np.random.default_rng(12)
    v, k, q = (rng.normal(size=(2, 151, 96)).astype(np.float32) for _ in range(3))
    mask = (rng.random((2, 1, 1, 151)) > 0.1).astype(np.float32) if masked else None
    ref = jm._attention(params, "layers.1.attention", *(jnp.asarray(a) for a in (v, k, q)),
                        None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = model.layers[1].attention(*(torch.from_numpy(a) for a in (v, k, q)),
                                        None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, 151, 96)
    _close(got, ref)


def test_legacy_only_first_element_counts(legacy):
    jm, params = legacy
    model = legacy_vit.LegacyTransformer(device="cpu").load_params(
        from_jax_params(params, "cpu"))
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (3, 1, 60, 90)).astype(np.float32)
    y = x.copy()
    y[1:] = rng.uniform(0, 1, y[1:].shape)
    with torch.no_grad():
        a = model(torch.from_numpy(x))
        b = model(torch.from_numpy(y))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", list(ZOO) + ["LegacyTransformer"])
def test_zoo_converts_with_to(name):
    """``.to(torch.float64)`` (nn.Module's own conversion) converts every
    parameter and buffer, and the f64 model's forward agrees with the f32
    one within the module's tolerance."""
    module = legacy_vit if name == "LegacyTransformer" else vitfly
    f32 = getattr(module, name)(generator=torch.Generator().manual_seed(4), device="cpu").eval()
    f64 = getattr(module, name)(device="cpu").eval()
    f64.load_state_dict(f32.state_dict())
    assert f64.to(torch.float64) is f64
    assert all(v.dtype in (torch.float64, torch.int64) for v in f64.state_dict().values())
    img, desvel, _ = _inputs(14, n=2)
    with torch.no_grad():
        if name == "LegacyTransformer":
            ref, got = f32(torch.from_numpy(img)), f64(torch.from_numpy(img).double())
            assert got.dtype == torch.float64
            _close(got.float(), ref.numpy())
            return
        ref = f32(torch.from_numpy(img), torch.from_numpy(desvel))
        got = f64(torch.from_numpy(img).double(), torch.from_numpy(desvel).double())
    assert got[0].dtype == torch.float64
    _close(got[0].float(), ref[0].numpy())
    if ref[1] is not None:
        for g, r in zip(got[1], ref[1]):
            _close(g.float(), r.numpy())


# ------------------------------------------------------------------- training

def test_convnet_train_step_matches_jax():
    """ConvNet's train steps on padded chunks (the frame mask in its
    BatchNorm) through the port's stepfn against the JAX step."""
    check_train_steps("vitfly_convnet")


# --------------------------------------------------------------------- card

@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ZOO) + ["LegacyTransformer"])
def test_zoo_on_the_card_matches_the_cpu(cuda_device, name):
    """Each model on the card (full f32, the entry points' default) against
    the same weights on the CPU, velocity and (h, c) within 1e-4 x max(1,
    max |x|); LSTMNet's and UNetConvLSTMNet's LSTMs launch no fused kernel."""
    from evfly_tpu_torch.ops import lstm_fused

    module = legacy_vit if name == "LegacyTransformer" else vitfly
    cpu = getattr(module, name)(generator=torch.Generator().manual_seed(3), device="cpu").eval()
    card = getattr(module, name)(device=cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    img, desvel, _ = _inputs(13, n=8)
    launches = [k.launches for k in (lstm_fused.lstm_stacked, lstm_fused.lstm_wavefront,
                                     lstm_fused.lstm_stacked_cluster,
                                     lstm_fused.lstm_stacked_grid)]
    with torch.no_grad():
        if name == "LegacyTransformer":
            ref, got = cpu(torch.from_numpy(img)), card(torch.from_numpy(img).to(cuda_device))
            _close(got.cpu(), ref.numpy())
            return
        ref = cpu(torch.from_numpy(img), torch.from_numpy(desvel))
        got = card(torch.from_numpy(img).to(cuda_device), torch.from_numpy(desvel).to(cuda_device))
    torch.cuda.synchronize()
    _close(got[0].cpu(), ref[0].numpy())
    if ref[1] is not None:
        for g, r in zip(got[1], ref[1]):
            _close(g.cpu(), r.numpy())
    assert launches == [k.launches for k in (lstm_fused.lstm_stacked, lstm_fused.lstm_wavefront,
                                             lstm_fused.lstm_stacked_cluster,
                                             lstm_fused.lstm_stacked_grid)]
