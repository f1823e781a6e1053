"""The velocity-head models of the port against the JAX package, on the CPU:
``ConvNet_w_VelPred`` and ``OrigUNet_w_ConvNet_w_VelPred`` (forward, with a
carried state), their train steps and D(theta)'s at velpred 11 on padded
chunks (BatchNorm statistics over the valid frames, running stats and
counters against JAX's ``{**params, **updates}``), a padded chunk's step
against the unpadded one, the Learner's training, checkpoint and resume
of both configurations (the port alone), the composite through
``StreamingPipeline`` against the JAX pipeline, and one forward of the
shipped velpred-11
configuration (evfly_tpu/configs/files/eval_sim_Dtheta_vitlstm.txt) at the
sensor size.  Each model goes through both packages from one JAX init on
the same numpy inputs; there is no trained velocity-head checkpoint.

Tolerances: velocities, depths and every h within 1e-4
(tests/test_model_parity.py:26), every LSTM c within 1e-4 x max(1, max|c|)
(tests/test_torch_joint.py); the train steps those of
tests/torch_train_cases.py; a padded chunk's step against the unpadded one
within rtol 1e-5 (loss, terms, running stats; tests/test_masked_bn.py) and
1e-5 x max(1, max|g|) (gradients: the same sums over 2 frames in a batch
of 3 and in a batch of 2).

JAX's composite fixes its head's input at the 68x148 decoder output of
260x346 frames; the port's reads the decoder's size.  At the 190x190 frames
of these tests the decoder gives 4x4, so the composite's head uses an
encoder whose pool stride passes the frame (``FLAT_ENC``): each map pools
to 1x1 at both sizes, and both packages build the same head.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evfly_tpu.configs import parse_config_file as jax_parse_config_file
from evfly_tpu.models import registry as jregistry
from evfly_tpu.models.composites import ConvNet_w_VelPred as JaxConvNetVelPred
from evfly_tpu.models.composites import OrigUNet_w_ConvNet_w_VelPred as JaxHeads
from evfly_tpu.stream import pipeline as jpipeline
from evfly_tpu_torch.configs import EvflyConfig, parse_config_file
from evfly_tpu_torch.models import registry
from evfly_tpu_torch.models.composites import ConvNet_w_VelPred, OrigUNet_w_ConvNet_w_VelPred
from evfly_tpu_torch.models.port import from_jax_params, load_state_dict
from evfly_tpu_torch.stream import BatchedStreamingPipeline, StreamingPipeline
from evfly_tpu_torch.train import stepfn
from evfly_tpu_torch.train.learner import Learner
from test_torch_learner import _kw, _toy_dataset
from torch_train_cases import (ENC, FC, HEAD_ENC, STEP_CASES, UNET, UNET_HW,  # noqa: F401
                               check_train_steps, few_torch_threads, make_batch, make_models,
                               torch_batch)

ATOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG_A = REPO / "evfly_tpu" / "configs" / "files" / "eval_sim_Dtheta_vitlstm.txt"
# pools every map of a 4x4 or a 68x148 input to 1x1 (see the module's docstring)
FLAT_ENC = {
    "num_layers": 1, "kernel_sizes": [3], "kernel_strides": [1], "out_channels": [16],
    "activations": ["relu"], "pool_type": "max", "invert_pool_inputs": True,
    "pool_kernels": [2], "pool_strides": [147], "conv_function": "conv2d",
}
SMALL_FC = {"num_layers": 3, "layer_sizes": [16, 8, 1],
            "activations": ["leaky_relu", "leaky_relu", "tanh"], "dropout_p": 0.1}
# configuration B at 190x190: D(theta) of the joint model, a 1-layer LSTM head
B_CONFIG = dict(UNET, num_recurrent=[1, 1], enc_params=FLAT_ENC, fc_params=SMALL_FC)


def _init(jm, seed=5):
    return {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(seed)).items()}


def _frames(seed, n, hw):
    rng = np.random.default_rng(seed)
    return np.clip(rng.integers(-3, 4, (n, 1, *hw)) * (rng.random((n, 1, *hw)) < 0.2) * 0.3,
                   -1, 1).astype(np.float32)


def _close_state(got, ref):
    """(h, c) of an LSTM: h within ATOL, c within ATOL x max(1, max|c|)."""
    h, c = (np.asarray(t) for t in ref)
    np.testing.assert_allclose(got[0].numpy(), h, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), c, atol=ATOL * max(1.0, float(np.abs(c).max())))


@pytest.fixture(scope="module")
def heads_b():
    """Configuration B at 190x190 in both packages, one JAX init."""
    jm = JaxHeads(num_outputs=1, **B_CONFIG)
    params = _init(jm)
    model = OrigUNet_w_ConvNet_w_VelPred(num_outputs=1, device="cpu", **B_CONFIG).eval()
    model.load_params(from_jax_params(params, "cpu"))
    return jm, params, model


# ------------------------------------------------------------ the forwards

@pytest.mark.parametrize("num_recurrent", [0, 1])
def test_convnet_w_velpred_matches_jax_at_hidden_768(num_recurrent):
    """The shipped enc and fc params on the 68x148 decoder output: 768
    features, the LSTM of hidden 768 that K4 and K5 take on the card; two
    chunks of 3 frames with the state carried."""
    jm = JaxConvNetVelPred(1, num_recurrent, 1, ENC, FC, (1, 1, 68, 148))
    params = _init(jm)
    model = ConvNet_w_VelPred(1, num_recurrent, 1, ENC, FC, (1, 1, 68, 148), device="cpu").eval()
    assert model.feat_size == jm.feat_size == 768
    model.load_state_dict(from_jax_params(params, "cpu"))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jh, th = None, None
    for seed in (1, 2):
        x = np.random.default_rng(seed).random((3, 1, 68, 148)).astype(np.float32)
        jv, jh, _ = jm.apply(jparams, [jnp.asarray(x), None, jh])
        with torch.no_grad():
            tv, th = model(torch.from_numpy(x), None, th)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
        assert (th is None) == (jh is None) == (num_recurrent == 0)
        if th is not None:
            _close_state(th, jh)


def test_composite_matches_jax_with_a_carried_state(heads_b):
    jm, params, model = heads_b
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jhidden, thidden = jm.init_hidden(), model.init_hidden()
    apply = jax.jit(lambda p, x, hu, hc: jm.apply(p, [x, None, hu, hc])[:2])
    for seed in (3, 4):
        x = _frames(seed, 2, UNET_HW)
        jv, (jd, ju, (jhu, jhc)) = apply(jparams, jnp.asarray(x), *jhidden)
        with torch.no_grad():
            tv, (td, tu, (thu, thc)) = model(torch.from_numpy(x), None, *thidden)
        for got, ref in ((tv, jv), (td, jd), (tu, ju)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        _close_state(thc, jhc)
        _close_state(thu[0][0], jhu[0][0])
        assert thu[1] is None
        jhidden, thidden = (jhu, jhc), (thu, thc)


def test_composite_stream_axis_is_independent_sequences(heads_b):
    """(G, N, 1, H, W) through the composite == G separate sequences."""
    _, _, model = heads_b
    x = _frames(5, 6, UNET_HW).reshape(3, 2, 1, *UNET_HW)
    with torch.no_grad():
        vel, (_, _, ((h_unet, _), (h, c))) = model(torch.from_numpy(x), None,
                                                   *model.init_hidden(streams=3))
        for g in range(3):
            v1, (_, _, ((hu1, _), (h1, c1))) = model(torch.from_numpy(x[g]))
            torch.testing.assert_close(vel[g], v1, atol=ATOL, rtol=0)
            torch.testing.assert_close(h[g], h1, atol=ATOL, rtol=0)
            torch.testing.assert_close(c[g], c1, atol=ATOL, rtol=0)
            torch.testing.assert_close(h_unet[0][0][g], hu1[0][0][0], atol=ATOL, rtol=0)


def test_config_a_forward_matches_jax_at_sensor_size():
    """eval_sim_Dtheta_vitlstm.txt as shipped, through both registries at
    260x346: D(theta) with velpred 11 (768 head features), 2 frames."""
    jcfg, cfg = jax_parse_config_file(str(CONFIG_A)), parse_config_file(str(CONFIG_A))
    jm = jregistry.build_model(jcfg)
    params = _init(jm)
    model = registry.build_model(cfg, device="cpu").eval()
    assert model.velpred == 11 and model.velpred_lstm_size == 768
    model.load_state_dict(from_jax_params(params, "cpu"))
    x = _frames(6, 2, (260, 346))
    jv, (jd, ju, _), _ = jax.jit(lambda p, x: jm.apply(p, [x, None, None]))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    with torch.no_grad():
        tv, (td, tu, _) = model(torch.from_numpy(x))
    for got, ref in ((tv, jv), (td, jd), (tu, ju)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert tv[:, 2].abs().max().item() == 0.0


# ------------------------------------------------------------ the train steps

@pytest.mark.parametrize("case", ["origunet_velpred", "convnet_velpred"])
def test_train_steps_match_jax(case):
    check_train_steps(case)


@pytest.mark.parametrize("case", ["origunet_velpred", "convnet_velpred"])
def test_padded_chunk_step_equals_the_unpadded_one(case):
    """A chunk of n frames, n_valid of them valid, against its n_valid
    frames alone: loss, terms, every gradient, the running stats and the
    counters after one step from the same params."""
    n, hw, n_valid, depth_input, scale, lw, olp = STEP_CASES[case]
    kind = "origunet" if case == "origunet_velpred" else case
    padded = make_batch(40, n, hw, n_valid, depth_input)
    ragged = {k: v[:n_valid] for k, v in padded.items()}
    out = []
    for nb in (padded, ragged):
        _, _, model = make_models(case)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        step = stepfn.make_train_step(model, kind, opt, lw, olp, input_frame_scale=scale)
        loss, values, _ = step(torch_batch(nb), None)
        out.append((loss.item(), values.numpy(), {k: p.grad for k, p in model.named_parameters()},
                    {k: b for k, b in model.named_buffers()}))
    (lp, vp, gp, bp), (lr_, vr, gr, br) = out
    np.testing.assert_allclose(lp, lr_, rtol=1e-5)
    np.testing.assert_allclose(vp, vr, rtol=1e-5)
    for k, g in gr.items():
        np.testing.assert_allclose(gp[k].numpy(), g.numpy(),
                                   atol=1e-5 * max(1.0, g.abs().max().item()), err_msg=k)
    assert any(k.endswith("running_mean") for k in br)
    for k, b in br.items():
        if k.endswith("num_batches_tracked"):
            assert int(bp[k]) == int(b) == 1
        else:
            np.testing.assert_allclose(bp[k].numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_eval_steps_of_the_head_kinds_match_jax(heads_b):
    """joint_convnet (configuration B) and convnet_velpred eval steps: the
    running stats normalize, no buffer moves, z is kept."""
    from evfly_tpu.train import stepfn as jstepfn

    lw, olp = [10.0, 1.0], [5.0, -1.0]
    jm, params, model = heads_b
    cases = [("joint_convnet", jm, params, model, make_batch(41, 3, UNET_HW, 2))]
    cjm, cparams, cmodel = make_models("convnet_velpred")
    cases.append(("convnet_velpred", cjm, cparams, cmodel,
                  make_batch(42, *STEP_CASES["convnet_velpred"][:4])))
    for kind, jm_, params_, model_, nb in cases:
        jl, jv, jpv, jpd = jax.jit(jstepfn.make_eval_step(jm_, kind, lw, olp))(
            {k: jnp.asarray(v) for k, v in params_.items()},
            {k: jnp.asarray(v) for k, v in nb.items()}, None)
        before = {k: v.clone() for k, v in model_.state_dict().items()}
        loss, values, pv, pd = stepfn.make_eval_step(model_, kind, lw, olp)(torch_batch(nb))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        np.testing.assert_allclose(values.numpy(), np.asarray(jv), rtol=1e-5)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jpv), atol=ATOL)
        assert (pd is None) == (jpd is None) == (kind == "convnet_velpred")
        if pd is not None:
            np.testing.assert_allclose(pd.numpy(), np.asarray(jpd), atol=ATOL)
        assert all(torch.equal(v, before[k]) for k, v in model_.state_dict().items())


@pytest.mark.parametrize("config", ["A", "B"])
def test_learner_trains_checkpoints_and_resumes_the_heads(tmp_path, config):
    """Configuration A (velpred 11) and B (ConvNet_w_VelPred with an LSTM)
    through the port's Learner at 190x190: an epoch of training and
    validation counts one BatchNorm update per train step; the checkpoint
    carries the running stats and int64 counters; a resume loads them, and
    its next epoch counts on from them."""
    data_path = _toy_dataset(tmp_path, np.random.default_rng(4), n_traj=2, T=5)
    heads = {"A": dict(model_type=["OrigUNet"], velpred=11, num_recurrent=[1, 0]),
             "B": dict(model_type=["OrigUNet", "ConvNet_w_VelPred"], num_recurrent=[1, 1])}
    enc = {f"enc_{k}": v for k, v in HEAD_ENC.items()}
    fc = {f"fc_{k}": v for k, v in SMALL_FC.items()}
    kw = _kw(tmp_path, data_path, N_eps=1, num_outputs=1, **heads[config], **enc, **fc)
    learner = Learner(EvflyConfig(**kw))
    counters = [k for k in learner.params if k.endswith("num_batches_tracked")]
    assert len(counters) == 1
    learner.train_loop()
    steps = learner.num_training_steps  # one chunk of 4 frames a trajectory
    assert [int(learner.params[k]) for k in counters] == [steps]
    path = os.path.join(learner.workspace, "model_ep000000.pth")
    saved = load_state_dict(path)
    assert saved[counters[0]].dtype == torch.int64 and int(saved[counters[0]]) == steps
    assert all(torch.equal(saved[k], v) for k, v in learner.params.items())
    assert any(k.endswith("running_var") and not torch.all(v == 1.0) for k, v in saved.items())
    resumed = Learner(EvflyConfig(**{**kw, "checkpoint_path": path}))
    assert all(torch.equal(resumed.params[k], v) for k, v in saved.items())
    resumed.train_loop()
    assert int(resumed.params[counters[0]]) == 2 * steps


# ------------------------------------------------------------ streaming

def test_streaming_pipeline_matches_jax(heads_b):
    """Configuration B through both StreamingPipelines at 190x190: two
    windows of raw events and a frame, state carried; then the batched
    pipeline with 2 streams against 2 single streams."""
    jm, params, model = heads_b
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jpipe = jpipeline.StreamingPipeline(jm, jparams, input_hw=UNET_HW, fast_percentile=True)
    pipe = StreamingPipeline(model, input_hw=UNET_HW, fast_percentile=True, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(2):
        n = 3000
        ex = rng.uniform(0, UNET_HW[1], n).astype(np.float32)
        ey = rng.uniform(0, UNET_HW[0], n).astype(np.float32)
        ep = rng.choice([-1, 1], n).astype(np.int32)
        vj, dj = jpipe.step_events(jnp.asarray(ex), jnp.asarray(ey), jnp.asarray(ep))
        vt, dt = pipe.step_events(ex, ey, ep)
        assert vt.shape == (3,) and dt.shape == UNET_HW
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=ATOL)
        _close_state(pipe.hidden[1], jpipe.hidden[1])
    frame = _frames(8, 1, UNET_HW)[0, 0]
    vj, _ = jpipe.step_frame(jnp.asarray(frame))
    vt, _ = pipe.step_frame(frame)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    _close_state(pipe.hidden[1], jpipe.hidden[1])

    frames = _frames(9, 2, UNET_HW)[:, 0]
    batched = BatchedStreamingPipeline(model, 2, desvel=[3.0, 5.0], input_hw=UNET_HW,
                                       fast_percentile=True, device="cpu")
    vb, db = batched.step_frames(frames)
    for g, dv in enumerate((3.0, 5.0)):
        single = StreamingPipeline(model, desvel=dv, input_hw=UNET_HW, fast_percentile=True,
                                   device="cpu")
        v1, d1 = single.step_frame(frames[g])
        torch.testing.assert_close(vb[g], v1, atol=ATOL, rtol=0)
        torch.testing.assert_close(db[g], d1, atol=ATOL, rtol=0)
        h, c = batched.hidden[1]
        torch.testing.assert_close(h[g], single.hidden[1][0], atol=ATOL, rtol=0)
