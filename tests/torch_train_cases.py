"""Shared cases of the port's train-step tests (tests/test_torch_train_*.py,
tests/test_torch_velpred.py, tests/test_torch_zoo.py): the three model
kinds of tools/train_policy.py, the velocity heads (D(theta) at velpred 11,
``ConvNet_w_VelPred``) and the zoo's ``ConvNet`` at small frames, seeded padded batches, and train
steps of the port against the JAX package's.

The JAX step and gradient run under ``jax.jit`` without donation (op by op
the first step takes one to two minutes on the CPU), with ``rng=None``: no
augmentation and no dropout on either side.

Tolerances: the loss and terms rtol 1e-5; every gradient within
1e-4 x max(1, max|g|) and the gradient norm rtol 1e-4 (f32 sums in another
order through a UNet or two transformer blocks and an LSTM, then backward);
u and v within 1e-5; BatchNorm running stats within 1e-6 + 1e-5 relative
(tests/test_masked_bn.py's bounds) and their counters exactly, against
JAX's ``{**params, **updates}``.  Each parameter element's update after step s
(1-based) of Adam at lr 1e-5, Delta = p_s - p_0, within 0.05 lr s of
JAX's: Adam moves an element by lr g / (|g| + eps) at its first step, which
a change of d in g moves by at most lr d / (4 |g|), so where |g| exceeds 100
times its leaf's largest disagreement between the packages' gradients the
two updates differ by lr / 400 and by rounding (the largest reading was
0.012 lr, in V(phi)'s ``encoder_blocks.0._lNorm.1.weight`` after step 3;
a skipped or reversed step reads lr or 2 lr, an LR 10% off 0.1 lr).  An
element whose gradient was within that margin of 0 at some step, unless
both packages' were exactly 0 (rounding may set the sign of its step; 3.4%
of V(phi)'s elements, 12% of D(theta)'s, 10% of the joint model's), is held
to 2 lr s + 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from evfly_tpu.models.common import is_trainable_key
from evfly_tpu.models.composites import ConvNet_w_VelPred as JaxConvNetVelPred
from evfly_tpu.models.composites import OrigUNet_w_VITFLY_ViTLSTM as JaxJoint
from evfly_tpu.models.origunet import OrigUNet as JaxOrigUNet
from evfly_tpu.models.vitfly import ConvNet as JaxConvNet
from evfly_tpu.models.vitfly import LSTMNetVIT as JaxLSTMNetVIT
from evfly_tpu.train import stepfn as jstepfn
from evfly_tpu_torch.models.composites import ConvNet_w_VelPred, OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.origunet import OrigUNet
from evfly_tpu_torch.models.port import from_jax_params
from evfly_tpu_torch.models.vitfly import ConvNet, LSTMNetVIT
from evfly_tpu_torch.train import stepfn

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
UNET_HW = (190, 190)  # the smallest frame the 5-level valid-padding UNet takes
VIT_HW = (60, 90)     # LSTMNetVIT's own input size
UNET = dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0], velpred=0,
            form_BEV=2, evs_min_cutoff=0.0, skip_type="interp", input_shape=[1, 1, *UNET_HW])
# the velocity heads at small frames: D(theta)'s head on its 4x4 decoder
# output at 190x190 (one conv and a stride-1 pool: 16 features), and
# ConvNet_w_VelPred on 40x60 frames (two layers: 8 x 2 x 3 = 48 features,
# its LSTM's hidden size)
HEAD_ENC = {
    "num_layers": 1, "kernel_sizes": [2], "kernel_strides": [1], "out_channels": [4],
    "activations": ["relu"], "pool_type": "max", "invert_pool_inputs": True,
    "pool_kernels": [2], "pool_strides": [1], "conv_function": "conv2d",
}
CV_HW = (40, 60)
CV_ENC = {
    "num_layers": 2, "kernel_sizes": [5, 3], "kernel_strides": [2, 2], "out_channels": [4, 8],
    "activations": ["relu", "relu"], "pool_type": "max", "invert_pool_inputs": True,
    "pool_kernels": [2, 2], "pool_strides": [2, 2], "conv_function": "conv2d",
}
HEAD_FC = {"num_layers": 3, "layer_sizes": [16, 8, 1],
           "activations": ["leaky_relu", "leaky_relu", "tanh"], "dropout_p": 0.1}
LR, STEPS = 1e-5, 3
# torch threads per test process in the training tests: the test run has
# several worker processes on a few cores, and PyTorch's default of one
# thread per core in each of them oversubscribes the cores many times over
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """TORCH_THREADS for the module's tests, the process's setting after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)

# case -> (frames, frame size, valid frames, depth input, input_frame_scale,
# loss weights, optional loss params): the three configurations of
# tools/train_policy.py, V(phi)'s through input_frame_scale, and the
# velocity heads
STEP_CASES = {
    "origunet": (3, UNET_HW, 2, False, 1.0, [0.0, 1.0], [0.0, -1.0]),
    "vitfly": (4, VIT_HW, 3, True, 2.0, [1.0, 0.0], [5.0, 0.0]),
    "joint_vitlstm": (3, UNET_HW, 2, False, 1.0, [10.0, 1.0], [5.0, -1.0]),
    "origunet_velpred": (3, UNET_HW, 2, False, 1.0, [10.0, 1.0], [5.0, -1.0]),
    "convnet_velpred": (4, CV_HW, 3, True, 1.0, [1.0, 0.0], [5.0, 0.0]),
    "vitfly_convnet": (4, VIT_HW, 3, True, 1.0, [1.0, 0.0], [5.0, 0.0]),
}
# the stepfn kind of a case, where it is not the case's name
CASE_KIND = {"origunet_velpred": "origunet", "vitfly_convnet": "vitfly"}


def make_batch(seed, n, hw, n_valid, depth_input=False):
    """A padded chunk: event frames (or depths), desvel 4 (1 on padding),
    velocity commands with a zero y, depth ground truth, the mask."""
    rng = np.random.default_rng(seed)
    frames = (rng.integers(-3, 4, (n, 1, *hw)) * (rng.random((n, 1, *hw)) < 0.2) * 0.3)
    inp = rng.random((n, 1, *hw)) if depth_input else np.clip(frames, -1, 1)
    gt_vel = np.stack([np.full(n, 4.0), rng.normal(size=n) * 0.8, np.zeros(n)], 1)
    gt_vel[0, 1] = 0.0
    mask = (np.arange(n) < n_valid).astype(np.float32)
    desvel = np.where(mask[:, None] > 0, 4.0, 1.0)
    return {"input": inp.astype(np.float32), "desvel": desvel.astype(np.float32),
            "gt_vel": gt_vel.astype(np.float32),
            "gt_frames": rng.random((n, 1, *hw)).astype(np.float32), "mask": mask}


def make_models(case):
    """(JAX model, its params as numpy, the port model with those params)."""
    if case == "origunet":
        jm, pm = JaxOrigUNet(enc_params=ENC, fc_params=FC, **UNET), OrigUNet(device="cpu", **UNET)
    elif case == "vitfly":
        jm, pm = JaxLSTMNetVIT(), LSTMNetVIT(device="cpu")
    elif case == "vitfly_convnet":
        jm, pm = JaxConvNet(), ConvNet(device="cpu")
    elif case == "origunet_velpred":
        heads = dict(UNET, velpred=11, enc_params=HEAD_ENC, fc_params=HEAD_FC)
        jm, pm = JaxOrigUNet(**heads), OrigUNet(device="cpu", **heads)
    elif case == "convnet_velpred":
        args = (1, 1, 1, CV_ENC, HEAD_FC, (1, 1, *CV_HW))
        jm, pm = JaxConvNetVelPred(*args), ConvNet_w_VelPred(*args, device="cpu")
    else:
        jm = JaxJoint(enc_params=ENC, fc_params=FC, **UNET)
        pm = OrigUNet_w_VITFLY_ViTLSTM(device="cpu", **UNET)
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(5)).items()}
    pm.load_state_dict(from_jax_params(params, "cpu"))
    return jm, params, pm


def jax_optimizer(params):
    """The JAX Learner's optimizer (evfly_tpu/train/learner.py:228-233)."""
    mask = {k: is_trainable_key(k) for k in params}
    return optax.inject_hyperparams(
        lambda learning_rate: optax.masked(optax.adam(learning_rate), mask))(learning_rate=LR)


def torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def check_train_steps(case):
    """STEPS train steps of the port and of JAX from one JAX init: the loss,
    logged terms and gradient norm of each, every gradient of the first, and
    every parameter's update, u, v and BatchNorm state after each."""
    n, hw, n_valid, depth_input, scale, lw, olp = STEP_CASES[case]
    kind = CASE_KIND.get(case, case)
    jm, params, model = make_models(case)
    jopt = jax_optimizer(params)
    jstep = jax.jit(jstepfn.make_train_step(jm, kind, jopt, lw, olp, input_frame_scale=scale))
    jforward = jstepfn.make_forward_loss(jm, kind, lw, olp, input_frame_scale=scale)

    @jax.jit
    def jgrads(params, batch):
        """The gradient JAX's step takes: of the trainable leaves, after the
        power iteration."""
        upd = {**params, **jstepfn.spectral_updates(params)}
        rest = {k: v for k, v in upd.items() if not is_trainable_key(k)}
        diff = {k: v for k, v in upd.items() if is_trainable_key(k)}
        return jax.grad(lambda d: jforward({**d, **rest}, batch, None)[0])(diff)

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = stepfn.make_train_step(model, kind, opt, lw, olp, input_frame_scale=scale)

    loose = {}  # trainable key -> elements held to 2 lr s + 1e-5
    for s in range(STEPS):
        nb = make_batch(10 + s, n, hw, n_valid, depth_input)
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        ref_grads = jgrads(jparams, jb)
        jparams, jstate, jloss, jvalues, jgn = jstep(jparams, jstate, jb, None)
        loss, values, gn = step(torch_batch(nb), None)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=1e-5)
        np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-4)
        assert all(p.grad is not None for p in model.parameters())
        for name, p in model.named_parameters():
            g, r = p.grad.numpy(), np.asarray(ref_grads[name])
            if s == 0:
                np.testing.assert_allclose(g, r, atol=1e-4 * max(1.0, float(np.abs(r).max())),
                                           err_msg=name)
            near_0 = (np.abs(r) <= 100 * np.abs(g - r).max()) & ((r != 0) | (g != 0))
            loose[name] = loose.get(name, near_0) | near_0
        state = model.state_dict()
        for k, v in jparams.items():
            if k.endswith("num_batches_tracked"):
                assert int(state[k]) == int(v) == s + 1, (k, s)
                continue
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(state[k].numpy(), np.asarray(v), rtol=1e-5,
                                           atol=1e-6, err_msg=k)
                continue
            if not is_trainable_key(k):
                np.testing.assert_allclose(state[k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)
                continue
            err = np.abs((state[k].numpy() - params[k]) - (np.asarray(v) - params[k]))
            bound = np.where(loose[k], 2 * LR * (s + 1) + 1e-5, 0.05 * LR * (s + 1))
            assert (err <= bound).all(), (k, s, float((err / bound).max()))
