"""The joint model's train and eval steps (``OrigUNet_w_VITFLY_ViTLSTM``,
the ``joint`` configuration of tools/train_policy.py: loss weights [10, 1],
optional loss params [5, -1]) of the port against the JAX package's, on the
CPU, from ``port.from_jax_params`` of a JAX init (tests/torch_train_cases.py,
with its tolerances; the eval step's predictions within 1e-4, as
tests/test_torch_joint.py).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from evfly_tpu.train import stepfn as jstepfn
from evfly_tpu_torch.train import stepfn
from torch_train_cases import (UNET_HW, check_train_steps, few_torch_threads,  # noqa: F401
                               make_batch, make_models, torch_batch)


def test_train_steps_match_jax():
    check_train_steps("joint_vitlstm")


def test_eval_step_matches_jax_and_leaves_the_model():
    jm, params, model = make_models("joint_vitlstm")
    lw, olp = [10.0, 1.0], [5.0, -1.0]
    nb = make_batch(30, 3, UNET_HW, 2)
    jl, jv, jpv, jpd = jax.jit(jstepfn.make_eval_step(jm, "joint_vitlstm", lw, olp))(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in nb.items()}, None)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, values, pv, pd = stepfn.make_eval_step(model, "joint_vitlstm", lw, olp)(torch_batch(nb))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(values.numpy(), np.asarray(jv), rtol=1e-5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jpv), atol=1e-4)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jpd), atol=1e-4)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert not model.training and pv[:, 2].abs().max().item() == 0.0
