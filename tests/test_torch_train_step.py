"""One train step of the port against the JAX package's, on the CPU, for
D(theta) (``OrigUNet`` at velpred 0, events -> depth) and V(phi)
(``LSTMNetVIT``, depth -> velocity through ``input_frame_scale`` 2): from
``port.from_jax_params`` of a JAX init, 3 steps of Adam, the loss, logged
terms, gradients, gradient norm, params and spectral-norm u, v compared
(tests/torch_train_cases.py, with its tolerances).  The joint model's
steps are in tests/test_torch_train_joint.py.
"""

import pytest
import torch

from evfly_tpu_torch.train import stepfn
from torch_train_cases import (LR, VIT_HW, check_train_steps, few_torch_threads,  # noqa: F401
                               make_batch, make_models, torch_batch)


@pytest.mark.parametrize("kind", ["origunet", "vitfly"])
def test_train_steps_match_jax(kind):
    check_train_steps(kind)


def test_every_parameter_gets_a_gradient_and_an_adam_state():
    """optax steps every trainable leaf, so the port gives Adam every
    parameter, with a zero gradient where the loss does not reach it: the
    velocity's z column is set to 0, so nn_fc2's z bias gets a zero gradient
    and a first Adam step leaves it as it was."""
    _, _, model = make_models("vitfly")
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = stepfn.make_train_step(model, "vitfly", opt, [1.0, 0.0], [0.0, 0.0])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step(torch_batch(make_batch(20, 4, VIT_HW, 4, depth_input=True)), None)
    assert len(opt.state) == len(list(model.parameters()))
    # its weights still get a gradient, through the spectral norm's sigma
    assert model.nn_fc2.bias.grad[2].item() == 0.0
    assert torch.equal(model.nn_fc2.bias.detach()[2], before["nn_fc2.bias"][2])
    assert not torch.equal(model.nn_fc2.weight_u, before["nn_fc2.weight_u"])


def test_train_step_without_a_generator_refuses_augmentation():
    _, _, model = make_models("vitfly")
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = stepfn.make_train_step(model, "vitfly", opt, [1.0, 0.0], [0.0, 0.0],
                                  data_augmentation=True)
    with pytest.raises(ValueError, match="generator"):
        step(torch_batch(make_batch(21, 4, VIT_HW, 4, depth_input=True)), None)
