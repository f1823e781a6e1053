"""The port's chunk-DP train step on the joint model against the JAX
package's, on the CPU: ``OrigUNet_w_VITFLY_ViTLSTM`` (tools/train_policy.py's
joint configuration, narrow encoder at 190x190, the smallest frame the UNet
takes) through ``make_dp_chunked_train_step``, G = 3 chunks of B = 4 event
frames from a resident split, one chunk partial and one padded, two steps,
against JAX's jitted step on its 1-device mesh (G = 3 does not split over 8;
tests/test_torch_parallel.py holds a BatchNorm model on both meshes) with
``rngs=None`` and ``generator=None``: no dropout.  Its own file: the JAX
jits of the vmapped joint model are the cost.

Tolerances (tests/torch_train_cases.py's): loss and terms rtol 1e-5, the
gradient norm rtol 1e-4, u and v within 1e-5, every gradient (the mean
over the real chunks) within 1e-4 x max(1, max|g|) of JAX's, and each
parameter element's change by that file's Adam rule (0.05 lr a step;
2 lr a step + 1e-5 where its gradient came near 0: the attention's key
biases, whose gradient is rounding).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from evfly_tpu.models.common import is_trainable_key
from evfly_tpu.train import stepfn as jstepfn
from evfly_tpu.parallel.data_parallel import make_dp_chunked_train_step as jax_dp_step
from evfly_tpu.parallel.mesh import make_mesh as jax_mesh
from evfly_tpu_torch.parallel import make_dp_chunked_train_step
from evfly_tpu_torch.parallel.mesh import Mesh
from test_torch_parallel import _assert_state_close, _jax_split
from torch_dp_cases import LR, chunk_idxs, resident_split, torch_split
from torch_train_cases import UNET_HW, few_torch_threads, jax_optimizer, make_models  # noqa: F401

LOSS = dict(loss_weights=[10.0, 1.0], optional_loss_param=[5.0, -1.0])


def test_joint_chunked_step_matches_jax():
    G, B, n_frames, n_ev = 3, 4, 10, 9
    jm, params, model = make_models("joint_vitlstm")
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_dp_chunked_train_step(model, "joint_vitlstm", opt, Mesh(1, 0, torch.device("cpu")),
                                      B, 2, 1, **LOSS)
    jopt = jax_optimizer(params)
    jstep = jax_dp_step(jm, "joint_vitlstm", jopt, jax_mesh(1), B, num_in_channels=2,
                        num_out_channels=1, **LOSS)
    split = resident_split(60, n_frames, n_ev, UNET_HW, B)
    data, jdata = torch_split(split), _jax_split(split)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    jforward = jstepfn.make_forward_loss(jm, "joint_vitlstm", **LOSS)
    jbatch = jstepfn.make_batch_slicer(B, 2, 1)

    @jax.jit
    def jgrads(params, idxs):
        """JAX's step's gradient: the mean over the real chunks, after the
        power iteration."""
        upd = {**params, **jstepfn.spectral_updates(params)}
        rest = {k: v for k, v in upd.items() if not is_trainable_key(k)}
        n_real = jnp.maximum((idxs["n_valid"] > 0).sum(), 1)

        def mean_loss(diff):
            one = lambda idx: jforward({**diff, **rest}, jbatch(jdata, idx), None)[0]
            return jax.vmap(one)(idxs).sum() / n_real

        return jax.grad(mean_loss)({k: v for k, v in upd.items() if is_trainable_key(k)})

    loose = {}
    for s, (seed, partial, padded) in enumerate(((61, 1, 1), (62, 0, 0))):
        idxs = chunk_idxs(seed, G, B, n_frames, n_ev, partial, padded)
        jidxs = {k: jnp.asarray(v, jnp.int32) for k, v in idxs.items()}
        ref_grads = jgrads(jparams, jidxs)
        jparams, jstate, jloss, jvalues, jgn, jn = jstep(jparams, jstate, jdata, jidxs, None)
        loss, values, gn, n_real = step(data, idxs, None)
        for name, p in model.named_parameters():
            g, r = p.grad.numpy(), np.asarray(ref_grads[name])
            np.testing.assert_allclose(g, r, atol=1e-4 * max(1.0, float(np.abs(r).max())),
                                       err_msg=name)
            near_0 = (np.abs(r) <= 100 * np.abs(g - r).max()) & ((r != 0) | (g != 0))
            loose[name] = loose.get(name, near_0) | near_0
        assert float(n_real) == float(jn) == G - padded
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=1e-5)
        np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-4)
        _assert_state_close(model.state_dict(), jparams, params, s + 1, loose)
    assert all(p.grad is not None for p in model.parameters())
