"""The port's Learner against the JAX package's, on the CPU.

One toy h5 dataset (tests/test_learner.py's schema, 190x190 frames: the
smallest the UNet takes) and one seed; ``model_type OrigUNet`` at velpred 0,
which has no dropout, and ``data_augmentation 0``, so both runs are
deterministic.  Both start from the same ``.pth`` (saved by the JAX
package) through ``checkpoint_path`` and train 2 epochs; the JAX Learner
runs its per-chunk path (``traj_scan``/``epoch_scan`` off: the port has
only that one, and ``tests/test_traj_scan.py`` holds the JAX package's
other paths equal to it).  Compared: every trajectory's train and
validation loss and terms, the LR each trajectory ran at, the names of the
checkpoints written and their tensors.  Also: ``combine_checkpoints`` and
the composite pair load against the JAX Learner's, checkpoints crossing
between the packages, the device residency arrays, and the host path above
their cap.  Resume, the device rule and the CLI are in
tests/test_torch_learner_resume.py.

Tolerances: losses and terms rtol 1e-4 (the same math in another order,
over 8 Adam steps whose parameters drift apart by rounding); LRs exact up to
f32 (JAX holds the LR as an f32 array); each trainable tensor of a
checkpoint as the change from the starting ``.pth``, Delta = p - p_start,
with ||Delta_port - Delta_jax|| <= 1e-3 ||Delta_jax|| over each leaf (the
largest reading on the CPU was 2.4e-5, in ``unet_e51.weight`` after
epoch 0's 4 Adam steps; an untrained or reversed update reads 1 or 2), so a
checkpoint that JAX saved before any step (``model_ep000000.pth``) must
equal the start exactly; u and v within 1e-5; the residency arrays exactly.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax

from evfly_tpu.configs import EvflyConfig as JaxConfig
from evfly_tpu.models import port as jport
from evfly_tpu.models.common import is_trainable_key
from evfly_tpu.models.origunet import OrigUNet as JaxOrigUNet
from evfly_tpu.train.learner import Learner as JaxLearner
from evfly_tpu_torch.configs import EvflyConfig
from evfly_tpu_torch.data.dataloading import write_h5_dataset
from evfly_tpu_torch.models import port
from evfly_tpu_torch.models.origunet import OrigUNet
from evfly_tpu_torch.train.learner import Learner
from torch_train_cases import ENC, FC, UNET, UNET_HW, few_torch_threads  # noqa: F401

LR = 1e-4


def _toy_dataset(tmp_path, rng, n_traj=4, T=12, hw=UNET_HW, name="toy"):
    trajs = []
    for i in range(n_traj):
        meta = np.zeros((T, 21), np.float32)
        meta[:, 0] = np.arange(T)
        meta[:, 1] = np.arange(T) * 0.03
        meta[:, 2] = 4.0
        meta[:, 13] = 4.0
        meta[:, 14] = rng.standard_normal(T) * 0.3
        trajs.append({
            "name": f"traj_{i:03d}", "data": meta,
            "ims": rng.random((T, *hw)).astype(np.float32),
            "depths": rng.random((T, *hw)).astype(np.float32),
            "desvel": meta[:, 2],
            "evs": (rng.standard_normal((T - 1, *hw)) * 0.4).astype(np.float32),
        })
    path = str(tmp_path / name)
    write_h5_dataset(path + ".h5", trajs)
    return path


def _kw(tmp_path, data_path, **over):
    kw = dict(
        basedir=str(tmp_path), logdir="logs", datadir=str(tmp_path), dataset=[data_path],
        use_h5=True, events="evs_frames", keep_collisions=True, seed=5, val_split=0.5,
        batch_size=8, model_type=["OrigUNet"], velpred=0, num_recurrent=[1, 0], bev=2,
        skip_type="interp", evs_min_cutoff=0.0, resize_input=list(UNET_HW),
        num_in_channels=2, num_out_channels=1, N_eps=2, lr=LR, lr_warmup_epochs=1,
        save_model_freq=1, val_freq=1, loss_weights=[10.0, 1.0],
        optional_loss_param=[5.0, -1.0], rescale_evs=-1.0, print_trainprogress_freq=1,
        data_augmentation=0.0, traj_scan=False, epoch_scan=False, device="cpu",
    )
    kw.update(over)
    return kw


def _record(learner, lr_of):
    """Wrap run_model: (mode, loss, terms, lr) of each trajectory run."""
    runs = []
    inner = learner.run_model

    def run_model(it, starts, lengths, ids, mode, *args, **kwargs):
        lr = lr_of(learner)
        out = inner(it, starts, lengths, ids, mode, *args, **kwargs)
        (loss, terms) = out[0]
        runs.append((mode, loss, np.asarray(terms), lr))
        return out

    learner.run_model = run_model
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same 2-epoch OrigUNet run through the JAX Learner and the port's,
    from one JAX-saved checkpoint."""
    tmp_path = tmp_path_factory.mktemp("learner")
    data_path = _toy_dataset(tmp_path, np.random.default_rng(0))
    init = JaxOrigUNet(enc_params=ENC, fc_params=FC, **UNET).init(jax.random.PRNGKey(4))
    start = str(tmp_path / "start.pth")
    jport.save_state_dict(init, start)

    kw = _kw(tmp_path, data_path, checkpoint_path=[start])
    jl = JaxLearner(JaxConfig(**kw, ws_suffix="_jax"))
    jruns = _record(jl, lambda l: float(l.opt_state.hyperparams["learning_rate"]))
    jl.train_loop()
    pl = Learner(EvflyConfig(**kw, ws_suffix="_port"))
    pruns = _record(pl, lambda l: l.optimizer.param_groups[0]["lr"])
    pl.train_loop()
    return jl, jruns, pl, pruns


def test_losses_terms_and_lr_match_jax(runs):
    jl, jruns, pl, pruns = runs
    assert pl.num_training_steps == jl.num_training_steps == 2
    assert [r[0] for r in pruns] == [r[0] for r in jruns]
    assert len(pruns) == 2 * (2 + 2)  # per epoch: validate 2, train 2
    for (mode, loss, terms, lr), (_, jloss, jterms, jlr) in zip(pruns, jruns):
        np.testing.assert_allclose(loss, jloss, rtol=1e-4, err_msg=mode)
        np.testing.assert_allclose(terms, jterms, rtol=1e-4, err_msg=mode)
        if mode == "train":
            np.testing.assert_allclose(lr, jlr, rtol=1e-7)
    # the warm-up of 1 epoch (2 trajectories) ran: lr 0.1 lr, 0.55 lr, lr, lr
    lrs = [r[3] for r in pruns if r[0] == "train"]
    np.testing.assert_allclose(lrs, [0.1 * LR, 0.55 * LR, LR, LR], rtol=1e-12)
    assert pl.total_its == jl.total_its == 4


def test_workspace_and_checkpoints_match_jax(runs):
    jl, _, pl, _ = runs
    names = lambda ws: sorted(os.path.basename(p) for p in glob.glob(os.path.join(ws, "*")))
    ckpts = [n for n in names(pl.workspace) if n.endswith(".pth")]
    assert ckpts == [n for n in names(jl.workspace) if n.endswith(".pth")]
    assert "model_ep000000.pth" in ckpts and "model_ep000001.pth" in ckpts
    assert {"args.txt", "log.txt", "train_val_dirs.npy"} <= set(names(pl.workspace))
    assert os.path.basename(pl.workspace).endswith("_port")
    start = jport.load_state_dict(pl.cfg.checkpoint_path[0])
    moved = set()
    for name in ckpts:
        got = torch.load(os.path.join(pl.workspace, name), weights_only=True)
        ref = jport.load_state_dict(os.path.join(jl.workspace, name))
        assert list(got) == list(pl.params) and sorted(got) == sorted(ref)
        for k, v in ref.items():
            if not is_trainable_key(k):
                np.testing.assert_allclose(got[k].numpy(), v, atol=1e-5, err_msg=f"{name} {k}")
                continue
            delta, ref_delta = got[k].numpy() - start[k], v - start[k]
            err, size = np.linalg.norm(delta - ref_delta), np.linalg.norm(ref_delta)
            assert err <= 1e-3 * size, (name, k, err, size)
            if size > 0:
                moved.add(name)
    # the epoch-1 checkpoint holds epoch 0's 4 steps: the comparison saw an update
    assert "model_ep000001.pth" in moved
    tvd = np.load(os.path.join(pl.workspace, "train_val_dirs.npy"), allow_pickle=True)
    jtvd = np.load(os.path.join(jl.workspace, "train_val_dirs.npy"), allow_pickle=True)
    assert [list(x) for x in tvd] == [list(x) for x in jtvd]


def test_checkpoints_cross_between_the_packages(runs, tmp_path):
    """A port checkpoint reloads into the port bit for bit and into the JAX
    package's params; the JAX Learner's loads into the port."""
    jl, _, pl, _ = runs
    path = os.path.join(pl.workspace, "model_ep000001.pth")
    sd = port.load_state_dict(path)
    assert all(torch.equal(sd[k], v) for k, v in pl.params.items())
    jparams = jport.load_into(jl.params, jport.load_state_dict(path), strict=True)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(jparams[k]), v.numpy())
    model = OrigUNet(device="cpu", **UNET)
    model.load_state_dict(port.load_state_dict(os.path.join(jl.workspace, "model_ep000001.pth")))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jl.params[k]))


def test_device_residency_arrays_equal_jax(runs):
    """The split on the device: int8/uint8 with ``device_data_quantized``,
    else bf16, each as the JAX Learner stages it."""
    jl, _, pl, _ = runs
    for quantized in (True, False):
        jl.cfg.device_data_quantized = pl.cfg.device_data_quantized = quantized
        jl._device_data.clear()
        pl._device_data.clear()
        (jdata, joff), (data, off) = jl._get_device_data("val", 8), pl._get_device_data("val", 8)
        np.testing.assert_array_equal(off, joff)
        for k, v in jdata.items():
            np.testing.assert_array_equal(data[k].float().numpy(), np.asarray(v, np.float32),
                                          err_msg=k)
    pl.DEVICE_DATA_MAX_BYTES = 1
    pl._device_data.clear()
    assert pl._get_device_data("val", 8) is None


def test_host_path_above_the_cap_equals_the_resident_path(runs):
    """Above ``DEVICE_DATA_MAX_BYTES`` the chunks come from the host's f32
    frames: the same losses as the bf16-resident path within bf16's
    rounding of the inputs."""
    _, _, pl, _ = runs
    pl.cfg.device_data_quantized = False
    starts, lengths, ids = pl.val.traj_starts, pl.val.trajlength, np.arange(2)
    pl._device_data.clear()
    (res_loss, res_terms), (res_preds, _) = pl.run_model(0, starts, lengths, ids, "val",
                                                         batch_size=8)
    pl.DEVICE_DATA_MAX_BYTES = 1
    pl._device_data.clear()
    (host_loss, host_terms), (host_preds, _) = pl.run_model(0, starts, lengths, ids, "val",
                                                            batch_size=8)
    pl.DEVICE_DATA_MAX_BYTES = Learner.DEVICE_DATA_MAX_BYTES
    pl._device_data.clear()
    np.testing.assert_allclose(host_loss, res_loss, rtol=1e-2)
    assert host_preds[1].shape == res_preds[1].shape == (11, 1, *UNET_HW)


def _composite_kw(tmp_path, **over):
    return dict(basedir=str(tmp_path), logdir="logs", dataset=None, device="cpu",
                model_type=["OrigUNet", "VITFLY_ViTLSTM"], num_recurrent=[1, 0], bev=2,
                skip_type="interp", evs_min_cutoff=0.0, resize_input=list(UNET_HW), N_eps=0,
                **over)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """Standalone D(theta) and V(phi) checkpoints, saved by the JAX package."""
    from evfly_tpu.models.vitfly import LSTMNetVIT as JaxLSTMNetVIT

    tmp = tmp_path_factory.mktemp("parts")
    p_unet = JaxOrigUNet(enc_params=ENC, fc_params=FC, **UNET).init(jax.random.PRNGKey(1))
    p_vit = JaxLSTMNetVIT().init(jax.random.PRNGKey(2))
    cp0, cp1 = str(tmp / "Dtheta.pth"), str(tmp / "Vphi.pth")
    jport.save_state_dict(p_unet, cp0)
    jport.save_state_dict(p_vit, cp1)
    return cp0, cp1, p_unet, p_vit


@pytest.mark.parametrize("combine", [True, False])
def test_composite_pair_loads_under_the_prefixes(tmp_path, parts, combine):
    """combine_checkpoints merges D(theta) and V(phi) under origunet. and
    vitfly_vitlstm. (learner.py:435-494); without it the pair loads by
    prefix; both as the JAX Learner."""
    cp0, cp1, p_unet, p_vit = parts
    kw = _composite_kw(tmp_path, checkpoint_path=[cp0, cp1], combine_checkpoints=combine)
    learner = Learner(EvflyConfig(**kw))
    jlearner = JaxLearner(JaxConfig(**{**kw, "ws_suffix": "_jax", "device": "tpu"}))
    params = learner.params
    for k, v in p_unet.items():
        np.testing.assert_array_equal(params[f"origunet.{k}"].numpy(), np.asarray(v))
    for k, v in p_vit.items():
        np.testing.assert_array_equal(params[f"vitfly_vitlstm.{k}"].numpy(), np.asarray(v))
    for k, v in jlearner.params.items():
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(v), err_msg=k)


