"""The port's Learner with chunk-level data parallelism against the JAX
Learner's ``_dp_train_epoch``, on the CPU.

tests/test_dp_learner.py's toy data (60x90 frames, chunks of 8) and model
(``VITFLY_ConvNet``: a BatchNorm, no dropout), ``data_augmentation 0``, seed
5; both Learners start from one JAX-saved ``.pth`` and train 2 epochs with
``dp_devices = 1, dp_chunks_per_device = 8`` (one process; JAX on its
1-device mesh).  Compared: each epoch's ``ep_loss`` (rtol 1e-4, as
tests/test_torch_learner.py), the final state (each trained tensor's change
from the start within 1e-3 of JAX's in norm; BatchNorm running stats 1e-6 +
1e-5 relative, the counter exactly), the LR schedule's calls against those
of JAX's (``test_dp_lr_schedule_tracks_sequential``'s warm-up and decay).
Also: G = 1 against the sequential loop, the resident-split requirement,
and ``tools/dp_quality`` at 2 trajectories x 1 epoch.
"""

import json
import math
import os

import numpy as np
import pytest

import jax

from evfly_tpu.configs import EvflyConfig as JaxConfig
from evfly_tpu.models import port as jport
from evfly_tpu.models.vitfly import ConvNet as JaxConvNet
from evfly_tpu.train.learner import Learner as JaxLearner
from evfly_tpu_torch.configs import EvflyConfig
from evfly_tpu_torch.train.learner import Learner
from test_torch_learner import _toy_dataset
from test_torch_parallel import _assert_state_close
from torch_train_cases import few_torch_threads  # noqa: F401

LR = 1e-3


def _kw(tmp_path, data_path, **over):
    """tests/test_learner.py's _base_config with test_dp_learner.py's
    overrides, on the CPU."""
    kw = dict(
        basedir=str(tmp_path), logdir="logs", datadir=str(tmp_path), dataset=[data_path],
        use_h5=True, events="evs_frames", keep_collisions=True, seed=5, val_split=0.5,
        batch_size=8, model_type=["VITFLY_ConvNet"], num_in_channels=2, num_out_channels=1,
        N_eps=2, lr=LR, lr_warmup_epochs=0, save_model_freq=1, val_freq=1,
        loss_weights=[10.0, 1.0], optional_loss_param=[5.0, -1.0], rescale_evs=-1.0,
        print_trainprogress_freq=1, data_augmentation=0.0, dp_devices=1,
        dp_chunks_per_device=8, device="cpu",
    )
    kw.update(over)
    return kw


def _train(learner):
    """train_loop -> the logged ep_loss and val_loss of each epoch and the
    LR schedule's calls."""
    ep, val, calls = [], [], []
    log, sched = learner.mylogger, learner.lr_scheduler

    def capture(msg):
        log(msg)
        if "ep_loss =" in msg:
            ep.append(float(msg.split("ep_loss = ")[1].split(",")[0]))
        if msg.startswith("[VAL] Validated"):
            val.append(float(msg.split("val_loss = ")[1].split(",")[0]))

    learner.mylogger = capture
    learner.lr_scheduler = lambda it: (calls.append(it), sched(it))[1]
    learner.train_loop()
    learner.mylogger, learner.lr_scheduler = log, sched
    return ep, val, calls


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy dataset (3 train trajectories of 11 frames: 6 chunks, one
    G = 8 step an epoch with 2 padded) and a JAX-saved start."""
    tmp_path = tmp_path_factory.mktemp("dp_learner")
    data_path = _toy_dataset(tmp_path, np.random.default_rng(0), n_traj=6, T=12, hw=(60, 90))
    start = str(tmp_path / "start.pth")
    jport.save_state_dict(JaxConvNet().init(jax.random.PRNGKey(3)), start)
    return tmp_path, data_path, start


@pytest.mark.parametrize("warmup", [0, 1])
def test_dp_epochs_match_jax(toy, warmup):
    """Per-epoch train and validation losses, the LR schedule's calls and
    the final state, the port against the JAX Learner; with warm-up 1 and
    decay the schedule lands at the sequential path's epoch fractions."""
    tmp_path, data_path, start = toy
    kw = _kw(tmp_path, data_path, checkpoint_path=[start], lr_warmup_epochs=warmup,
             lr_decay=bool(warmup))
    jl = JaxLearner(JaxConfig(**kw, ws_suffix=f"_jax{warmup}"))
    pl = Learner(EvflyConfig(**kw, ws_suffix=f"_port{warmup}"))
    jep, jval, jcalls = _train(jl)
    ep, val, calls = _train(pl)
    S = pl.num_training_steps
    assert S == jl.num_training_steps == 3 and len(ep) == len(jep) == 2
    np.testing.assert_allclose(ep, jep, rtol=1e-4)
    np.testing.assert_allclose(val, jval, rtol=1e-4)
    assert calls == jcalls and calls[0] == 0 and S in calls and calls[-1] == 2 * S
    assert pl.total_its == jl.total_its == 2 * S
    if warmup:
        assert pl.lr_scheduler(0) == pytest.approx(0.1 * LR)
        assert pl.lr_scheduler(S) == pytest.approx(LR)
        assert pl.lr_scheduler(2 * S) == pytest.approx(LR * 0.1 ** (S / (2 * S)))
    assert pl.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jl.opt_state.hyperparams["learning_rate"]), rel=1e-6)
    start_sd = jport.load_state_dict(start)
    _assert_state_close(pl.params, {k: np.asarray(v) for k, v in jl.params.items()},
                        start_sd, 2)


def test_one_chunk_per_step_is_the_sequential_loop(toy):
    """G = 1 (dp_devices 1, dp_chunks_per_device 1) steps Adam per chunk at
    the trajectory's LR, as the sequential loop: the same epochs."""
    tmp_path, data_path, start = toy
    runs = []
    for dp in (1, 0):
        kw = _kw(tmp_path, data_path, checkpoint_path=[start], dp_devices=dp,
                 dp_chunks_per_device=1, lr_warmup_epochs=1)
        learner = Learner(EvflyConfig(**kw, ws_suffix=f"_g1_{dp}"))
        runs.append((_train(learner), learner.params))
    (ep, val, calls), params = runs[0]
    (sep, sval, scalls), sparams = runs[1]
    np.testing.assert_allclose(ep, sep, rtol=1e-5)
    np.testing.assert_allclose(val, sval, rtol=1e-5)
    # the sequential loop's LRs, and the DP epoch's last call (the LR it
    # logs, at the next epoch's start)
    assert sorted(set(calls[:-1])) == sorted(set(scalls)) and calls[-1] == max(scalls) + 1
    for k, v in sparams.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_dp_needs_the_resident_split(toy):
    tmp_path, data_path, _ = toy
    learner = Learner(EvflyConfig(**_kw(tmp_path, data_path, ws_suffix="_host", N_eps=1)))
    learner.DEVICE_DATA_MAX_BYTES = 1
    with pytest.raises(RuntimeError, match="resident"):
        learner.train_loop()


def _trajectories(n, T, hw, seed):
    """write_h5_dataset's trajectory dicts from a numpy seed (as
    _toy_dataset's)."""
    rng = np.random.default_rng(seed)
    trajs = []
    for i in range(n):
        meta = np.zeros((T, 21), np.float32)
        meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 13] = np.arange(T), np.arange(T) * 0.03, 4, 4
        meta[:, 14] = rng.standard_normal(T) * 0.3
        trajs.append({"name": f"traj_{i:03d}", "data": meta, "desvel": meta[:, 2],
                      "ims": rng.random((T, *hw)).astype(np.float32),
                      "depths": rng.random((T, *hw)).astype(np.float32),
                      "evs": (rng.standard_normal((T - 1, *hw)) * 0.4).astype(np.float32)})
    return trajs


def test_dp_quality_runs_both_arms(tmp_path, monkeypatch):
    """tools/dp_quality at 2 synthetic trajectories x 1 epoch on the CPU
    (its subset of 3 of 14 frames; 190x190 frames, the smallest the joint
    model takes): both arms from one init, the JSON's tables."""
    from evfly_tpu_torch.tools import dp_quality

    trajs = dp_quality.subset(_trajectories(3, 14, (190, 190), seed=4), 2, 12)
    out = tmp_path / "dpq.json"
    monkeypatch.chdir(tmp_path)  # a relative work directory, as --tmp gives
    report = dp_quality.run_ab(trajs, "work", epochs=1, batch_size=4,
                               resize=(190, 190), device="cpu", out_json="dpq.json")
    saved = json.loads(out.read_text())
    assert saved == report
    for arm in ("sequential", "dp8_chunk"):
        assert len(report[arm]["ep_loss"]) == 1 and len(report[arm]["val_loss"]) == 1
        assert all(math.isfinite(v) for v in report[arm]["ep_loss"] + report[arm]["val_loss"])
    # the same init and data: the first validation (before any step) agrees
    np.testing.assert_allclose(report["sequential"]["val_loss"][0],
                               report["dp8_chunk"]["val_loss"][0], rtol=1e-5)
    assert os.path.isdir(tmp_path / "work")
