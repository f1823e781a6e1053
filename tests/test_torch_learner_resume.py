"""The port's Learner on its own, on the CPU: resume (the LR schedule, as
the JAX Learner's ``lr_scheduler`` gives it, and the best tracking
continue), a composite resumed from its own snapshot, the checkpoint
helpers against the JAX package's, the device rule (the card unless the
config or the caller says cpu), data parallelism refused, and the CLI.
The runs against the JAX Learner are in tests/test_torch_learner.py.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from evfly_tpu.configs import EvflyConfig as JaxConfig
from evfly_tpu.models import port as jport
from evfly_tpu.train.learner import Learner as JaxLearner
from evfly_tpu_torch.configs import EvflyConfig
from evfly_tpu_torch.models import port
from evfly_tpu_torch.train.learner import Learner
from test_torch_learner import LR, _composite_kw, _kw, _toy_dataset, parts  # noqa: F401
from torch_train_cases import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_resume_continues_the_lr_schedule_and_best_tracking(tmp_path):
    data_path = _toy_dataset(tmp_path, np.random.default_rng(1), n_traj=4, T=6)
    kw = _kw(tmp_path, data_path, N_eps=2, lr_warmup_epochs=2)
    first = Learner(EvflyConfig(**kw))
    first.train_loop()  # 2 epochs = 4 iterations; the last checkpoint is model_ep000001
    ckpt = sorted(glob.glob(os.path.join(first.workspace, "model_ep*.pth")))[-1]

    kw2 = _kw(tmp_path, data_path, N_eps=1, lr_warmup_epochs=2, checkpoint_path=[ckpt],
              load_trainval=True)
    resumed = Learner(EvflyConfig(**kw2))
    assert resumed.num_eps_trained == 1 and resumed.train.dirs == first.train.dirs
    assert resumed.total_its == resumed.num_eps_trained * resumed.num_training_steps
    resumed.train_loop()
    # the last step ran at global it 3 of the 4-it warm-up, as the JAX
    # Learner's schedule gives it
    jl = JaxLearner(JaxConfig(**{**kw2, "ws_suffix": "_jax"}), no_model=True)
    expected = jl.lr_scheduler(3)
    np.testing.assert_allclose(expected, 0.1 * LR + 0.9 * LR * 3 / 4, rtol=1e-12)
    assert resumed.optimizer.param_groups[0]["lr"] == expected == resumed._last_lr

    resumed.lowest_val_loss = [0.0] * len(resumed.lowest_val_loss)
    n_best = len(glob.glob(os.path.join(resumed.workspace, "model_best*.pth")))
    resumed.validation(resumed.num_eps_trained)
    assert all(v == 0.0 for v in resumed.lowest_val_loss)
    assert len(glob.glob(os.path.join(resumed.workspace, "model_best*.pth"))) == n_best


def test_composite_resumes_from_its_own_snapshot(tmp_path, parts):
    cp0, cp1, _, _ = parts
    first = Learner(EvflyConfig(**_composite_kw(tmp_path, checkpoint_path=[cp0, cp1],
                                                combine_checkpoints=True)))
    first.save_model(3)
    snap = os.path.join(first.workspace, "model_ep000003.pth")
    again = Learner(EvflyConfig(**_composite_kw(tmp_path, checkpoint_path=[snap],
                                                ws_suffix="_again")))
    assert again.num_eps_trained == 3
    assert all(torch.equal(v, first.params[k]) for k, v in again.params.items())


def test_checkpoint_helpers_match_jax():
    rng = np.random.default_rng(9)
    a = {"x": rng.normal(size=3).astype(np.float32), "y": np.ones(2, np.float32)}
    b = {"x": np.zeros(3, np.float32), "z": np.arange(4).astype(np.float32)}
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    for names in (None, ["m0", "m1"]):
        ref = jport.combine_state_dicts([a, b], names)
        got = port.combine_state_dicts([t(a), t(b)], names)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), ref[k])
    params = {"p.x": torch.zeros(3), "p.y": torch.zeros(2), "q": torch.zeros(1)}
    got = port.load_into(params, t(a), prefix="p.")
    assert torch.equal(got["p.x"], torch.from_numpy(a["x"])) and torch.equal(got["q"], params["q"])
    with pytest.raises(KeyError):
        port.load_into(params, t(a), strict=True, prefix="p.")
    with pytest.raises(ValueError, match="shape"):
        port.load_into({"x": torch.zeros(2)}, t(a))
    for path in ("ws/model_ep000012.pth", "ws/model_best_ep000007.pth", "start.pth", "", None):
        assert port.parse_epoch_from_path(path) == jport.parse_epoch_from_path(path)


def test_learner_runs_on_the_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(basedir=str(tmp_path), logdir="logs", dataset=None, model_type=["LSTMNetVIT"])
    for device in ("tpu", "gpu", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Learner(EvflyConfig(device=device, **kw), no_model=True)
    assert Learner(EvflyConfig(device="cpu", **kw)).device == torch.device("cpu")
    assert Learner(EvflyConfig(**kw), device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="device"):
        Learner(EvflyConfig(device="metal", **kw))


def test_data_parallel_raises_until_ported(tmp_path):
    data_path = _toy_dataset(tmp_path, np.random.default_rng(2), n_traj=2, T=4, hw=(60, 90))
    learner = Learner(EvflyConfig(**_kw(tmp_path, data_path, model_type=["LSTMNetVIT"],
                                        resize_input=None, dp_devices=2)))
    # ported: dp_devices > 1 without a process group of 2 raises with how
    # to launch one
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=2"):
        learner.train_loop()


def test_cli_trains_on_cpu_and_refuses_without_a_card(tmp_path):
    """The V(phi) pretraining configuration of tools/train_policy.py (depth
    in, input_frame_scale 2, quantized residency) through the CLI."""
    data_path = _toy_dataset(tmp_path, np.random.default_rng(3), n_traj=2, T=5, hw=(60, 90))
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(
        f"basedir = {tmp_path}\nlogdir = logs\ndataset = [{data_path}]\nuse_h5 = True\n"
        "events = evs_frames\nkeep_collisions = True\nseed = 3\nval_split = 0.5\n"
        "batch_size = 2\nmodel_type = VITFLY_ViTLSTM\nN_eps = 1\nlr_warmup_epochs = 0\n"
        "save_model_freq = 1\nval_freq = 1\nloss_weights = [1.0, 0.0]\n"
        "optional_loss_param = [5.0, 0.0]\nrescale_evs = -1.0\ndevice = tpu\n"
        "num_in_channels = 1\ninput_frame_scale = 2.0\ndevice_data_quantized = True\n")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    run = lambda *extra: subprocess.run(
        [sys.executable, "-m", "evfly_tpu_torch.train", "--config", str(cfg), *extra],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    refused = run()
    assert refused.returncode != 0 and "CUDA" in refused.stderr
    done = run("--device", "cpu")
    assert done.returncode == 0, done.stderr[-2000:]
    ws = glob.glob(str(tmp_path / "logs" / "d*"))
    assert len(ws) == 1  # the refused run stopped before making a workspace
    ckpts = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ws[0], "*.pth")))
    assert "model_ep000000.pth" in ckpts
    assert os.path.exists(os.path.join(ws[0], "config.txt"))


def test_eval_tools_plot_and_gifs_and_log_without_matplotlib(tmp_path, monkeypatch):
    """evaluation_tools runs the model through run_model: eval_plotter's
    figure and visualize_images' gifs; without matplotlib, eval_tools logs
    and returns, as the JAX Learner's."""
    import builtins

    from evfly_tpu_torch.train.evaluation_tools import eval_plotter, visualize_images

    data_path = _toy_dataset(tmp_path, np.random.default_rng(4), n_traj=4, T=6)
    learner = Learner(EvflyConfig(**_kw(tmp_path, data_path, N_eps=0)))
    learner.save_model(0)
    ckpt = os.path.join(learner.workspace, "model_ep000000.pth")
    fig, title = eval_plotter(learner, ckpt, load_ckpt=True, dataSetstoTest=2)
    out = os.path.join(learner.workspace, "plot.png")
    fig.savefig(out)
    assert title and os.path.getsize(out) > 0
    gifs = visualize_images(learner, ckpt, load_ckpt=False)
    assert gifs and all(os.path.getsize(g) > 0 for g in gifs)

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("matplotlib is not installed")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    logged = []
    monkeypatch.setattr(learner, "mylogger", logged.append)
    learner.eval_tools(0)
    assert any("eval_tools unavailable" in m for m in logged)
