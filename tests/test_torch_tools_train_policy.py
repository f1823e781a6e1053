"""The port's policy driver (evfly_tpu_torch/tools/train_policy.py) against
the repo's JAX driver (tools/train_policy.py), on the CPU, with the
simulator and the pipeline stubbed in both packages (``run_trials_batched``
records its arguments and returns canned results; ``_build_pipeline`` and
``_train`` record what they are given):

- the protocol's draws, call for call, at the JAX record's settings (seed
  91000, 40 trials, batches of 20) and for dagger: the forests (centers,
  radii, is_trees), desired velocities, seeds, policy_every, max_steps,
  obstacle_pad, log_images and dynamics equal exactly;
- the eval report of the same canned results equal key for key, and
  dagger's h5 files equal dataset for dataset;
- the training configurations of pretrain_v, pretrain_d, joint (--resume,
  --d-ckpt/--v-ckpt) and scratch equal field by field, and ``_as_epoch0``'s
  file the same name and bytes.
"""

import json
import sys

import h5py
import numpy as np
import pytest
import torch

import evfly_tpu.sim.batched as j_batched
import evfly_tpu_torch.sim.batched as t_batched
from evfly_tpu_torch.tools import train_policy as tp

from torch_tools_cases import Recorder, jax_tool
from torch_tools_cases import few_torch_threads, keep_precision  # noqa: F401  (fixtures)

CPU = torch.device("cpu")


@pytest.fixture
def drivers(tmp_path, monkeypatch):
    """(JAX driver, port driver), both writing under tmp_path, their
    run_trials_batched and _build_pipeline stubbed."""
    jtp = jax_tool("train_policy")
    recs = {"jax": Recorder(), "port": Recorder()}
    monkeypatch.setattr(j_batched, "run_trials_batched", recs["jax"])
    monkeypatch.setattr(t_batched, "run_trials_batched", recs["port"])
    built = {"jax": [], "port": []}
    monkeypatch.setattr(jtp, "_build_pipeline", lambda *a: built["jax"].append(a) or "jax-pipe")
    monkeypatch.setattr(tp, "_build_pipeline",
                        lambda *a: built["port"].append(a) or "port-pipe")
    for mod, sub in ((jtp, "jax"), (tp, "port")):
        monkeypatch.setattr(mod, "OUT", str(tmp_path / sub))
        (tmp_path / sub).mkdir()
    return jtp, recs, built


def _run_jax(jtp, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["train_policy.py"] + argv)
    return jtp.main()


def _assert_same_calls(recs, built, policy):
    assert len(recs["jax"].calls) == len(recs["port"].calls) > 0
    for cj, ct in zip(recs["jax"].calls, recs["port"].calls):
        assert len(cj["fields"]) == len(ct["fields"])
        for fj, ft in zip(cj.pop("fields"), ct.pop("fields")):
            np.testing.assert_array_equal(fj.positions, ft.positions)
            np.testing.assert_array_equal(fj.radii, ft.radii)
            assert fj.is_trees == ft.is_trees is True
        np.testing.assert_array_equal(cj.pop("desired_vels"), ct.pop("desired_vels"))
        assert cj.pop("policy") == "jax-pipe" and ct.pop("policy") == "port-pipe"
        assert ct.pop("device") == CPU
        assert cj == ct
        assert ct["policy_every"] == 6 and ct["max_steps"] == 7000 and ct["obstacle_pad"] == 48
    for bj, bt in zip(built["jax"], built["port"]):
        assert bj[:2] == bt[:2]
        np.testing.assert_array_equal(bj[2], bt[2])


def test_eval_protocol_draws_and_report_match_jax(drivers, monkeypatch, tmp_path):
    """The JAX record's evaluation: seed 91000, 40 trials in batches of 20."""
    jtp, recs, built = drivers
    common = ["--ckpt", "policy_best.pth", "--trials", "40", "--batch", "20", "--seed",
              "91000"]
    _run_jax(jtp, monkeypatch, ["eval", *common, "--out-json", str(tmp_path / "j.json")])
    report = tp.main(["eval", *common, "--out-json", str(tmp_path / "t.json"),
                      "--device", "cpu"])
    assert [len(c["fields"]) for c in recs["port"].calls] == [20, 20]
    assert [c["seed"] for c in recs["port"].calls] == [91000, 91020]
    assert all(c["mode"] == "vision" and c["log_images"] is False
               and c["dynamics"] == "first_order" for c in recs["port"].calls)
    _assert_same_calls(recs, built, "vision")
    ref = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == ref == json.loads(json.dumps(report))
    assert 0 < got["success_rate"] < 1 and len(got["summaries"]) == 40


@pytest.mark.parametrize("dynamics", ["first_order", "rigid"])
def test_eval_rigid_and_ragged_batch_match_jax(drivers, monkeypatch, tmp_path, dynamics):
    jtp, recs, built = drivers
    common = ["--ckpt", "c.pth", "--trials", "7", "--batch", "3", "--seed", "5",
              "--desvel", "3.5", "--dynamics", dynamics]
    _run_jax(jtp, monkeypatch, ["eval", *common, "--out-json", str(tmp_path / "j.json")])
    tp.main(["eval", *common, "--out-json", str(tmp_path / "t.json"), "--device", "cpu"])
    assert [len(c["fields"]) for c in recs["port"].calls] == [3, 3, 1]
    _assert_same_calls(recs, built, "vision")
    assert (json.loads((tmp_path / "j.json").read_text())
            == json.loads((tmp_path / "t.json").read_text()))


def test_dagger_draws_and_h5_match_jax(drivers, monkeypatch, tmp_path):
    jtp, recs, built = drivers
    common = ["--ckpt", "c.pth", "--trials", "6", "--batch", "4", "--seed", "50000",
              "--name", "dagger_t"]
    (tmp_path / "jax" / "data" / "datasets").mkdir(parents=True)  # the JAX driver makes none
    _run_jax(jtp, monkeypatch, ["dagger", *common])
    h5 = tp.main(["dagger", *common, "--device", "cpu"])
    assert all(c["mode"] == "dagger" and c["log_images"] is True for c in recs["port"].calls)
    _assert_same_calls(recs, built, "dagger")
    ref_path = tmp_path / "jax" / "data" / "datasets" / "dagger_t.h5"
    assert h5 == str(tmp_path / "port" / "data" / "datasets" / "dagger_t.h5")
    with h5py.File(ref_path, "r") as fj, h5py.File(h5, "r") as ft:
        assert sorted(fj.keys()) == sorted(ft.keys()) and len(ft.keys()) == 4
        for name in fj:
            assert sorted(fj[name].keys()) == sorted(ft[name].keys())
            for key in fj[name]:
                np.testing.assert_array_equal(fj[name][key][()], ft[name][key][()])
            assert (ft[name]["data"][()][:, -1] == 0).all()


def test_dagger_trajectories_clear_collisions():
    from torch_tools_cases import canned_results

    results = canned_results(3, 4)
    trajs = tp.dagger_trajectories(results)
    assert [t["name"] for t in trajs] == ["dagger_0000", "dagger_0002", "dagger_0003"]
    assert all((t["data"][:, -1] == 0).all() for t in trajs)


def test_dagger_without_h5py_raises_before_flying(drivers, monkeypatch):
    _, recs, _ = drivers
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tp.main(["dagger", "--ckpt", "c.pth", "--trials", "2", "--device", "cpu"])
    assert recs["port"].calls == []


def _configs(jtp, monkeypatch, argv):
    got = {}
    monkeypatch.setattr(jtp, "_train", lambda cfg: got.setdefault("jax", cfg))
    monkeypatch.setattr(tp, "_train", lambda cfg, device=None: got.setdefault("port", (cfg,
                                                                                   device)))
    _run_jax(jtp, monkeypatch, argv)
    tp.main(argv + ["--device", "cpu"])
    cfg, device = got["port"]
    assert device == CPU
    return got["jax"].to_dict(), cfg.to_dict()


@pytest.mark.parametrize("argv", [
    ["pretrain_v"],
    ["pretrain_v", "--epochs", "3", "--lr", "3e-4", "--init", "{ckpt}"],
    ["pretrain_d"],
    ["pretrain_d", "--epochs", "5", "--init", "{ckpt}"],
    ["joint"],
    ["joint", "--epochs", "4", "--resume", "{ckpt}", "--extra-data", "dagger_r1", "dagger_r2"],
    ["joint", "--d-ckpt", "{ckpt}", "--v-ckpt", "{ckpt}", "--lr", "1e-3", "--logsub", "j2"],
    ["scratch", "--epochs", "2"],
], ids=["pretrain_v", "pretrain_v_init", "pretrain_d", "pretrain_d_init", "joint",
        "joint_resume", "joint_d_v", "scratch"])
def test_training_configs_match_jax(drivers, monkeypatch, tmp_path, argv):
    jtp = drivers[0]
    ckpt = tmp_path / "model_ep000007.pth"
    torch.save({"w": torch.arange(3.0)}, ckpt)
    argv = [a.format(ckpt=ckpt) for a in argv]
    ref, got = _configs(jtp, monkeypatch, argv)
    # the output root differs (each driver's OUT); every other field is equal
    for key in ("basedir", "datadir", "checkpoint_path"):
        ref[key] = json.loads(json.dumps(ref[key]).replace(str(tmp_path / "jax"), "OUT"))
        got[key] = json.loads(json.dumps(got[key]).replace(str(tmp_path / "port"), "OUT"))
    assert got == ref
    assert got["model_type"] and got["N_eps"] >= 2


def test_as_epoch0_same_file(drivers, tmp_path):
    jtp = drivers[0]
    ckpt = tmp_path / "pretrain_model_ep000012.pth"
    torch.save({"a": torch.ones(2)}, ckpt)
    ref, got = jtp._as_epoch0(str(ckpt), "d"), tp._as_epoch0(str(ckpt), "d")
    assert ref.rsplit("/", 1)[1] == got.rsplit("/", 1)[1] == "combine_d_model_ep000000.pth"
    assert open(ref, "rb").read() == open(got, "rb").read()


def test_policy_loads_into_a_batched_pipeline_on_cpu():
    """policy_best.pth through load_policy and _build_pipeline's pipeline,
    one step of two streams at 260x346, f32 on the CPU."""
    from evfly_tpu_torch.stream.pipeline import BatchedStreamingPipeline

    model = tp.load_policy(str(tp.REPO) + "/artifacts/policy_best.pth", CPU)
    pipe = BatchedStreamingPipeline(model, 2, desvel=np.full(2, 4.0), device=CPU)
    frames = torch.zeros(2, 260, 346)
    frames[:, 100:140, 150:200] = 0.6
    vel, depth = pipe.step_frames(frames)
    assert vel.shape == (2, 3) and depth.shape == (2, 260, 346)
    assert torch.isfinite(vel).all() and torch.equal(vel[0], vel[1])
