"""The port's data drivers (evfly_tpu_torch/tools/datagen.py, e2e_demo.py)
against the repo's JAX drivers (tools/datagen.py, tools/e2e_demo.py), on
the CPU, with the simulator stubbed in both packages by canned results:

- datagen: the trials' draws (forests, desired velocities, seeds, modes,
  command_every, obstacle_pad) equal, the trajectory dicts that reach
  write_h5_dataset equal key by key; with record_flow, each frame's exact
  flow against the JAX driver's (its jitted render_rgbd_flow over chunks
  of 64 frames) under the render's margin rule: away from the pixels
  where render_margins < RENDER_MARGIN, within the render test's flow
  bound (1e-3 + 1e-4 |f|, tests/test_torch_render.py) plus one f16 step
  of each value (2^-10 |f|: both drivers store f16);
- datagen without h5py raises ImportError before flying;
- e2e_demo: the training configuration equals the JAX driver's, and its
  data phase's cache_dataset is the one the Learner's dataloader hits.
"""

import os
import sys

import h5py  # noqa: F401  (the JAX driver writes h5)
import numpy as np
import pytest
import torch

import evfly_tpu.data.dataloading as j_dataloading
import evfly_tpu.sim.batched as j_batched
import evfly_tpu_torch.sim.batched as t_batched
from evfly_tpu_torch.sim import render
from evfly_tpu_torch.tools import datagen, e2e_demo

from torch_tools_cases import Recorder, canned_results, jax_tool
from torch_tools_cases import few_torch_threads, keep_precision  # noqa: F401  (fixtures)

CPU = torch.device("cpu")
FLOW_ATOL, FLOW_RTOL = 1e-3, 1e-4 + 2.0 ** -10


@pytest.fixture
def stubs(monkeypatch):
    recs = {"jax": Recorder(), "port": Recorder()}
    monkeypatch.setattr(j_batched, "run_trials_batched", recs["jax"])
    monkeypatch.setattr(t_batched, "run_trials_batched", recs["port"])
    written = []
    monkeypatch.setattr(j_dataloading, "write_h5_dataset", lambda path, t: written.append(t))
    return recs, written


def _jax_generate(kw, tmp_path):
    jdg = jax_tool("datagen")
    return jdg.generate(str(tmp_path / "j.h5"), **kw)


@pytest.mark.parametrize("kw", [
    dict(n_trials=5, batch=3, mode="state", seed=4),
    dict(n_trials=4, batch=4, mode="planner", seed=9, min_frames=25, trees=True),
], ids=["state", "planner"])
def test_datagen_trajectories_match_jax(stubs, tmp_path, kw):
    recs, written = stubs
    _jax_generate(kw, tmp_path)
    trajs = datagen.generate_trajectories(device=CPU, **kw)
    assert len(recs["jax"].calls) == len(recs["port"].calls) == -(-kw["n_trials"] // kw["batch"])
    for cj, ct in zip(recs["jax"].calls, recs["port"].calls):
        for fj, ft in zip(cj.pop("fields"), ct.pop("fields")):
            np.testing.assert_array_equal(fj.positions, ft.positions)
            np.testing.assert_array_equal(fj.radii, ft.radii)
        np.testing.assert_array_equal(cj.pop("desired_vels"), ct.pop("desired_vels"))
        assert ct.pop("device") == CPU
        assert cj == ct and ct["command_every"] == 3 and ct["obstacle_pad"] == 48
    (ref,) = written
    assert [t["name"] for t in trajs] == [t["name"] for t in ref] and len(trajs) >= 3
    for a, b in zip(trajs, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_datagen_flows_match_jax(stubs, tmp_path, monkeypatch):
    """record_flow on canned trajectories at 24x32 flying into the forest
    (x from 8 m): the port's per-frame render_rgbd_flow against the JAX
    driver's under the margin rule."""
    recs, written = stubs
    x0_results = lambda fields, **kw: canned_results(7, len(fields), T=34, x0=8.0)
    monkeypatch.setattr(j_batched, "run_trials_batched", x0_results)
    monkeypatch.setattr(t_batched, "run_trials_batched", x0_results)
    kw = dict(n_trials=2, batch=2, seed=3, record_flow=True)
    _jax_generate(kw, tmp_path)
    trajs = datagen.generate_trajectories(device=CPU, **kw)
    (ref,) = written
    assert len(trajs) == len(ref) == 1  # the second trial falls short of 30 frames
    got, want = trajs[0]["flows"], ref[0]["flows"]
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape == (34, 24, 32, 2)
    rng = np.random.default_rng(3)
    from evfly_tpu_torch.sim import generate_forest
    from evfly_tpu_torch.sim.batched import pad_fields

    field = generate_forest(rng, num_obstacles=int(rng.integers(25, 41)), trees=True)
    centers, radii = pad_fields([field], K_min=48, device=CPU)
    pos = np.asarray(trajs[0]["data"], np.float32)[:, 7:10]
    ok = render.render_margins(torch.as_tensor(pos), centers.expand(len(pos), -1, -1),
                               radii.expand(len(pos), -1), H=24, W=32, is_trees=True,
                               device=CPU).numpy() >= render.RENDER_MARGIN
    g, w = got.astype(np.float32)[ok], want.astype(np.float32)[ok]
    print(f"flows: {int((~ok).sum())} of {ok.size} pixels within the render's margin; "
          f"away from it max |diff| {np.abs(g - w).max():.3g}, max |flow| {np.abs(w).max():.3g}")
    assert (~ok).sum() < ok.size // 20 and np.abs(w).max() > 10
    np.testing.assert_allclose(g, w, rtol=FLOW_RTOL, atol=FLOW_ATOL)


def test_datagen_without_h5py_raises_before_flying(stubs, monkeypatch, tmp_path):
    recs, _ = stubs
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        datagen.main(["--out", str(tmp_path), "--trials", "2", "--device", "cpu"])
    assert recs["port"].calls == []


def test_e2e_train_config_matches_jax(tmp_path, monkeypatch):
    import evfly_tpu.train.learner as j_learner

    je2e = jax_tool("e2e_demo")
    seen = []

    class Stop(Exception):
        pass

    def capture(cfg, *a, **k):
        seen.append(cfg)
        raise Stop

    monkeypatch.setattr(j_learner, "Learner", capture)
    with pytest.raises(Stop):
        je2e.phase_train(str(tmp_path), 12)
    ref = seen[0].to_dict()
    got = e2e_demo.train_config(str(tmp_path), 12).to_dict()
    assert got == ref


def test_e2e_data_phase_feeds_the_learner_cache(tmp_path, monkeypatch):
    """phase_data's trials (stubbed run_trial: canned 260x346 trials)
    through cache_dataset; the Learner of train_config takes the cache
    hit with no h5 file."""
    import evfly_tpu_torch.sim as t_sim

    calls = []

    def trial(field, **kw):
        calls.append(kw)
        return canned_results(len(calls), 1, T=33, H=260, W=346)[0]

    monkeypatch.setattr(t_sim, "run_trial", trial)
    stamp = e2e_demo.phase_data(str(tmp_path), 2, device=CPU)
    assert os.path.exists(stamp) and not os.path.exists(stamp[: -len(".stat.json")])
    assert [c["mode"] for c in calls] == ["state", "state"]
    assert e2e_demo.phase_data(str(tmp_path), 2, device=CPU) == stamp and len(calls) == 2
    from evfly_tpu_torch.train.learner import Learner

    learner = Learner(e2e_demo.train_config(str(tmp_path), 1), device=CPU)
    log = open(os.path.join(learner.workspace, "log.txt")).read()
    assert "Cache hit" in log
