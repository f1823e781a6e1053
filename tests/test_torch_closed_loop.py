"""The port's closed loop (evfly_tpu_torch/sim/closed_loop.py, batched.py,
launch_evaluation.py) against the JAX package's, at 40x52 on the CPU.

- state and planner modes over whole short trials (900 sim steps, as
  tests/test_batched_rollout.py holds JAX against itself; 500 with the
  rigid body and the planner): the expert is
  numpy, so the logs agree to 1e-6 and the summaries are equal, for the
  first-order and the rigid-body dynamics;
- the logged frames under the render's margin rule: recomputed at each
  tick's logged (f32) position, a frame differs from JAX's only at pixels
  within RENDER_MARGIN of a render step in this tick (or the previous one,
  for events), within 1e-5 of a difflog quantization crossing, and depth
  by at most one u8 step;
- vision and dagger modes over their first 20 ticks, with one deterministic
  policy stub in each package (a numpy map from the frame and a carried
  state to a velocity, behind step_frame/step_frames/reset), so that the
  loop's own semantics (the reset below x = 0.5 m, the start ramp, the
  altitude hold, the reset mask) are held without the joint model: logs
  within 1e-4 and the same resets;
- run_evaluation's files, against JAX's with both run_trials at 40x52.
"""

import functools

import numpy as np
import pytest
import torch

from evfly_tpu.sim import batched as j_batched
from evfly_tpu.sim import closed_loop as j_closed
from evfly_tpu.sim import launch_evaluation as j_launch
from evfly_tpu.sim.obstacles import generate_forest
from evfly_tpu_torch.ops.voxelizer import difflog_margins
from evfly_tpu_torch.sim import batched as t_batched
from evfly_tpu_torch.sim import closed_loop as t_closed
from evfly_tpu_torch.sim import launch_evaluation as t_launch
from evfly_tpu_torch.sim import render

H, W = 40, 52
CPU = "cpu"
STEPS = 900
RIGID_STEPS = 500  # the rigid body's RK4 and controller step slowly in numpy
VISION_TICKS = 20


def _fields(n=2, seed=5, num=12):
    rng = np.random.default_rng(seed)
    return [generate_forest(rng, num_obstacles=num, trees=True) for _ in range(n)]


def _padded(field):
    c = np.concatenate([field.positions.reshape(-1, 3), [[1e6, 1e6, 1e6]]]).astype(np.float32)
    return c, np.concatenate([field.radii, [0.0]]).astype(np.float32)


def _assert_logs(got, ref, atol):
    assert got["summary"] == ref["summary"]
    assert got["log"].shape == ref["log"].shape and len(got["log"]) > 0
    np.testing.assert_allclose(got["log"], ref["log"], rtol=0, atol=atol)


def _assert_frames(got, ref, field, quantized):
    """Frames of one trial equal away from the render's and difflog's
    margins (recomputed at the logged positions); depth within one u8 step
    where quantized."""
    n = len(ref["depths"])
    assert len(got["depths"]) == len(got["events"]) == n > 1
    c, r = _padded(field)
    pos = got["log"][:n, 7:10]
    margin = render.render_margins(pos, np.broadcast_to(c, (n, *c.shape)).copy(),
                                   np.broadcast_to(r, (n, *r.shape)).copy(), H=H, W=W,
                                   is_trees=field.is_trees, device=CPU).numpy()
    ok = margin >= render.RENDER_MARGIN
    _, inten = render.render_depth_intensity(pos, np.broadcast_to(c, (n, *c.shape)).copy(),
                                   np.broadcast_to(r, (n, *r.shape)).copy(), H=H, W=W,
                                   is_trees=field.is_trees, device=CPU)
    ev_ok = ok[1:] & ok[:-1] & (difflog_margins(inten[1:], inten[:-1], device=CPU).numpy()
                                >= 1e-5)
    depth_step = 1.0 / 255.0 + 1e-6 if quantized else 3e-5
    for name, keep, atol in (("depths", ok, depth_step), ("intensities", ok, 5e-6),
                             ("events", ev_ok, 0.0)):
        g, rf = np.stack(got[name]), np.stack(ref[name])
        if name == "events":
            g, rf = g[1:], rf[1:]  # the first frame has no previous one
        assert g.shape == rf.shape
        np.testing.assert_allclose(g[keep], rf[keep], rtol=0, atol=atol, err_msg=name)
    print(f"frames: {int((~ok).sum())} of {ok.size} pixels within the render's margin")


@pytest.mark.parametrize("dynamics", ["velocity", "rigid"])
def test_run_trial_state_matches_jax(dynamics):
    field = _fields(1, seed=5)[0]
    kw = dict(mode="state", policy_every=6, H=H, W=W, dynamics=dynamics,
              max_steps=RIGID_STEPS if dynamics == "rigid" else STEPS)
    ref = j_closed.run_trial(field, rng=np.random.default_rng(11), **kw)
    got = t_closed.run_trial(field, rng=np.random.default_rng(11), device=CPU, **kw)
    _assert_logs(got, ref, 1e-6)
    _assert_frames(got, ref, field, quantized=False)
    traj_j = j_closed.rollout_to_trajectory(ref, "t")
    traj_t = t_closed.rollout_to_trajectory(got, "t")
    assert traj_t.keys() == traj_j.keys()
    for k in ("data", "desvel"):
        np.testing.assert_allclose(traj_t[k], traj_j[k], rtol=0, atol=1e-6)
    assert traj_t["evs"].shape == traj_j["evs"].shape


@pytest.mark.parametrize("mode,dynamics", [("state", "first_order"), ("state", "rigid"),
                                           ("planner", "first_order")])
def test_run_trials_batched_matches_jax(mode, dynamics):
    fields = _fields(2, seed=5)
    kw = dict(mode=mode, desired_vels=[4.0, 3.5], policy_every=6, command_every=3,
              max_steps=STEPS if mode == "state" and dynamics == "first_order" else RIGID_STEPS,
              H=H, W=W, seed=11, dynamics=dynamics, fetch_every=7)
    ref = j_batched.run_trials_batched(fields, **kw)
    got = t_batched.run_trials_batched(fields, device=CPU, **kw)
    for g, field in enumerate(fields):
        _assert_logs(got[g], ref[g], 1e-6)
        _assert_frames(got[g], ref[g], field, quantized=True)


def test_batched_state_matches_run_trial():
    """Within the port: a batched trial reproduces run_trial's (the
    expert depends on position and its per-trial rng only)."""
    fields = _fields(2, seed=8)
    batched = t_batched.run_trials_batched(fields, mode="state", policy_every=6,
                                           max_steps=STEPS, H=H, W=W, seed=3,
                                           log_images=False, device=CPU)
    for g, field in enumerate(fields):
        single = t_closed.run_trial(field, mode="state", policy_every=6, max_steps=STEPS, H=H,
                                    W=W, rng=np.random.default_rng(3 + 977 * g),
                                    log_images=False, device=CPU)
        assert batched[g]["summary"] == single["summary"]
        bl, sl = batched[g]["log"], single["log"]
        np.testing.assert_allclose(bl[:, 1:3], sl[:, 1:3], atol=1e-6)
        np.testing.assert_allclose(bl[:, 7:16], sl[:, 7:16], atol=1e-5)
        np.testing.assert_array_equal(bl[:, 20], sl[:, 20])


def test_batched_quads_match_jax():
    rng = np.random.default_rng(0)
    qj, qt = j_batched.BatchedQuads(3), t_batched.BatchedQuads(3)
    for step in range(60):
        if step % 7 == 0:
            cmds, mask = rng.normal(size=(3, 3)) * 3, rng.random(3) < 0.6
            qj.set_commands(cmds, mask)
            qt.set_commands(cmds, mask)
        for a, b in zip(qj.step(0.01), qt.step(0.01)):
            np.testing.assert_array_equal(a, b)


def _stub_velocity(frame: np.ndarray, h: float):
    """The policy stub: the frame's mean and its left-right balance, and a
    carried state h -> (velocity (3,), new h)."""
    cols = np.linspace(-1.0, 1.0, frame.shape[-1])
    m = float(frame.mean())
    s = float((frame * cols).mean())
    h = 0.8 * h + m
    return np.array([3.0 + 0.5 * np.tanh(5.0 * m), 2.0 * np.tanh(20.0 * s) + 0.3 * np.tanh(h),
                     0.7]), h


class _Stub:
    """step_frame/step_frames/reset around _stub_velocity for G streams;
    ``host`` turns a package's frame into numpy."""

    def __init__(self, host, G=1):
        self.host, self.h, self.resets = host, np.zeros(G), []

    def reset(self):
        self.h[:] = 0.0
        self.resets.append(-1)

    def step_frame(self, frame):
        v, self.h[0] = _stub_velocity(self.host(frame), self.h[0])
        return v, None

    def step_frames(self, frames, reset_mask=None):
        frames = self.host(frames)
        if reset_mask is not None:
            mask = np.asarray(reset_mask, bool)
            self.h[mask] = 0.0
            self.resets.append(tuple(np.flatnonzero(mask)))
        vels = np.zeros((len(self.h), 3))
        for g in range(len(self.h)):
            vels[g], self.h[g] = _stub_velocity(frames[g], self.h[g])
        return vels, None


def _jax_host(x):
    return np.asarray(x, np.float64)


def _torch_host(x):
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    return x.double().numpy()


@pytest.mark.parametrize("dynamics", ["velocity", "rigid"])
def test_run_trial_vision_first_ticks_match_jax(dynamics):
    field = _fields(1, seed=6, num=20)[0]
    kw = dict(mode="vision", policy_every=3, max_steps=3 * VISION_TICKS, H=H, W=W,
              dynamics=dynamics)
    pj, pt = _Stub(_jax_host), _Stub(_torch_host)
    ref = j_closed.run_trial(field, policy=pj, **kw)
    got = t_closed.run_trial(field, policy=pt, device=CPU, **kw)
    assert len(got["log"]) == VISION_TICKS
    _assert_logs(got, ref, 1e-4)
    assert pt.resets == pj.resets and len(pt.resets) > 1
    # the ramp and the altitude hold: x below 2 m, z from the hold
    log = got["log"]
    np.testing.assert_allclose(log[:, 15], 1.5 * (2.0 - log[:, 9]), atol=1e-6)
    assert (log[log[:, 7] < 2.0, 13] >= 1.0).all()


@pytest.mark.parametrize("mode", ["vision", "dagger"])
def test_run_trials_batched_vision_first_ticks_match_jax(mode):
    fields = _fields(3, seed=9, num=20)
    kw = dict(mode=mode, desired_vels=[4.0, 3.0, 5.0], policy_every=6,
              max_steps=6 * VISION_TICKS, H=H, W=W, seed=2, fetch_every=4)
    pj, pt = _Stub(_jax_host, 3), _Stub(_torch_host, 3)
    ref = j_batched.run_trials_batched(fields, policy=pj, **kw)
    got = t_batched.run_trials_batched(fields, policy=pt, device=CPU, **kw)
    assert pt.resets == pj.resets and any(pt.resets)
    for g, field in enumerate(fields):
        assert len(got[g]["log"]) == VISION_TICKS
        _assert_logs(got[g], ref[g], 1e-4)
        _assert_frames(got[g], ref[g], field, quantized=True)


def test_run_evaluation_files_match_jax(tmp_path, monkeypatch):
    """Both packages' run_evaluation, run_trial at 40x52, state mode:
    every file equal."""
    monkeypatch.setattr(j_launch, "run_trial", functools.partial(j_closed.run_trial, H=H, W=W))
    monkeypatch.setattr(t_launch, "run_trial", functools.partial(t_closed.run_trial, H=H, W=W))
    kw = dict(n_trials=2, mode="state", num_obstacles=15, max_steps=300, make_plots=False)
    ref = j_launch.run_evaluation(out_dir=str(tmp_path / "jax"), **kw)
    got = t_launch.run_evaluation(out_dir=str(tmp_path / "port"), device=CPU, **kw)
    assert got == ref
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert {"rollout_000/path.csv", "rollout_001/dist.csv", "rollout_001/scalarMetrics.dat",
            "rollout_000/static_obstacles.csv"} <= {str(f) for f in files}
    for f in files:
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text(), f


def test_run_evaluation_vision_and_cli(tmp_path, monkeypatch):
    """Vision mode with a policy factory writes every trial's files; the
    command line runs state trials on the CPU."""
    monkeypatch.setattr(t_launch, "run_trial", functools.partial(t_closed.run_trial, H=H, W=W))
    made = []
    out = t_launch.run_evaluation(
        2, mode="vision", policy_factory=lambda: made.append(_Stub(_torch_host)) or made[-1],
        out_dir=str(tmp_path / "vision"), max_steps=90, make_plots=False, device=CPU)
    assert len(made) == 2 and set(out) == {"rollout_000", "rollout_001"}
    for trial in out:
        path = np.loadtxt(tmp_path / "vision" / trial / "path.csv", delimiter=",")
        assert path.shape[1] == 4 and len(path) > 10
    summaries = t_launch.main(["--trials", "1", "--max_steps", "60", "--device", "cpu",
                               "--out_dir", str(tmp_path / "cli")])
    assert set(summaries) == {"rollout_000"}
    assert (tmp_path / "cli" / "rollout_000" / "scalarMetrics.dat").exists()
