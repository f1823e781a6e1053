"""The port's flight-stack core and hardware-in-the-loop harness.

- ``sim.native_quad.NativeFlightCore`` (the port's copy of
  ``flightcore.cpp``, built into ``build/`` at its first use) against the
  JAX package's numpy rigid body (``evfly_tpu.sim.rigid_body``) under
  random velocity commands, at tests/test_flightcore.py's tolerance
  (relative 1e-7, absolute 1e-8 over 600 steps: the two solve the motor
  allocation differently); ``run_batch`` equal to per-step calls; reset.
  The JAX package's own ``libflightcore.so`` is not loaded here.
- The copies of ``sim/dynamics.py`` and ``sim/pilot.py`` against the
  originals on the same commands: equal.
- ``stream.hil.run_hil_episode`` with a scripted pipeline holds
  tests/test_hil.py's assertions (tracking, deadman, latched safety box,
  the pilot-flown episode).
- On a CUDA card (``gpu`` marker, skipped here): an episode with the joint
  model's ``StreamingPipeline`` replaying graphs, each tick's velocity
  within 1e-4 of an eager run on the plain path.
"""

import numpy as np
import pytest
import torch

from evfly_tpu.sim import dynamics as jdynamics
from evfly_tpu.sim import pilot as jpilot
from evfly_tpu.sim.rigid_body import RigidBodyQuad
from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.recurrent import set_fused_lstm
from evfly_tpu_torch.sim import dynamics, pilot
from evfly_tpu_torch.sim.native_quad import NativeFlightCore
from evfly_tpu_torch.stream import SafetyConfig, StreamingPipeline
from evfly_tpu_torch.stream.hil import HILResult, run_hil_episode
from torch_helpers import cuda_device  # noqa: F401 (fixture)


def test_native_matches_numpy_random_commands():
    """600 steps of random velocity commands: the port's native core against
    the JAX package's numpy rigid body."""
    quad = RigidBodyQuad(start_pos=(0, 0, 2.0))
    native = NativeFlightCore(start_pos=(0, 0, 2.0))
    rng = np.random.default_rng(3)
    dt = 0.01
    for i in range(600):
        if i % 6 == 0:
            cmd = rng.uniform(-3, 4, 3) * np.array([1, 1, 0.3])
            quad.set_velocity_command(cmd)
            native.set_velocity_command(cmd)
        s_py = quad.step(dt)
        s_cc = native.step(dt)
        np.testing.assert_allclose(s_cc.pos, s_py.pos, rtol=1e-7, atol=1e-8)
        np.testing.assert_allclose(s_cc.vel, s_py.vel, rtol=1e-7, atol=1e-8)
        np.testing.assert_allclose(s_cc.att, quad.q, rtol=1e-7, atol=1e-8)


def test_native_run_batch_matches_per_step():
    a = NativeFlightCore(start_pos=(0, 0, 2.0))
    b = NativeFlightCore(start_pos=(0, 0, 2.0))
    rng = np.random.default_rng(0)
    cmds = rng.uniform(-2, 3, (5, 3))
    hist = a.run_batch(0.01, cmds, cmd_every=20, n_steps=100)
    for i in range(100):
        if i % 20 == 0:
            b.set_velocity_command(cmds[min(i // 20, len(cmds) - 1)])
        s = b.step(0.01)
    np.testing.assert_allclose(hist[-1, 1:4], s.pos, atol=1e-12)
    np.testing.assert_allclose(hist[-1, 4:7], s.vel, atol=1e-12)
    assert hist.shape == (100, 14) and np.all(np.isfinite(hist))


def test_native_reset():
    native = NativeFlightCore(start_pos=(0, 0, 2.0))
    native.set_velocity_command([3.0, 0, 0])
    for _ in range(100):
        native.step(0.01)
    assert native.state.pos[0] > 0.5
    native.reset((1.0, -1.0, 3.0))
    s = native.state
    np.testing.assert_allclose(s.pos, [1.0, -1.0, 3.0])
    np.testing.assert_allclose(s.vel, 0.0)
    assert s.t == 0.0


def test_velocity_tracking_copy_equals_the_original():
    port, ref = dynamics.VelocityTrackingQuad(), jdynamics.VelocityTrackingQuad()
    rng = np.random.default_rng(4)
    for i in range(200):
        if i % 10 == 0:
            cmd = rng.uniform(-5, 5, 3)
            port.set_velocity_command(cmd)
            ref.set_velocity_command(cmd)
        a, b = port.step(0.01), ref.step(0.01)
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.vel, b.vel)


def test_pilot_copy_equals_the_original():
    """Both pilots on numpy rigid bodies from the ground: takeoff, hover,
    velocity references, refused then accepted landing, off; the same
    commands and transitions."""
    runs = []
    for mod in (pilot, jpilot):
        quad = RigidBodyQuad(start_pos=(0, 0, 0.0))
        p = mod.Pilot(quad=quad)
        cmds = []

        def fly(n):
            for _ in range(n):
                cmds.append(p.update())
                quad.step(0.01)

        p.start()
        fly(300)
        p.set_velocity_reference([1.0, 0.5, 0.0])
        fly(100)
        refused = p.land()
        fly(100)
        accepted = p.land()
        fly(400)
        runs.append((np.asarray(cmds), p.transitions, p.mode, refused, accepted))
    (c, t, m, r, a), (jc, jt, jm, jr, ja) = runs
    np.testing.assert_array_equal(c, jc)
    assert t == jt and m == jm == pilot.MODE_OFF and (r, a) == (jr, ja) == (False, True)


class ScriptedPipeline:
    """tests/test_hil.py's stand-in for StreamingPipeline: a fixed velocity
    policy with the real frame plumbing (input_hw, step_frame)."""

    def __init__(self, vel=(1.0, 0.0, 0.0)):
        self.input_hw = (260, 346)
        self.vel = np.asarray(vel, float)
        self.frames = []

    def step_frame(self, frame):
        self.frames.append(np.asarray(frame))
        return self.vel.copy(), None


def _sensor(pos, t):
    """tests/test_hil.py's sensor: 500 random events that depend on t alone."""
    rng = np.random.default_rng(int(t * 1000) % 2**31)
    n = 500
    return (rng.integers(0, 640, n), rng.integers(0, 480, n), rng.choice([-1, 1], n))


def test_hil_tracks_forward_command():
    pipe = ScriptedPipeline(vel=(2.0, 0.0, 0.0))
    res = run_hil_episode(pipe, _sensor, duration=6.0, des_fwd_vel=2.0)
    assert isinstance(res, HILResult)
    assert not res.guard_stopped
    assert res.pos[-1, 0] > 5.0, res.pos[-1]
    assert abs(res.pos[-1, 2] - 2.0) < 0.3
    assert len(pipe.frames) == len(res.t)
    assert pipe.frames[0].shape == (260, 346) and pipe.frames[0].dtype == np.float32


def test_hil_deadman_without_trigger():
    pipe = ScriptedPipeline(vel=(3.0, 0.0, 0.0))
    res = run_hil_episode(pipe, _sensor, duration=2.0, trigger=False)
    np.testing.assert_allclose(res.cmd, 0.0)
    assert abs(res.pos[-1, 0]) < 0.1


def test_hil_safety_box_latches():
    pipe = ScriptedPipeline(vel=(4.0, 0.0, 0.0))
    res = run_hil_episode(pipe, _sensor, duration=8.0, des_fwd_vel=4.0,
                          safety=SafetyConfig(x_range=(-5.0, 3.0)))
    assert res.guard_stopped
    assert np.all(res.cmd[-5:] == 0.0)
    assert np.linalg.norm(res.vel[-1]) < 0.5
    assert res.pos[-1, 0] < 8.0


def test_hil_pilot_full_flight():
    pipe = ScriptedPipeline(vel=(2.0, 0.0, 0.0))
    res = run_hil_episode(pipe, _sensor, duration=4.0, des_fwd_vel=2.0,
                          start_pos=(0.0, 0.0, 0.0), use_pilot=True)
    assert not res.guard_stopped
    assert res.phases.keys() == {"takeoff", "run", "land"}
    t_take, t_run, t_land = (res.phases[k] for k in ("takeoff", "run", "land"))
    assert t_take[0] < t_take[1] <= t_run[0] < t_run[1] <= t_land[1]
    modes = [m_to for _, _, m_to in res.transitions]
    assert modes == [pilot.MODE_TRAJECTORY, pilot.MODE_HOVER, pilot.MODE_VELOCITY,
                     pilot.MODE_HOVER, pilot.MODE_TRAJECTORY, pilot.MODE_OFF]
    fine_t, fine_z = res.fine[:, 0], res.fine[:, 3]
    z_at_hover = fine_z[np.searchsorted(fine_t, t_take[1]) - 1]
    assert z_at_hover == pytest.approx(1.0, abs=0.3)
    assert fine_z[-1] == pytest.approx(0.0, abs=0.2)
    assert res.pos[-1, 0] > 2.0


class _Recording:
    def __init__(self, pipe):
        self.pipe, self.input_hw, self.vels = pipe, pipe.input_hw, []

    def step_frame(self, frame):
        vel, depth = self.pipe.step_frame(frame)
        self.vels.append(vel.cpu())
        return vel, depth


@pytest.mark.gpu
def test_hil_graph_episode_matches_the_eager_plain_path_on_gpu(cuda_device):
    """30 ticks with the joint model (random weights) replaying graphs,
    against an eager episode on the plain path: each tick's velocity within
    1e-4; the latch never fires."""
    cfg = dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
               input_shape=[1, 1, 260, 346], velpred=0, form_BEV=2, evs_min_cutoff=0.0,
               skip_type="interp")
    model = OrigUNet_w_VITFLY_ViTLSTM(device=cuda_device, **cfg).eval()
    runs = []
    for graph, fused in ((True, True), (False, False)):
        set_fused_lstm(fused)
        try:
            rec = _Recording(StreamingPipeline(model, device=cuda_device, graph=graph))
            runs.append((run_hil_episode(rec, _sensor, duration=2.0), rec.vels))
        finally:
            set_fused_lstm(True)
    (res, vels), (res_p, vels_p) = runs
    assert len(vels) == len(vels_p) == len(res.t) == 30
    for v, vp in zip(vels, vels_p):
        torch.testing.assert_close(v, vp, atol=1e-4, rtol=0)
    assert not res.guard_stopped and not res_p.guard_stopped
