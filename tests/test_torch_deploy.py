"""The port's event accumulator and deployment runner against the JAX package's.

- ``EventAccumulator``: the port's C++ accumulator (its copy of
  ``evstream.cpp``, built into ``build/`` at its first use) and its numpy
  version against the JAX package's numpy version
  (``evfly_tpu.stream.accumulator.EventAccumulator(native=False)``) on
  seeded events with out-of-range coordinates and pixels driven past both
  ends of the uint8 range, over several accumulate/drain cycles: frames
  equal bit for bit, and ``frame_from_accumulated`` too.  (Within one
  ``accumulate`` call the C++ version clamps after every event and the
  numpy version after the call, in both packages; the hot pixels here take
  one sign per call, where the two agree.)
- ``native=True`` raises where the library does not build, ``None`` falls
  back to numpy; concurrent builds never load a half-written library.
- ``DeploymentRunner``: the port's against the JAX package's, with the same
  scripted pipeline and clock through tests/test_deploy.py's scenarios
  (deadman, ramp, latched safety box, trigger timeout): commands equal.
- A tick through the port's ``StreamingPipeline`` on the CPU.
"""

import concurrent.futures
import ctypes

import numpy as np
import pytest

from evfly_tpu.stream import accumulator as jaccumulator
from evfly_tpu.stream import deploy as jdeploy
from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.native import _build
from evfly_tpu_torch.stream import (DeploymentRunner, EventAccumulator, SafetyConfig,
                                    StreamingPipeline, frame_from_accumulated)

H, W = 48, 64


def _bursts(seed, n_bursts=3, n=3000):
    """Seeded bursts of events: uniform over a frame larger than H x W (so
    some fall outside it, negative ones too), plus pixel (5, 7) pushed
    past 255 and pixel (40, 60) below 0, one sign per burst."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_bursts):
        x = rng.integers(-8, W + 8, n)
        y = rng.integers(-8, H + 8, n)
        pol = rng.choice([-1, 0, 1], n)
        hot = 300 if b % 2 == 0 else 40
        x = np.concatenate([x, np.full(hot, 7), np.full(200, 60)])
        y = np.concatenate([y, np.full(hot, 5), np.full(200, 40)])
        pol = np.concatenate([pol, np.full(hot, 1 if b % 2 == 0 else -1), np.full(200, -1)])
        out.append((x, y, pol))
    return out


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_accumulator_matches_jax(native):
    port = EventAccumulator(H, W, native=native)
    ref = jaccumulator.EventAccumulator(H, W, native=False)
    assert port.is_native == native and not ref.is_native
    for burst in range(3):
        for x, y, pol in _bursts(burst):
            port.accumulate(x, y, pol)
            ref.accumulate(x, y, pol)
        got, want = port.drain(), ref.drain()
        assert got.dtype == np.uint8 and got.shape == (H, W)
        np.testing.assert_array_equal(got, want)
        assert got.max() == 255 and got.min() == 0
        np.testing.assert_array_equal(
            frame_from_accumulated(got, crop_hw=(32, 40)),
            jaccumulator.frame_from_accumulated(want, crop_hw=(32, 40)))
        np.testing.assert_array_equal(frame_from_accumulated(got, crop_hw=(H, W)),
                                      jaccumulator.frame_from_accumulated(want, crop_hw=(H, W)))
    # drained: back at base
    np.testing.assert_array_equal(port.drain(), np.full((H, W), 128, np.uint8))


def test_frame_from_accumulated_matches_jax_at_the_sensor_size():
    rng = np.random.default_rng(1)
    frame = rng.integers(0, 256, (480, 640)).astype(np.uint8)
    np.testing.assert_array_equal(frame_from_accumulated(frame),
                                  jaccumulator.frame_from_accumulated(frame))
    assert frame_from_accumulated(frame).shape == (260, 346)


def test_native_true_raises_and_none_falls_back_when_the_build_fails(monkeypatch):
    def fail(name):
        raise RuntimeError("no compiler")

    monkeypatch.setattr(_build, "build", fail)
    monkeypatch.setattr(_build, "load", _build.load.__wrapped__)  # no cached library
    with pytest.raises(RuntimeError, match="no compiler"):
        EventAccumulator(H, W, native=True)
    fallback = EventAccumulator(H, W)
    assert not fallback.is_native
    fallback.accumulate([1, 2], [3, 4], [1, -1])
    assert fallback.drain()[3, 1] == 129


def test_accumulate_rejects_mismatched_lengths():
    acc = EventAccumulator(H, W, native=True)
    with pytest.raises(ValueError, match="one"):
        acc.accumulate(np.zeros(3), np.zeros(2), np.ones(3))


def test_concurrent_builds_load_one_whole_library(monkeypatch, tmp_path):
    """Eight threads build evstream at once into an empty build directory:
    each gets the same path, the library loads, nothing temporary is left."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(_build.build, ["evstream"] * 8, timeout=120))
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    assert ctypes.CDLL(str(paths[0])).evstream_create


def test_library_name_follows_source_and_flags(monkeypatch):
    path = _build.library_path("evstream")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libevstream_")
    monkeypatch.setattr(_build, "CXX_FLAGS", _build.CXX_FLAGS + ("-DX",))
    assert _build.library_path("evstream") != path
    assert _build.library_path("evt3").name.startswith("libevt3_")
    with pytest.raises(ValueError, match="unknown"):
        _build.library_path("nosuchlib")


class ScriptedPipeline:
    """tests/test_deploy.py's FakePipeline: a constant velocity."""

    input_hw = (260, 346)

    def __init__(self, vel=(4.0, 1.0, 0.5)):
        self.vel = np.array(vel)
        self.steps = 0

    def step_frame(self, frame):
        self.steps += 1
        return self.vel, None


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _deadman(r, clock):
    r.push_odometry([0, 0, 2])
    return [r.tick()]


def _ramp(r, clock):
    r.push_odometry([0, 0, 2.0])
    clock.t = 10.0
    r.push_trigger()
    cmds = [r.tick()]
    for t in (11.0, 12.5, 13.5):
        clock.t = t
        r.push_trigger()
        r.push_odometry([0, 0, 1.7])
        cmds.append(r.tick())
    return cmds


def _latched_box(r, clock):
    clock.t = 5.0
    r.push_trigger()
    r.push_odometry([50.0, 0, 2.0])
    cmds = [r.tick()]
    r.push_odometry([0.0, 0, 2.0])
    r.push_trigger()
    cmds.append(r.tick())
    return cmds + [np.array([float(r.safety_guard_triggered)] * 3)]


def _trigger_timeout(r, clock):
    r.push_odometry([0, 0, 2.0])
    clock.t = 1.0
    r.push_trigger()
    clock.t = 1.05
    cmds = [r.tick()]
    clock.t = 1.5
    cmds.append(r.tick())
    return cmds


SCENARIOS = {"deadman": _deadman, "ramp": _ramp, "latched box": _latched_box,
             "trigger timeout": _trigger_timeout}


def _run(runner_cls, safety_cls, acc_cls, scenario):
    clock = Clock()
    pipe = ScriptedPipeline()
    r = runner_cls(
        pipe, des_fwd_vel=4.0,
        safety=safety_cls(x_range=(-10, 10), y_range=(-10, 10), z_range=(0, 10)),
        accumulator=acc_cls(8, 8, native=False), clock=clock,
    )
    cmds = SCENARIOS[scenario](r, clock)
    return np.asarray(cmds), pipe.steps


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_runner_commands_equal_jax(scenario):
    got, steps = _run(DeploymentRunner, SafetyConfig, EventAccumulator, scenario)
    want, jsteps = _run(jdeploy.DeploymentRunner, jdeploy.SafetyConfig,
                        jaccumulator.EventAccumulator, scenario)
    np.testing.assert_array_equal(got, want)
    assert steps == jsteps == len(got) - (scenario == "latched box")


def test_safety_config_defaults_equal_jax():
    assert SafetyConfig() == SafetyConfig(**vars(jdeploy.SafetyConfig()))
    assert vars(SafetyConfig()) == vars(jdeploy.SafetyConfig())


def test_tick_through_the_streaming_pipeline_on_cpu():
    """The runner around the port's StreamingPipeline: the frame goes in as
    a numpy array, the command and depth come back as numpy arrays, and
    with the guards open the command is the pipeline's velocity."""
    hw = (196, 196)
    model = OrigUNet_w_VITFLY_ViTLSTM(input_shape=(1, 1, *hw), form_BEV=2, device="cpu").eval()
    pipe = StreamingPipeline(model, input_hw=hw, device="cpu")
    ref = StreamingPipeline(model, input_hw=hw, device="cpu")
    clock = Clock()
    runner = DeploymentRunner(pipe, safety=SafetyConfig(ramp_duration=0.0), clock=clock,
                              accumulator=EventAccumulator(native=True))
    rng = np.random.default_rng(2)
    x, y, pol = rng.integers(0, 640, 4000), rng.integers(0, 480, 4000), rng.choice([-1, 1], 4000)
    runner.push_events(x, y, pol)
    runner.push_trigger()
    cmd = runner.tick()
    acc = EventAccumulator(native=False)
    acc.accumulate(x, y, pol)
    vel, depth = ref.step_frame(frame_from_accumulated(acc.drain(), crop_hw=hw))
    assert isinstance(cmd, np.ndarray) and cmd.shape == (3,)
    np.testing.assert_allclose(cmd[:2], vel.numpy()[:2].astype(float), atol=1e-6)
    assert cmd[2] == 0.0  # no odometry: z command 0
    assert isinstance(runner.last_pred_depth, np.ndarray)
    np.testing.assert_allclose(runner.last_pred_depth, depth.numpy(), atol=1e-6)
    np.testing.assert_array_equal(runner.last_pred_vel, cmd)
