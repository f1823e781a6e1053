"""The lockstep stepper of sim/batched.py on the CPU at 40x52, G = 4:
``BatchedTrials.tick()`` looped by hand gives ``run_trials_batched``'s
results exactly (summaries, logs and frames), in state and vision modes
(the vision policy a deterministic stub behind ``step_frames``/``reset``);
each tick logs one row per live trial, hands the policy the frame and the
reset mask it keeps as ``last_frames`` and ``last_reset``, and ``tick()``
returns False once the trials have ended."""

import numpy as np
import pytest
import torch

from evfly_tpu_torch.sim import batched
from evfly_tpu_torch.sim.obstacles import generate_forest

H, W, G = 40, 52, 4


class _Policy:
    """step_frames/reset with a carried state per stream: a fixed map of
    the frame and the state to a velocity; it logs what it was given."""

    def __init__(self):
        self.h = np.zeros(G)
        self.given = []

    def reset(self):
        self.h[:] = 0.0

    def step_frames(self, frames, reset_mask=None):
        mask = np.asarray(reset_mask, bool)
        self.given.append((frames, mask.copy()))
        self.h[mask] = 0.0
        f = frames.double().numpy()
        m = np.abs(f).reshape(G, -1).mean(1)
        self.h = 0.8 * self.h + np.tanh(10.0 * m)
        vels = np.stack([3.0 + 0.5 * self.h, 0.6 * np.tanh(self.h - 0.5), np.full(G, 0.5)], 1)
        return torch.as_tensor(vels), None


def _fields(seed=3):
    rng = np.random.default_rng(seed)
    return [generate_forest(rng, num_obstacles=12, trees=True) for _ in range(G)]


@pytest.mark.parametrize("mode", ["state", "vision"])
def test_ticks_looped_give_run_trials_batched_exactly(mode):
    kw = dict(mode=mode, desired_vels=[4.0, 3.5, 5.0, 4.5], policy_every=6, command_every=3,
              max_steps=600 if mode == "state" else 180, H=H, W=W, seed=7, fetch_every=5,
              device="cpu")
    ref = batched.run_trials_batched(_fields(), policy=_Policy() if mode == "vision" else None,
                                     **kw)
    policy = _Policy() if mode == "vision" else None
    trials = batched.BatchedTrials(_fields(), policy=policy, **kw)
    ticks, rows = 0, 0
    while trials.tick():
        ticks += 1
        now = sum(len(r) for r in trials.rows)
        assert now - rows == int(trials.active.sum()) or not trials.active.all()
        rows = now
        if mode == "vision":
            frames, mask = policy.given[-1]
            assert frames is trials.last_frames and frames.shape == (G, H, W)
            assert np.array_equal(mask, trials.last_reset)
            assert torch.is_tensor(trials.last_policy[0])
    assert trials.done and not trials.tick()
    got = trials.results()
    assert ticks == max(len(r["log"]) for r in got) > 10
    for g in range(G):
        assert got[g]["summary"] == ref[g]["summary"]
        assert np.array_equal(got[g]["log"], ref[g]["log"])
        for name in ("depths", "events", "intensities"):
            assert len(got[g][name]) == len(ref[g][name])
            assert all(np.array_equal(a, b) for a, b in zip(got[g][name], ref[g][name]))
    if mode == "vision":
        assert any(m.any() for _, m in policy.given)  # resets below x = 0.5 m
