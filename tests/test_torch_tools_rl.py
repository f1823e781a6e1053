"""The port's RL driver (evfly_tpu_torch/tools/train_rl.py) against the
repo's JAX driver (tools/train_rl.py), on the CPU.

- greedy_eval: the JAX driver's greedy rollout (its jitted scan) and the
  port's ``greedy_rollout`` from the same initial states (JAX's draws,
  carried across) and the same actor-critic (``actor_critic_from_jax``):
  returns, ``alive`` and final positions.  VisionEnv over the driver's
  full horizon (998 steps, 16 envs); QuadrotorEnv cut to 32 steps (its
  attitude under an untrained policy is chaotic: PPO_HOLD_ROLLOUT in
  chip_smoke.py).  Bounds: the env steps agree within 1e-6 a step
  (tests/test_torch_rl.py) and the first-order VisionEnv does not amplify
  them, so positions within 1e-4 and returns within 1e-4 relative after
  998 steps; the quadrotor's within 1e-4 after 32 (its steps 1e-5);
  ``alive`` equal;
- the greedy metrics of the same states equal the JAX driver's formulas;
- the CLI on the CPU at toy sizes writes an artifact with the keys of the
  JAX driver's records (artifacts/rl_vision.json, rl_quadrotor.json).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from evfly_tpu.sim import ppo as j_ppo
from evfly_tpu_torch.sim import ppo, quadrotor_env, vision_env
from evfly_tpu_torch.tools import train_rl

from torch_tools_cases import REPO, jax_tool
from torch_tools_cases import few_torch_threads, keep_precision  # noqa: F401  (fixtures)

CPU = torch.device("cpu")
ARGS = argparse.Namespace(seed=0, obstacles=40, horizon_s=20.0)


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_case(env):
    jrl = jax_tool("train_rl")
    if env == "vision":
        _, spec_j = jrl.build_vision(ARGS)
        _, spec_t = train_rl.build_vision(ARGS, CPU)
        state_cls, qparams = vision_env.EnvState, None
    else:
        _, spec_j, _ = jrl.build_quadrotor(ARGS)
        spec_t, qparams = train_rl.build_quadrotor(ARGS, CPU)
        state_cls = quadrotor_env.QuadEnvState
    ac_j = j_ppo.init_actor_critic(jax.random.PRNGKey(5), act_dim=spec_j.act_dim,
                                   obs_dim=spec_j.obs_dim)
    return jrl, spec_j, spec_t, state_cls, qparams, ac_j


@pytest.mark.parametrize("env, n_envs, steps, atol", [
    ("vision", 16, train_rl.greedy_steps("vision", 20.0), 1e-4),
    ("quadrotor", 16, 32, 1e-4),
], ids=["vision", "quadrotor"])
def test_greedy_rollout_matches_jax(env, n_envs, steps, atol):
    jrl, spec_j, spec_t, state_cls, qparams, ac_j = _jax_case(env)
    seed = 3
    states_j0 = jax.vmap(spec_j.reset)(jax.random.split(jax.random.PRNGKey(seed), n_envs))
    ref_states, ref_ret, ref_alive = jrl.greedy_eval(spec_j, ac_j, n_envs, steps, seed)
    ac_t = ppo.actor_critic_from_jax(ac_j, device=CPU)
    states, ret, alive = train_rl.greedy_rollout(
        spec_t, ac_t, state_cls(*(_t(x) for x in states_j0)), steps)
    pos, ref_pos = ((s.pos if env == "vision" else s.p) for s in (states, ref_states))
    dpos = np.abs(pos.numpy() - np.asarray(ref_pos)).max()
    dret = np.abs(ret.numpy() - np.asarray(ref_ret)).max()
    print(f"{env}: {steps} greedy steps, {n_envs} envs: max |pos diff| {dpos:.3g}, max |return "
          f"diff| {dret:.3g}, alive {int(alive.sum())}, returns {np.asarray(ref_ret)[:4]}")
    np.testing.assert_array_equal(alive.numpy(), np.asarray(ref_alive))
    np.testing.assert_allclose(pos.numpy(), np.asarray(ref_pos), rtol=0, atol=atol)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ref_ret), rtol=atol, atol=atol)
    if env == "vision":
        assert (~alive).any()  # some envs finish inside the horizon: the freeze is held
    got = train_rl.greedy_metrics(env, state_cls(*(_t(x) for x in ref_states)),
                                  _t(ref_ret), _t(ref_alive), qparams)
    assert all(np.isfinite(v) for v in got.values())


def test_greedy_eval_draws_from_a_seeded_generator():
    _, spec = train_rl.build_vision(ARGS, CPU)
    ac = ppo.init_actor_critic(torch.Generator().manual_seed(1), device=CPU)
    a = train_rl.greedy_eval(spec, ac, 8, 20, seed=4)
    b = train_rl.greedy_eval(spec, ac, 8, 20, seed=4)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert torch.equal(a[1], b[1]) and a[1].shape == (8,)


@pytest.mark.parametrize("env", ["vision", "quadrotor"])
def test_train_rl_cli_artifact_keys(tmp_path, env):
    out = tmp_path / "rl.json"
    proc = subprocess.run(
        [sys.executable, "-m", "evfly_tpu_torch.tools.train_rl", "--device", "cpu",
         "--env", env, "--iters", "2", "--num-envs", "4", "--rollout", "8",
         "--horizon-s", "1.0", "--out-json", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[RL] final:" in proc.stdout
    got = json.loads(out.read_text())
    ref = json.loads((REPO / "artifacts" / f"rl_{env}.json").read_text())
    assert list(got) == list(ref)
    assert list(got["history"][0]) == list(ref["history"][0])
    assert got["env_steps_total"] == 2 * 4 * 8 and got["env"] == env
    assert all(np.isfinite(v) for k, v in got.items()
               if isinstance(v, float))


def test_train_rl_cli_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_rl.main(["--iters", "1"])
