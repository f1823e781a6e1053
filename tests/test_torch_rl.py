"""The port's RL path (evfly_tpu_torch/sim/vision_env.py, quadrotor_env.py,
ppo.py) against the JAX package's, on the CPU, from the same states,
actions, weights and random draws.

The JAX package draws from jax.random and the port from torch.Generator,
so the draws are carried across: reset_from_uniform takes JAX's uniforms,
and one PPO iteration takes JAX's action noise and auto-reset states
(``noise``, ``resets``) and JAX's initial weights (actor_critic_from_jax).

Tolerances, each term's own:
- resets: within 1e-7 (the same f32 arithmetic on the same uniforms, but
  XLA contracts u * (max - min) + min into one fma);
- VisionEnv steps: state, obs, reward within 1e-6 (f32 norms and sums in
  another order); done equal; the 10 nearest obstacles in the same stable
  order, ties included;
- QuadrotorEnv steps (RK4 over 0.02 s): p, v, w within 1e-5, q within 1e-6;
  the pos, lin_vel and ang_vel rewards within 1e-8 (their coefficients are
  1e-3 and 1e-4); the ori reward 2 acos(|q_w|) has an unbounded slope at
  q_w = 1, where one f32 step of q_w moves it by up to 7e-4 rad, so it is
  held within the difference that the two packages' q give the same term
  evaluated in f64, plus 8 f32 roundings;
- one PPO iteration (rollout, GAE, 4 Adam steps): the final env states
  within 1e-5, the metrics within 1e-5 relative, the updated parameters
  within 1e-6 (the updates are 3e-4 per step) wherever the first epoch's
  gradient exceeds 1e-4 of its tensor's largest.  Below that, the gradient
  is the rounding of a saturated tanh's derivative (1 - tanh^2 of a hidden
  unit that 60 m obstacle coordinates drive far past 1), which Adam scales
  to a step of up to lr whatever its size, so both packages' values there
  are rounding: held within 2 lr per epoch, and counted;
- Adam: torch.optim.Adam's update against optax.adam's within 2e-5
  relative over 5 steps: optax takes the bias corrections 1 - b^t in f32
  (1 - 0.999 rounds to 0.00099998713), torch in f64, which moves the
  update by up to 1.1e-5 of itself.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from evfly_tpu.sim import ppo as j_ppo
from evfly_tpu.sim import quadrotor_env as j_quad
from evfly_tpu.sim import vision_env as j_vis
from evfly_tpu.sim.obstacles import generate_forest
from evfly_tpu_torch.sim import ppo, quadrotor_env, vision_env

CPU = torch.device("cpu")
N = 16


def _t(x):
    return torch.as_tensor(np.array(x))


def _j_params(K=None, max_t=30.0, box_x=65.0):
    field = generate_forest(np.random.default_rng(4), num_obstacles=40)
    pos, rad = field.positions.astype(np.float32), field.radii.astype(np.float32)
    # obstacles near the start, so that the collision term is live
    pos = np.concatenate([[[1.5, 0.5, 0.0], [2.0, -1.0, 0.0]], pos])[:K].astype(np.float32)
    rad = np.concatenate([[0.6, 0.8], rad])[:K].astype(np.float32)
    return j_vis.EnvParams(
        obstacle_pos=jnp.asarray(pos), obstacle_radius=jnp.asarray(rad),
        goal_vel=jnp.array([4.0, 0.0, 0.0]),
        world_box=jnp.array([[-5.0, -20.0, 0.0], [box_x, 20.0, 20.0]]), max_t=max_t)


def _port_params(jp):
    return vision_env.params_to(jp._replace(**{
        k: _t(getattr(jp, k)) for k in ("obstacle_pos", "obstacle_radius", "goal_vel",
                                        "world_box")}), CPU)


def _vis_state(js):
    return vision_env.EnvState(*(_t(x) for x in js))


def _quad_state(js):
    return quadrotor_env.QuadEnvState(*(_t(x) for x in js))


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol,
                               err_msg=what)


def _vision_uniforms(key, n):
    """JAX's reset uniforms: (u_pos, u_vel) of each env's key, as
    vision_env.reset splits it."""
    u = [[jax.random.uniform(k, (3,)) for k in jax.random.split(ki)]
         for ki in jax.random.split(key, n)]
    return (_t(np.stack([a for a, _ in u])), _t(np.stack([b for _, b in u])))


def _quad_uniforms(key, n):
    u = [[jax.random.uniform(k, (s,)) for k, s in zip(jax.random.split(ki, 3), (3, 3, 4))]
         for ki in jax.random.split(key, n)]
    return tuple(_t(np.stack([x[i] for x in u])) for i in range(3))


def test_vision_reset_from_jax_uniforms():
    jp = _j_params()
    key = jax.random.PRNGKey(3)
    ref, _ = j_vis.VecVisionEnv(jp, N).reset(key)
    got = vision_env.reset_from_uniform(_port_params(jp), *_vision_uniforms(key, N))
    for a, b in zip(got, ref):
        _close(a, b, 1e-7)
    params = _port_params(jp)
    states, obs = vision_env.VecVisionEnv(params, N, device=CPU).reset(
        torch.Generator().manual_seed(0))
    assert obs.shape == (N, vision_env.OBS_DIM)
    assert ((states.pos - torch.tensor([0.0, 0.0, 2.0])).abs()
            <= torch.tensor([0.5, 1.0, 0.25])).all() and (states.vel.abs() <= 0.1).all()


@pytest.mark.parametrize("K", [42, 3], ids=["forest", "padded"])
def test_vision_step_matches_jax(K):
    """30 steps from the same states and actions; K = 3 pads the obstacle
    block with 7 tied dummies."""
    jp = _j_params(K=K, max_t=0.3, box_x=4.0)
    env_j, env_t = j_vis.VecVisionEnv(jp, N), vision_env.VecVisionEnv(_port_params(jp), N,
                                                                      device=CPU)
    js, jo = env_j.reset(jax.random.PRNGKey(1))
    _close(vision_env.get_obs(env_t.params, _vis_state(js)), jo, 1e-6, "obs")
    rng = np.random.default_rng(0)
    dones = 0
    for i in range(30):
        act = rng.normal(size=(N, 3)).astype(np.float32) * 6
        js_next, jo, jr, jd = env_j.step(js, jnp.asarray(act))
        ts, to, tr, td = env_t.step(_vis_state(js), _t(act))
        for name, a, b in zip(("pos", "vel", "t"), ts, js_next):
            _close(a, b, 1e-6, name)
        _close(to, jo, 1e-6, "obs")
        _close(tr, jr, 1e-6, "reward")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        _, comps_t = vision_env.compute_reward(env_t.params, ts)
        _, comps_j = jax.vmap(lambda s: j_vis.compute_reward(jp, s))(js_next)
        _close(comps_t, comps_j, 1e-6, "reward components")
        dones += int(td.sum())
        js = js_next
    assert dones > 0


def test_vision_obstacle_order_is_stable():
    """Equidistant obstacles and the padding dummies tie: the order is
    the stable sort's (jnp.argsort), so the observation is JAX's exactly
    in its obstacle block."""
    pos = np.array([[3.0, 1.0, 2.0], [3.0, -1.0, 2.0], [1.0, 0.0, 2.0], [3.0, 1.0, 2.0]],
                   np.float32)
    jp = j_vis.EnvParams(obstacle_pos=jnp.asarray(pos),
                         obstacle_radius=jnp.asarray([0.5, 0.7, 0.9, 1.1]),
                         goal_vel=jnp.array([4.0, 0.0, 0.0]),
                         world_box=jnp.array([[-5.0, -20.0, 0.0], [65.0, 20.0, 20.0]]))
    state = j_vis.EnvState(pos=jnp.asarray([[2.0, 0.0, 2.0]]), vel=jnp.zeros((1, 3)),
                           t=jnp.zeros(1), done=jnp.zeros(1, bool))
    ref = jax.vmap(lambda s: j_vis.get_obs(jp, s))(state)
    got = vision_env.get_obs(_port_params(jp), _vis_state(state))
    np.testing.assert_array_equal(got.numpy()[:, 15:], np.asarray(ref)[:, 15:])


@pytest.mark.parametrize("rotor_ctrl", [1, 0])
def test_quadrotor_step_matches_jax(rotor_ctrl):
    jp = j_quad.default_params(rotor_ctrl=rotor_ctrl, max_t=0.4)
    tp = quadrotor_env.default_params(CPU, rotor_ctrl=rotor_ctrl, max_t=0.4)
    env_j = j_quad.VecQuadrotorEnv(jp, N)
    env_t = quadrotor_env.VecQuadrotorEnv(tp, N, device=CPU)
    key = jax.random.PRNGKey(2)
    js, jo = env_j.reset(key)
    ts0 = quadrotor_env.reset_from_uniform(tp, *_quad_uniforms(key, N))
    for a, b in zip(ts0, js):
        _close(a, b, 1e-7)
    _close(quadrotor_env.get_obs(tp, ts0), jo, 1e-6, "obs")
    rng = np.random.default_rng(1)
    n_done = 0
    for i in range(25):
        act = np.clip(rng.normal(size=(N, 4)), -1, 1).astype(np.float32)
        js_next, jo, jr5, jd, jfin = env_j.step(js, jnp.asarray(act))
        ts, to, tr5, td, tfin = env_t.step(_quad_state(js), _t(act))
        for name, a, b, tol in zip("pvqwt", ts, js_next, (1e-5, 1e-5, 1e-6, 1e-5, 1e-6)):
            _close(a, b, tol, name)
        _close(to, jo, 1e-5, "obs")
        tr5, jr5 = tr5.numpy(), np.asarray(jr5)
        for c in (0, 2, 3):
            _close(tr5[:, c], jr5[:, c], 1e-8, f"reward term {c}")
        ori64 = lambda q: -0.002 * 2.0 * np.arccos(np.clip(np.abs(np.asarray(q, np.float64)[:, 0]),
                                                           0.0, 1.0))
        bound = (np.abs(ori64(ts.q) - ori64(js_next.q))
                 + 8 * np.finfo(np.float32).eps * np.abs(jr5[:, 1]) + 1e-12)
        assert (np.abs(tr5[:, 1] - jr5[:, 1]) <= bound).all()
        assert (np.abs(tr5[:, 4] - jr5[:, 4]) <= bound + 1e-8).all()
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
        n_done += int(td.sum())
        js = js_next
    assert n_done > 0


def _gae_jax(values, rewards, dones, last_value, gamma=0.99, lam=0.95):
    """The scan of the JAX package's make_ppo_iteration (ppo.py:171-184)."""
    def scan_fn(carry, inp):
        adv_next, v_next = carry
        value, reward, done = inp
        nonterminal = 1.0 - done.astype(jnp.float32)
        delta = reward + gamma * v_next * nonterminal - value
        adv = delta + gamma * lam * nonterminal * adv_next
        return (adv, value), adv

    _, advs = jax.lax.scan(scan_fn, (jnp.zeros_like(last_value), last_value),
                           (values, rewards, dones), reverse=True)
    return advs


def test_gae_matches_jax():
    rng = np.random.default_rng(3)
    T = 24
    values = rng.normal(size=(T, N)).astype(np.float32)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.1
    last = rng.normal(size=N).astype(np.float32)
    ref = _gae_jax(jnp.asarray(values), jnp.asarray(rewards), jnp.asarray(dones),
                   jnp.asarray(last))
    got = ppo.gae(ppo.PPOConfig(), _t(values), _t(rewards), _t(dones), _t(last))
    _close(got, ref, 1e-6)


def test_adam_matches_optax():
    rng = np.random.default_rng(5)
    p0 = np.zeros((7, 5), np.float32)  # the first update lands unrounded
    opt = optax.adam(3e-4)
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    pt = torch.nn.Parameter(_t(p0.copy()))
    topt = torch.optim.Adam([pt], lr=3e-4)
    for _ in range(5):
        g = (rng.normal(size=p0.shape) * 10.0 ** rng.integers(-6, 1, p0.shape)).astype(np.float32)
        upd, state = opt.update(jnp.asarray(g), state, pj)
        before = pt.detach().clone()
        pj = optax.apply_updates(pj, upd)
        pt.grad = _t(g)
        topt.step()
        np.testing.assert_allclose((pt.detach() - before).numpy(), np.asarray(upd),
                                   rtol=2e-5, atol=0)
        _close(pt.detach(), pj, 1e-8)


class _RecordingAdam(torch.optim.Adam):
    """Adam that keeps the gradients of its first step."""

    first_grads = None

    def step(self, *args, **kwargs):
        if self.first_grads is None:
            self.first_grads = [p.grad.clone() for p in self.param_groups[0]["params"]]
        return super().step(*args, **kwargs)


def _port_state(spec_kind, js):
    return _vis_state(js) if spec_kind == "vision" else _quad_state(js)


@pytest.mark.parametrize("kind", ["vision", "quadrotor"])
def test_ppo_iteration_matches_jax(kind):
    """One iteration from JAX's weights, env states and draws."""
    cfg = ppo.PPOConfig(num_envs=N, rollout_len=12, epochs_per_iter=4)
    if kind == "vision":
        jp = _j_params(max_t=0.12, box_x=4.0)
        j_spec = j_ppo.vision_env_spec(jp, cfg.max_speed)
        t_spec = ppo.vision_env_spec(_port_params(jp), cfg.max_speed, device=CPU)
    else:
        jp = j_vis.EnvParams(obstacle_pos=jnp.zeros((1, 3)), obstacle_radius=jnp.zeros((1,)),
                             goal_vel=jnp.zeros(3), world_box=jnp.zeros((2, 3)))
        j_spec = j_quad.ppo_spec(j_quad.default_params(max_t=0.12))
        t_spec = quadrotor_env.ppo_spec(quadrotor_env.default_params(CPU, max_t=0.12))
    k_init, k_env, key = jax.random.split(jax.random.PRNGKey(7), 3)
    ac = j_ppo.init_actor_critic(k_init, act_dim=j_spec.act_dim, obs_dim=j_spec.obs_dim)
    optimizer = optax.adam(cfg.lr)
    states = jax.vmap(j_spec.reset)(jax.random.split(k_env, N))
    it_j = j_ppo.make_ppo_iteration(jp, j_ppo.PPOConfig(**cfg._asdict()), optimizer, j_spec)
    ac_j, _, states_j, metrics_j = it_j(ac, optimizer.init(ac), states, key)

    # JAX's draws, split as its rollout splits them
    k_collect, _ = jax.random.split(key)
    noise, resets = [], []
    for k in jax.random.split(k_collect, cfg.rollout_len):
        k_act, k_reset = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_act, (N, j_spec.act_dim))))
        resets.append(_port_state(kind, jax.vmap(j_spec.reset)(jax.random.split(k_reset, N))))

    ac_t = ppo.actor_critic_from_jax(ac, device=CPU)
    opt_t = _RecordingAdam(ac_t.parameters(), lr=cfg.lr)
    it_t = ppo.make_ppo_iteration(None, cfg, t_spec)
    ac_t, _, states_t, metrics_t = it_t(ac_t, opt_t, _port_state(kind, states),
                                        noise=_t(np.stack(noise)), resets=resets)
    for a, b in zip(states_t, states_j):
        _close(a, b, 1e-5, "env state")
    assert metrics_t["done_frac"] > 0
    for k, v in metrics_j.items():
        np.testing.assert_allclose(float(metrics_t[k]), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    ref = ppo.actor_critic_from_jax(ac_j, device=CPU)
    rounding = 0
    for (name, a), (_, b), g in zip(ac_t.named_parameters(), ref.named_parameters(),
                                    opt_t.first_grads):
        d = (a.detach() - b.detach()).abs()
        held = g.abs() > 1e-4 * g.abs().max()
        assert d[held].max() <= 1e-6, name
        assert d.max() <= 2 * cfg.lr * cfg.epochs_per_iter, name
        rounding += int((~held).sum())
    print(f"{kind}: {rounding} parameters with a first gradient below 1e-4 of the largest")
    moved = max((a.detach() - b).abs().max().item() for a, b in
                zip(ac_t.parameters(), ppo.actor_critic_from_jax(ac, device=CPU).parameters()))
    assert moved > 1e-4


def test_policy_sample_and_train_ppo_run():
    ac = ppo.init_actor_critic(torch.Generator().manual_seed(0), device=CPU)
    obs = torch.zeros(7, vision_env.OBS_DIM)
    action, raw, logp, value = ppo.policy_sample(ac, obs, torch.Generator().manual_seed(1))
    assert action.shape == (7, 3) and logp.shape == (7,) and value.shape == (7,)
    assert action.abs().max() <= 5.0
    w0 = ac.actor[0].weight
    assert abs(w0.std().item() - math.sqrt(2.0 / vision_env.OBS_DIM)) < 0.02
    cfg = ppo.PPOConfig(num_envs=8, rollout_len=8, epochs_per_iter=2)
    _, hist = ppo.train_ppo(_port_params(_j_params(max_t=0.1)), cfg, n_iters=2, device=CPU)
    assert len(hist) == 2 and all(np.isfinite(v) for h in hist for v in h.values())
    _, hist = ppo.train_ppo(None, cfg, n_iters=2, spec=quadrotor_env.ppo_spec(device=CPU))
    assert len(hist) == 2 and all(np.isfinite(v) for h in hist for v in h.values())


def test_sim_entry_points_raise_without_cuda(monkeypatch):
    from evfly_tpu_torch.sim import batched, closed_loop, launch_evaluation, render

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    field = generate_forest(np.random.default_rng(0), num_obstacles=3)
    calls = [
        lambda: render.render_depth_intensity([0.0, 0.0, 2.0], [[5.0, 0.0, 2.0]], [1.0]),
        lambda: render.render_rgbd_flow([0.0, 0.0, 2.0], [1.0, 0, 0], [0, 0, 0.0],
                                        [[5.0, 0.0, 2.0]], [1.0]),
        lambda: closed_loop.run_trial(field, max_steps=3),
        lambda: batched.run_trials_batched([field], max_steps=3),
        lambda: launch_evaluation.run_evaluation(1, max_steps=3, out_dir="/nonexistent"),
        lambda: vision_env.VecVisionEnv(_j_params()),
        lambda: quadrotor_env.VecQuadrotorEnv(),
        lambda: ppo.train_ppo(_j_params(), n_iters=1),
        lambda: ppo.ActorCritic(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
