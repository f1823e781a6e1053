"""Train the RL path (PPO) at reference scale on one card and record an artifact.

Port of ``tools/train_rl.py`` over the port's ``sim/ppo.py``: the
reference's RL expert trains PPO over num_envs=100 OpenMP-stepped C++ envs
(flightpy configs/vision/config.yaml: num_envs 100); here an iteration
collects the rollout of all envs in lockstep on the device, computes GAE
and takes the clipped PPO update (``make_ppo_iteration``).  This driver runs
it at the same 100-env scale for either env family and writes the reward
history and a greedy-policy evaluation:

  * vision    — VisionEnv (55-dim obs, velocity actions) on a generated
                forest field; eval reports mean greedy return, mean final
                x-progress, and the in-bounds fraction at episode end.
  * quadrotor — QuadrotorEnv (15-dim obs, thrust/bodyrate actions),
                hover stabilization at (0,0,5); eval reports mean greedy
                return and the mean final distance to the hover goal.

The weights, the action noise, the auto-reset starts and the greedy
evaluation's starts are drawn from ``torch.Generator``s seeded from
``--seed`` (the JAX driver's from ``jax.random``: other draws, the same
distributions).

  python -m evfly_tpu_torch.tools.train_rl --env vision --iters 300 \\
      --out-json rl_vision.json [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device


def build_vision(args, device=None):
    from ..sim.obstacles import generate_forest
    from ..sim.ppo import vision_env_spec
    from ..sim.vision_env import EnvParams

    field = generate_forest(
        np.random.default_rng(args.seed), num_obstacles=args.obstacles
    )
    params = EnvParams(
        obstacle_pos=torch.as_tensor(field.positions, dtype=torch.float32),
        obstacle_radius=torch.as_tensor(field.radii, dtype=torch.float32),
        goal_vel=torch.tensor([4.0, 0.0, 0.0]),
        world_box=torch.tensor([[-5.0, -20.0, 0.0], [65.0, 20.0, 20.0]]),
        max_t=args.horizon_s,
    )
    spec = vision_env_spec(params, max_speed=5.0, device=device)
    return params, spec


def build_quadrotor(args, device=None):
    from ..sim.quadrotor_env import default_params, ppo_spec

    qparams = default_params(device)
    return ppo_spec(qparams), qparams


def _freeze(alive: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(alive.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


@torch.no_grad()
def greedy_rollout(spec, ac, states, n_steps: int):
    """Deterministic-policy rollout from ``states``: action = act_scale *
    tanh(actor_mean).  Rewards are masked after an env's first done
    (episodes do not reset), so the return is a true per-episode sum;
    finished envs keep their terminal state.  -> (states, return, alive)."""
    obs = spec.get_obs(states)
    n_envs = obs.shape[0]
    alive = torch.ones(n_envs, dtype=torch.bool, device=obs.device)
    ret = torch.zeros(n_envs, device=obs.device)
    for _ in range(n_steps):
        actions = torch.tanh(ac.mean(obs)) * spec.act_scale
        new_states, new_obs, rewards, dones = spec.step(states, actions)
        ret = ret + torch.where(alive, rewards, torch.zeros_like(rewards))
        # freeze finished envs (keep their terminal state for metrics)
        states = type(states)(*(_freeze(alive, n, o) for n, o in zip(new_states, states)))
        obs = torch.where(alive[:, None], new_obs, obs)
        alive = alive & ~dones
    return states, ret, alive


def greedy_eval(spec, ac, n_envs: int, n_steps: int, seed: int):
    """``greedy_rollout`` from ``n_envs`` starts drawn from a
    ``torch.Generator`` seeded with ``seed`` on the spec's device."""
    generator = torch.Generator(device=spec.device).manual_seed(seed)
    return greedy_rollout(spec, ac, spec.reset(generator, n_envs), n_steps)


def greedy_metrics(env: str, states, ret, alive, qparams=None) -> dict:
    """The artifact's greedy keys of the JAX driver."""
    ret = ret.cpu().numpy()
    alive = alive.cpu().numpy()
    result = {
        "greedy_return_mean": float(ret.mean()),
        "greedy_return_p10": float(np.percentile(ret, 10)),
    }
    pos = (states.pos if env == "vision" else states.p).cpu().numpy()
    if env == "vision":
        result["greedy_final_x_mean"] = float(pos[:, 0].mean())
        # final x >= 60 is the reference protocol's success line
        # (evaluation_config.yaml target=60); a course-crossing policy exits
        # the world box through a face at x >= 60, which sets done/alive=False
        result["greedy_crossed_course_frac"] = float((pos[:, 0] >= 60.0).mean())
        # alive at the end == still inside the box at the horizon (the
        # timeout terminal is excluded by stopping 2 steps early)
        result["greedy_inbounds_frac"] = float(alive.mean())
    else:
        goal = qparams.goal.cpu().numpy()
        dist = np.linalg.norm(pos - goal[None], axis=1)
        result["greedy_final_goal_dist_mean"] = float(dist.mean())
        result["greedy_final_goal_dist_p90"] = float(np.percentile(dist, 90))
    return result


def greedy_steps(env: str, horizon_s: float) -> int:
    """Vision: stop 2 steps before the timeout terminal so that ``alive``
    tells out-of-bounds exits from the episode's end (done fires on timeout
    at t >= max_t - dt); quadrotor: 500 steps."""
    return int(horizon_s / 0.02) - 2 if env == "vision" else 500


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", choices=["vision", "quadrotor"], default="vision")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--num-envs", type=int, default=100,
                    help="reference flightpy config: num_envs 100")
    ap.add_argument("--rollout", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obstacles", type=int, default=40)
    ap.add_argument("--horizon-s", type=float, default=20.0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out-json", default="")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (as --device cpu)")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ..sim.ppo import PPOConfig, init_actor_critic, make_ppo_iteration

    dev = resolve_device("cpu" if args.cpu else args.device)
    print(f"[RL] env={args.env} device={dev}", flush=True)

    qparams = None
    if args.env == "vision":
        _, spec = build_vision(args, dev)
    else:
        spec, qparams = build_quadrotor(args, dev)

    cfg = PPOConfig(
        num_envs=args.num_envs,
        rollout_len=args.rollout,
        lr=args.lr,
        max_speed=spec.act_scale,
    )
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    ac = init_actor_critic(generator, act_dim=spec.act_dim, obs_dim=spec.obs_dim, device=dev)
    optimizer = torch.optim.Adam(ac.parameters(), lr=cfg.lr)
    env_states = spec.reset(generator, cfg.num_envs)
    iteration = make_ppo_iteration(None, cfg, spec)

    history = []
    t_start = time.perf_counter()
    t0 = t_start
    for it in range(args.iters):
        ac, optimizer, env_states, metrics = iteration(ac, optimizer, env_states, generator)
        if it % 10 == 0 or it == args.iters - 1:
            # syncs; sorted, as the JAX driver's metrics pytree
            m = {k_: float(v) for k_, v in sorted(metrics.items())}
            m["iter"] = it
            m["wall_s"] = round(time.perf_counter() - t_start, 1)
            history.append(m)
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            sps = cfg.num_envs * cfg.rollout_len * (10 if it else 1) / dt
            print(
                f"[RL] it {it:4d} reward_mean {m['reward_mean']:+.4f} "
                f"done_frac {m['done_frac']:.3f} loss {m['loss']:.4f} "
                f"({sps:,.0f} env-steps/s)",
                flush=True,
            )

    states, ret, alive = greedy_eval(
        spec, ac, n_envs=args.num_envs, n_steps=greedy_steps(args.env, args.horizon_s),
        seed=args.seed + 1,
    )
    greedy = greedy_metrics(args.env, states, ret, alive, qparams)
    # the JAX driver's keys, in its order
    result = {
        "env": args.env,
        "num_envs": cfg.num_envs,
        "rollout_len": cfg.rollout_len,
        "iters": args.iters,
        "env_steps_total": args.iters * cfg.num_envs * cfg.rollout_len,
        "wall_s": round(time.perf_counter() - t_start, 1),
        "reward_mean_first": history[0]["reward_mean"],
        "reward_mean_last": history[-1]["reward_mean"],
        **{k: greedy.pop(k) for k in ("greedy_return_mean", "greedy_return_p10")},
        "history": history,
        **greedy,
    }

    line = json.dumps({k: v for k, v in result.items() if k != "history"})
    print(f"[RL] final: {line}", flush=True)
    if args.out_json:
        with open(args.out_json, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"[RL] wrote {args.out_json}", flush=True)
    return result, ac


if __name__ == "__main__":
    main()
