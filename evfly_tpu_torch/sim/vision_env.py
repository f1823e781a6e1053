"""VisionEnv: gym-style RL environment over a batch of envs.

Port of ``evfly_tpu/sim/vision_env.py``, a rebuild of flightlib's
VisionEnv + its OpenMP-vectorized wrapper (vision_env.cpp,
vec_env_base.cpp:124-156, ``num_envs: 100``).  Every function takes the
state of all envs with the env axis leading, so one call steps the whole
batch with torch ops on the state's device.

Parity with the reference contract:

* observation = [goal_vel(3), R(9) row-major, v(3),
  10 nearest obstacles x (relative pos(3), radius)] = 55 dims
  (vision_env.cpp:153-265, kNObstacles=10), obstacle distances clamped to
  max_detection_range.
* reward components (vision_env.cpp:402-442, config.yaml rewards):
  vel_coeff * ||v - goal_v|| + sum collision_coeff * exp(-dist) over nearby
  obstacles (margin 0.5) + angular_vel_coeff * ||w|| + survive_rew,
  with defaults -0.01 / -0.01 / -0.0001 / 0.03.
* terminal on timeout or leaving the world box (+-0.1 threshold), terminal
  reward -1 for the box exit (vision_env.cpp:444-471).

Divergence (documented in the JAX package): actions are world-frame
velocity commands tracked by the first-order model of sim/dynamics.py, so
the angular velocity is 0 and its penalty term inert.

The JAX package draws the reset from ``jax.random``; here ``reset`` draws
from an explicit ``torch.Generator`` on the state's device, so the same
seed gives other starts (``reset_from_uniform`` maps given uniforms).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import DeviceLike, resolve_device

N_OBSTACLES = 10
OBS_DIM = 15 + N_OBSTACLES * 4


class EnvParams(NamedTuple):
    obstacle_pos: torch.Tensor     # (K, 3)
    obstacle_radius: torch.Tensor  # (K,)
    goal_vel: torch.Tensor         # (3,)
    world_box: torch.Tensor        # (2, 3) [min; max]
    max_detection_range: float = 10.0
    sim_dt: float = 0.02
    max_t: float = 30.0
    tau: float = 0.25
    vel_coeff: float = -0.01
    collision_coeff: float = -0.01
    angular_vel_coeff: float = -0.0001
    survive_rew: float = 0.03


class EnvState(NamedTuple):
    pos: torch.Tensor   # (N, 3)
    vel: torch.Tensor   # (N, 3)
    t: torch.Tensor     # (N,)
    done: torch.Tensor  # (N,) bool


def params_to(params: EnvParams, device: DeviceLike = None) -> EnvParams:
    """``params`` with its tensors as f32 on ``device`` (CUDA unless the
    caller names another)."""
    dev = resolve_device(device)
    return params._replace(**{
        name: torch.as_tensor(getattr(params, name), dtype=torch.float32, device=dev)
        for name in ("obstacle_pos", "obstacle_radius", "goal_vel", "world_box")})


def _norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(x * x)) over the last axis, as jnp.linalg.norm."""
    return torch.sqrt((x * x).sum(-1))


def reset_from_uniform(params: EnvParams, u_pos: torch.Tensor, u_vel: torch.Tensor
                       ) -> EnvState:
    """The randomized start near the corridor entrance (vision_env.cpp:118-147)
    from uniforms in [0, 1): u_pos, u_vel (N, 3)."""
    dev = params.goal_vel.device
    lo = torch.tensor([0.0, 0.0, 2.0], device=dev)
    spread = torch.tensor([1.0, 2.0, 0.5], device=dev)
    pos = lo + torch.clamp_min(u_pos * 1.0 + -0.5, -0.5) * spread
    vel = torch.clamp_min(u_vel * 0.2 + -0.1, -0.1)
    n = pos.shape[0]
    return EnvState(pos=pos, vel=vel, t=torch.zeros(n, device=dev),
                    done=torch.zeros(n, dtype=torch.bool, device=dev))


def reset(params: EnvParams, generator: torch.Generator, num_envs: int) -> EnvState:
    """``num_envs`` randomized starts, drawn from ``generator`` (on the
    device of ``params``)."""
    dev = params.goal_vel.device
    u_pos = torch.rand(num_envs, 3, generator=generator, device=dev)
    u_vel = torch.rand(num_envs, 3, generator=generator, device=dev)
    return reset_from_uniform(params, u_pos, u_vel)


def _obstacle_obs(params: EnvParams, pos: torch.Tensor):
    """The 10 nearest obstacles of each env (N, 3): (obs block (N, 40),
    clamped distances (N, 10), radii (N, 10)).  Padded to 10 with far-away
    zero-radius dummies (vision_env.cpp pads missing obstacles the same
    way); the order is a stable sort, as jnp.argsort, so ties keep the
    obstacles' order."""
    centers, radii = params.obstacle_pos, params.obstacle_radius
    pad = max(N_OBSTACLES - centers.shape[0], 0)
    if pad:
        centers = torch.cat([centers, torch.full((pad, 3), 1e6, dtype=centers.dtype,
                                                 device=centers.device)])
        radii = torch.cat([radii, torch.zeros(pad, dtype=radii.dtype, device=radii.device)])
    rel = centers[None] - pos[:, None, :]                       # (N, K, 3)
    dist = _norm(rel)                                           # (N, K)
    dist_clamped = torch.clamp_max(dist, params.max_detection_range)
    take = torch.argsort(dist, dim=1, stable=True)[:, :N_OBSTACLES]
    rel_n = torch.gather(rel, 1, take[..., None].expand(-1, -1, 3))
    rad_n = radii[take]
    obst = torch.cat([rel_n, rad_n[..., None]], dim=-1).reshape(pos.shape[0], -1)
    return obst, torch.gather(dist_clamped, 1, take), rad_n


def get_obs(params: EnvParams, state: EnvState) -> torch.Tensor:
    """(N, 55) observations."""
    n = state.pos.shape[0]
    dev = state.pos.device
    ori = torch.eye(3, device=dev).reshape(-1)  # level attitude under velocity tracking
    obst, _, _ = _obstacle_obs(params, state.pos)
    return torch.cat([params.goal_vel.expand(n, 3), ori.expand(n, 9), state.vel, obst], dim=1)


def compute_reward(params: EnvParams, state: EnvState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (total (N,), components (N, 5)) like vision_env.cpp:402-442."""
    _, dists, radii = _obstacle_obs(params, state.pos)
    near = dists <= radii + 0.5
    collision_penalty = torch.where(
        near, params.collision_coeff * torch.exp(-1.0 * dists), 0.0).sum(-1)
    lin_vel_reward = params.vel_coeff * _norm(state.vel - params.goal_vel)
    ang_vel_penalty = torch.full_like(lin_vel_reward, params.angular_vel_coeff * 0.0)
    survive = torch.full_like(lin_vel_reward, params.survive_rew)
    total = lin_vel_reward + collision_penalty + ang_vel_penalty + params.survive_rew
    comps = torch.stack([lin_vel_reward, collision_penalty, ang_vel_penalty, survive, total],
                        dim=-1)
    return total, comps


def step(params: EnvParams, state: EnvState, action: torch.Tensor):
    """One env step of every env with velocity-command actions (N, 3) ->
    (state, obs, reward, done)."""
    accel = (action - state.vel) / params.tau
    a_norm = _norm(accel)[:, None]
    accel = torch.where(a_norm > 12.0, accel / a_norm * 12.0, accel)
    vel = state.vel + accel * params.sim_dt
    pos = state.pos + vel * params.sim_dt
    t = state.t + params.sim_dt

    timeout = t >= params.max_t - params.sim_dt
    thr = 0.1
    inside = ((pos >= params.world_box[0] + thr).all(-1)
              & (pos <= params.world_box[1] - thr).all(-1))
    done = timeout | ~inside

    new_state = EnvState(pos=pos, vel=vel, t=t, done=done)
    reward, _ = compute_reward(params, new_state)
    reward = torch.where(~inside, -1.0, torch.where(timeout, 0.0, reward))
    return new_state, get_obs(params, new_state), reward, done


class VecVisionEnv:
    """Batched VisionEnv: all envs share the obstacle field; one call steps
    them all on ``device`` (CUDA unless the caller names another)."""

    def __init__(self, params: EnvParams, num_envs: int = 100, device: DeviceLike = None):
        self.params = params_to(params, device)
        self.device = self.params.goal_vel.device
        self.num_envs = num_envs

    def reset(self, generator: torch.Generator):
        """Reset every env from ``generator`` (on the env's device) ->
        (states, obs)."""
        states = reset(self.params, generator, self.num_envs)
        return states, get_obs(self.params, states)

    def step(self, states: EnvState, actions: torch.Tensor):
        return step(self.params, states, actions)
