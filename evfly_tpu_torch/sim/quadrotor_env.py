"""QuadrotorEnv: state-based RL environment (the legacy agile_flight path).

Port of ``evfly_tpu/sim/quadrotor_env.py``, a behavioral rebuild of
flightmare's quadrotor_env.cpp (obs/reset :89-154, step/reward :155-199,
terminals :201-213), the stabilization env flightrl's PPO trained before
the vision task existed.  Semantics preserved:

- observation (15): position(3), rotation matrix row-major(9), velocity(3)
  (quadrotor_env.cpp:132-153).
- reset: p_xy ~ U(-1,1), p_z ~ U(-1,1)+5 mirrored positive, v ~ U(-1,1)^3,
  attitude = normalized U(-1,1)^4 quaternion, motors at rest (:89-128).
- actions, rotor_ctrl=1 (bodyrate mode): normalized [-1,1]^4 ->
  collective mass-normalized thrust + bodyrates via act*std+mean with
  mean=[(f_max/m)/2,0,0,0], std=[(f_max/m)/2, omega_max] (:78-86); the
  simple LLC (bodyrate P -> torque -> allocation, clamped) tracks them.
- actions, rotor_ctrl=0: per-rotor thrusts, mean=std=single_thrust_max/2
  (:73-76).
- reward vector (5): [pos, ori, lin_vel, ang_vel, total] with the shipped
  coefficients (flightpy/configs/control/config.yaml), goal (0,0,5)
  (:180-197); ori is the rotation's total angle from identity,
  2 acos(|q_w|).
- terminals: z <= 0.02 -> terminal reward -1; episode time over max_t ->
  0 (:201-213).

Every function takes the state of all envs with the env axis leading and
steps an RK4 rigid body (the agilicious constants of sim/rigid_body.py)
with torch ops on the state's device.  ``reset`` draws from an explicit
``torch.Generator`` (the JAX package draws from ``jax.random``);
``reset_from_uniform`` maps given uniforms.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .rigid_body import QuadrotorParams

G = 9.8066


class QuadEnvParams(NamedTuple):
    goal: torch.Tensor           # (3,) == (0, 0, 5)
    pos_coeff: float = -0.002
    ori_coeff: float = -0.002
    lin_vel_coeff: float = -0.0001
    ang_vel_coeff: float = -0.0001
    sim_dt: float = 0.02
    max_t: float = 5.0
    rotor_ctrl: int = 1          # 1 = collective thrust + bodyrates
    kp_rate: float = 20.0


def default_params(device: DeviceLike = None, **over) -> QuadEnvParams:
    """The shipped parameters, the goal on ``device`` (CUDA unless the
    caller names another)."""
    goal = torch.tensor([0.0, 0.0, 5.0], dtype=torch.float32, device=resolve_device(device))
    return QuadEnvParams(goal=goal)._replace(**over)


class QuadEnvState(NamedTuple):
    p: torch.Tensor     # (N, 3)
    v: torch.Tensor     # (N, 3)
    q: torch.Tensor     # (N, 4) wxyz
    w: torch.Tensor     # (N, 3) body rates
    t: torch.Tensor     # (N,)


# the agilicious constants (rigid_body.QuadrotorParams), as f32
_QP = QuadrotorParams()
_CONSTS = dict(
    J=_QP.J, J_INV=np.linalg.inv(_QP.J), ALLOC=_QP.allocation,
    ALLOC_INV=np.linalg.inv(_QP.allocation), OMEGA_MAX=_QP.omega_max,
    GVEC=np.array([0.0, 0.0, -G]),
)
_THRUST_MAX = float(_QP.thrust_max)
_MASS = float(_QP.mass)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in _CONSTS.items()}


def _norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(x * x)) over the last axis, as jnp.linalg.norm."""
    return torch.sqrt((x * x).sum(-1))


def _matvec(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m @ x for each row x of (N, n)."""
    return x @ m.T


def _quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _quat_rotate(q, v):
    u = q[..., 1:]
    return v + 2.0 * torch.cross(u, torch.cross(u, v, dim=-1) + q[..., :1] * v, dim=-1)


def _rotmat(q):
    """(N, 4) quaternions -> (N, 3, 3) rotation matrices."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _dstate(p, v, q, w, thrusts, c):
    wrench = _matvec(c["ALLOC"], thrusts)
    zero = torch.zeros_like(wrench[:, :1])
    dv = _quat_rotate(q, torch.cat([zero, zero, wrench[:, :1] / _MASS], -1)) + c["GVEC"]
    dq = 0.5 * _quat_mul(q, torch.cat([zero, w], -1))
    dw = _matvec(c["J_INV"], wrench[:, 1:] - torch.cross(w, _matvec(c["J"], w), dim=-1))
    return v, dv, dq, dw


def _rk4(p, v, q, w, thrusts, dt, c):
    s0 = (p, v, q, w)
    k1 = _dstate(*s0, thrusts, c)
    k2 = _dstate(*(a + 0.5 * dt * b for a, b in zip(s0, k1)), thrusts, c)
    k3 = _dstate(*(a + 0.5 * dt * b for a, b in zip(s0, k2)), thrusts, c)
    k4 = _dstate(*(a + dt * b for a, b in zip(s0, k3)), thrusts, c)
    p, v, q, w = (
        a + dt / 6.0 * (b1 + 2 * b2 + 2 * b3 + b4)
        for a, b1, b2, b3, b4 in zip(s0, k1, k2, k3, k4)
    )
    return p, v, q / _norm(q)[:, None], w


def reset_from_uniform(params: QuadEnvParams, u_p, u_v, u_q) -> QuadEnvState:
    """quadrotor_env.cpp:89-128 from uniforms in [0, 1): u_p, u_v (N, 3),
    u_q (N, 4)."""
    pxy_z = torch.clamp_min(u_p * 2.0 + -1.0, -1.0)
    pz = (pxy_z[:, 2] + 5.0).abs()  # z = U(-1,1)+5, mirrored positive
    p = torch.stack([pxy_z[:, 0], pxy_z[:, 1], pz], -1)
    v = torch.clamp_min(u_v * 2.0 + -1.0, -1.0)
    q = torch.clamp_min(u_q * 2.0 + -1.0, -1.0)
    q = q / _norm(q)[:, None]
    n = p.shape[0]
    return QuadEnvState(p=p, v=v, q=q, w=torch.zeros(n, 3, device=p.device),
                        t=torch.zeros(n, device=p.device))


def reset(params: QuadEnvParams, generator: torch.Generator, num_envs: int) -> QuadEnvState:
    """``num_envs`` random starts drawn from ``generator`` (on the device
    of ``params.goal``)."""
    dev = params.goal.device
    u_p = torch.rand(num_envs, 3, generator=generator, device=dev)
    u_v = torch.rand(num_envs, 3, generator=generator, device=dev)
    u_q = torch.rand(num_envs, 4, generator=generator, device=dev)
    return reset_from_uniform(params, u_p, u_v, u_q)


def get_obs(params: QuadEnvParams, state: QuadEnvState) -> torch.Tensor:
    """(N, 15): p, R (row-major), v (quadrotor_env.cpp:132-153)."""
    return torch.cat([state.p, _rotmat(state.q).reshape(-1, 9), state.v], dim=-1)


def _denormalize_action(params: QuadEnvParams, act: torch.Tensor, c):
    if params.rotor_ctrl == 0:
        mean = std = _THRUST_MAX / 2.0
        return act * std + mean  # per-rotor thrusts
    c_mean = (_THRUST_MAX * 4.0 / _MASS) / 2.0
    mean = torch.tensor([c_mean, 0.0, 0.0, 0.0], device=act.device)
    std = torch.cat([torch.tensor([c_mean], device=act.device), c["OMEGA_MAX"]])
    return act * std + mean  # [mass-norm collective, bodyrates]


def step(params: QuadEnvParams, state: QuadEnvState, action: torch.Tensor):
    """One sim_dt step of every env with actions (N, 4).  Returns
    (new_state, obs, reward5 (N, 5), done, final_rew).

    reward5 = [pos, ori, lin_vel, ang_vel, total] (quadrotor_env.cpp:178-197);
    final_rew is the terminal bonus (-1 ground hit / 0 timeout) the vec
    wrapper adds, matching isTerminalState (:201-213)."""
    c = _consts(state.p.device)
    pi_act = _denormalize_action(params, action, c)
    if params.rotor_ctrl == 0:
        thrusts = torch.clamp(pi_act, 0.0, _THRUST_MAX)
    else:
        # simple LLC: bodyrate P -> torque; allocation -> clamped thrusts
        c_thrust = pi_act[:, :1] * _MASS
        tau = _matvec(c["J"], params.kp_rate * (pi_act[:, 1:] - state.w)) + torch.cross(
            state.w, _matvec(c["J"], state.w), dim=-1)
        thrusts = _matvec(c["ALLOC_INV"], torch.cat([c_thrust, tau], -1))
        thrusts = torch.clamp(thrusts, 0.0, _THRUST_MAX)

    p, v, q, w = _rk4(state.p, state.v, state.q, state.w, thrusts, params.sim_dt, c)
    new_state = QuadEnvState(p=p, v=v, q=q, w=w, t=state.t + params.sim_dt)

    pos_r = params.pos_coeff * _norm(p - params.goal)
    # rotation angle from identity: |angle| = 2 acos(|q_w|), zero exactly
    # when the reference's eulerAngles(2,1,0).norm() is zero
    ang = 2.0 * torch.arccos(torch.clamp(q[:, 0].abs(), 0.0, 1.0))
    ori_r = params.ori_coeff * ang
    lin_r = params.lin_vel_coeff * _norm(v)
    ang_r = params.ang_vel_coeff * _norm(w)
    total = pos_r + ori_r + lin_r + ang_r
    reward5 = torch.stack([pos_r, ori_r, lin_r, ang_r, total], dim=-1)

    hit_ground = p[:, 2] <= 0.02
    timeout = new_state.t >= params.max_t - params.sim_dt
    done = hit_ground | timeout
    final_rew = torch.where(hit_ground, -1.0, 0.0)
    return new_state, get_obs(params, new_state), reward5, done, final_rew


def ppo_spec(params: Optional[QuadEnvParams] = None, device: DeviceLike = None):
    """EnvSpec for sim.ppo.train_ppo: normalized [-1,1]^4 actions
    (act_scale=1: the tanh squash IS the reference's normalization), scalar
    reward = total shaped reward + terminal bonus, like the flightrl vec
    wrapper's summed reward channel.  Runs on the device of
    ``params.goal`` (``default_params(device)`` without ``params``)."""
    from .ppo import EnvSpec

    params = params or default_params(device)

    def step_scalar(state, action):
        new_state, obs, r5, done, fin = step(params, state, action)
        return new_state, obs, r5[:, 4] + fin, done

    return EnvSpec(
        reset=functools.partial(reset, params),
        step=step_scalar,
        get_obs=functools.partial(get_obs, params),
        obs_dim=15,
        act_dim=4,
        act_scale=1.0,
        device=params.goal.device,
    )


class VecQuadrotorEnv:
    """Batched QuadrotorEnv: one call steps every env on ``device`` (CUDA
    unless the caller names another), the replacement for the OpenMP vec
    env (vec_env_base.cpp:124)."""

    def __init__(self, params: Optional[QuadEnvParams] = None, num_envs: int = 100,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        params = params or default_params(dev)
        self.params = params._replace(goal=torch.as_tensor(params.goal, dtype=torch.float32,
                                                           device=dev))
        self.device = dev
        self.num_envs = num_envs

    def reset(self, generator: torch.Generator):
        """Reset every env from ``generator`` (on the env's device) ->
        (states, obs)."""
        states = reset(self.params, generator, self.num_envs)
        return states, get_obs(self.params, states)

    def step(self, states: QuadEnvState, actions: torch.Tensor):
        return step(self.params, states, actions)
