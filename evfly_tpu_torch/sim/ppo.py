"""PPO over VecVisionEnv (or QuadrotorEnv): the flightpy/flightrl RL path.

Port of ``evfly_tpu/sim/ppo.py``.  The reference's legacy RL expert trains
PPO over 100 OpenMP-stepped C++ envs (flightmare/flightpy/flightrl
rpg_baselines ppo/on_policy_algorithm).  Here an iteration collects a
rollout of all envs in lockstep on one device (a Python loop over the
rollout's steps where the JAX package scans), computes GAE in a reverse
loop, and takes ``epochs_per_iter`` full-batch steps of the clipped
objective with ``torch.optim.Adam`` (the JAX package's ``optax.adam``: the
same update, eps outside the square root, bias-corrected).

Standard PPO (clip 0.2, GAE lambda=0.95, gamma=0.99), MLP actor-critic over
the 55-dim VisionEnv observation, continuous 3-D velocity actions through a
tanh squash scaled to the commanded speed range.

Random draws: the JAX package draws the initial weights, the action noise
and the auto-reset starts from ``jax.random``; here they come from an
explicit ``torch.Generator`` on the envs' device, so one seed gives other
draws.  Every draw enters through an explicit tensor
(``sample_with_noise``; an iteration's ``noise`` and ``resets``), so the
same weights (``actor_critic_from_jax``), states and draws give the JAX
package's iteration.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..precision import with_precision
from .vision_env import OBS_DIM, EnvParams, get_obs, params_to, reset, step


class EnvSpec(NamedTuple):
    """The environment surface of the PPO loop, over all envs at once.

    reset(generator, num_envs) -> state; step(state, action) -> (state,
    obs, reward, done); get_obs(state) -> obs.  Actions arrive
    tanh-squashed in [-act_scale, act_scale]^act_dim.  The default spec is
    VisionEnv (velocity actions); quadrotor_env.ppo_spec adapts the legacy
    state-based env (normalized thrust/bodyrate actions, act_scale=1).
    ``device`` is where the env's tensors live.
    """

    reset: object
    step: object
    get_obs: object
    obs_dim: int
    act_dim: int
    act_scale: float
    device: Optional[torch.device] = None


def vision_env_spec(env_params: EnvParams, max_speed: float = 5.0,
                    device: DeviceLike = None) -> EnvSpec:
    """VisionEnv's spec on ``device`` (CUDA unless the caller names
    another)."""
    params = params_to(env_params, device)
    return EnvSpec(
        reset=functools.partial(reset, params),
        step=functools.partial(step, params),
        get_obs=functools.partial(get_obs, params),
        obs_dim=OBS_DIM,
        act_dim=3,
        act_scale=max_speed,
        device=params.goal_vel.device,
    )


def _mlp(sizes: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


class ActorCritic(nn.Module):
    """MLP actor (obs -> action mean), MLP critic (obs -> value) and a
    state-independent log std, as the JAX package's ``ActorCritic``
    (``actor``/``critic`` dicts of w{i} (in, out), b{i}; here
    ``nn.Linear`` layers, weights (out, in))."""

    def __init__(self, hidden=(128, 128), act_dim: int = 3, obs_dim: int = OBS_DIM,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.actor = _mlp((obs_dim, *hidden, act_dim)).to(dev)
        self.critic = _mlp((obs_dim, *hidden, 1)).to(dev)
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.5, device=dev))
        self.act_dim = act_dim

    def mean(self, obs: torch.Tensor) -> torch.Tensor:
        return _mlp_apply(self.actor, obs)

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return _mlp_apply(self.critic, obs)[..., 0]


def init_actor_critic(generator: torch.Generator, hidden=(128, 128), act_dim: int = 3,
                      obs_dim: int = OBS_DIM, device: DeviceLike = None) -> ActorCritic:
    """An ActorCritic with the JAX package's initialization: each weight
    N(0, 2 / fan_in), biases 0, log std -0.5; drawn from ``generator`` (on
    ``device``)."""
    ac = ActorCritic(hidden, act_dim, obs_dim, device)
    dev = ac.log_std.device
    with torch.no_grad():
        for layers in (ac.actor, ac.critic):
            for layer in layers:
                fan_in, fan_out = layer.in_features, layer.out_features
                w = torch.randn(fan_in, fan_out, generator=generator, device=dev)
                layer.weight.copy_((w * math.sqrt(2.0 / fan_in)).T)
                layer.bias.zero_()
    return ac


def actor_critic_from_jax(ac_jax, device: DeviceLike = None) -> ActorCritic:
    """The JAX package's ``ActorCritic`` (dicts of arrays w{i} (in, out),
    b{i}, and log_std) as an ``ActorCritic`` on ``device``: each weight
    transposed into ``nn.Linear``'s (out, in)."""
    actor, critic = dict(ac_jax.actor), dict(ac_jax.critic)
    n = len([k for k in actor if k.startswith("w")])
    w = lambda p, i: np.array(p[f"w{i}"], np.float32)
    sizes = [w(actor, 0).shape[0]] + [w(actor, i).shape[1] for i in range(n)]
    ac = ActorCritic(tuple(sizes[1:-1]), sizes[-1], sizes[0], device)
    dev = ac.log_std.device
    with torch.no_grad():
        for layers, p in ((ac.actor, actor), (ac.critic, critic)):
            for i, layer in enumerate(layers):
                layer.weight.copy_(torch.as_tensor(w(p, i).T, device=dev))
                layer.bias.copy_(torch.as_tensor(np.array(p[f"b{i}"], np.float32),
                                                 device=dev))
        ac.log_std.copy_(torch.as_tensor(np.array(ac_jax.log_std, np.float32), device=dev))
    return ac


def _half_log_2pi(like: torch.Tensor, e: bool = False) -> torch.Tensor:
    """0.5 * log(2 pi) (or log(2 pi e)) with the log taken in f32, as the
    JAX package takes it."""
    x = 2 * math.pi * (math.e if e else 1.0)
    return 0.5 * torch.log(torch.tensor(x, dtype=torch.float32, device=like.device))


def _gauss_logp(ac: ActorCritic, mean: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    std = torch.exp(ac.log_std)
    return (-0.5 * torch.square((raw - mean) / std) - ac.log_std
            - _half_log_2pi(raw)).sum(-1)


def sample_with_noise(ac: ActorCritic, obs: torch.Tensor, noise: torch.Tensor,
                      max_speed: float = 5.0):
    """``policy_sample`` with its standard normal draw given: noise
    (N, act_dim) -> (action, raw, logp, value)."""
    mean = ac.mean(obs)
    raw = mean + torch.exp(ac.log_std) * noise
    action = torch.tanh(raw) * max_speed
    return action, raw, _gauss_logp(ac, mean, raw), ac.value(obs)


def policy_sample(ac: ActorCritic, obs: torch.Tensor, generator: Optional[torch.Generator] = None,
                  max_speed: float = 5.0):
    """Sample squashed actions for obs (N, obs_dim), the noise drawn from
    ``generator`` -> (action, raw, logp, value)."""
    noise = torch.randn(obs.shape[0], ac.act_dim, generator=generator, device=obs.device)
    return sample_with_noise(ac, obs, noise, max_speed)


def _logp_of(ac: ActorCritic, obs: torch.Tensor, raw: torch.Tensor):
    """(logp of raw, value, entropy) under the current weights."""
    logp = _gauss_logp(ac, ac.mean(obs), raw)
    entropy = (ac.log_std + _half_log_2pi(raw, e=True)).sum()
    return logp, ac.value(obs), entropy


class PPOConfig(NamedTuple):
    num_envs: int = 64
    rollout_len: int = 64
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coeff: float = 0.5
    ent_coeff: float = 0.001
    lr: float = 3e-4
    epochs_per_iter: int = 4
    max_speed: float = 5.0


def _pick(done: torch.Tensor, a, b):
    """Per env, state ``a`` where ``done`` else ``b`` (NamedTuples of (N, ...)
    tensors)."""
    return type(a)(*(torch.where(done.reshape(-1, *(1,) * (x.dim() - 1)), x, y)
                     for x, y in zip(a, b)))


def gae(cfg: PPOConfig, values: torch.Tensor, rewards: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor) -> torch.Tensor:
    """Generalized advantage estimates (T, N), a reverse loop over the
    rollout's T steps."""
    adv_next, v_next = torch.zeros_like(last_value), last_value
    advs = []
    for t in range(values.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t].float()
        delta = rewards[t] + cfg.gamma * v_next * nonterminal - values[t]
        adv_next = delta + cfg.gamma * cfg.gae_lambda * nonterminal * adv_next
        v_next = values[t]
        advs.append(adv_next)
    return torch.stack(advs[::-1])


def ppo_loss(cfg: PPOConfig, ac: ActorCritic, batch):
    """(clipped objective + value loss - entropy bonus, (pg, vf)) over a
    flat batch (obs, raw, logp_old, adv, ret)."""
    obs, raw, logp_old, adv, ret = batch
    logp, value, entropy = _logp_of(ac, obs, raw)
    ratio = torch.exp(logp - logp_old)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n,
    ).mean()
    vf = torch.square(value - ret).mean()
    return pg + cfg.vf_coeff * vf - cfg.ent_coeff * entropy, (pg, vf)


def make_ppo_iteration(env_params: Optional[EnvParams], cfg: PPOConfig,
                       spec: Optional[EnvSpec] = None):
    """Returns iteration(ac, optimizer, env_states, generator=None,
    noise=None, resets=None) -> (ac, optimizer, env_states, metrics), which
    updates ``ac`` and ``optimizer`` in place.

    The draws come from ``generator``, or are given: ``noise``
    (rollout_len, num_envs, act_dim) standard normals, ``resets`` a
    sequence of rollout_len states of all envs, the starts of the envs that
    finish at each step.  ``env_params`` is read only without ``spec``."""
    spec = spec or vision_env_spec(env_params, cfg.max_speed)

    @torch.no_grad()
    def collect(ac, env_states, generator, noise, resets):
        obs = spec.get_obs(env_states)
        traj = []
        for t in range(cfg.rollout_len):
            if noise is None:
                actions, raw, logp, value = policy_sample(ac, obs, generator, spec.act_scale)
            else:
                actions, raw, logp, value = sample_with_noise(ac, obs, noise[t], spec.act_scale)
            new_states, _new_obs, rewards, dones = spec.step(env_states, actions)
            # auto-reset finished envs
            reset_states = (resets[t] if resets is not None
                            else spec.reset(generator, cfg.num_envs))
            env_states = _pick(dones, reset_states, new_states)
            traj.append((obs, raw, logp, value, rewards, dones))
            obs = spec.get_obs(env_states)
        return env_states, obs, [torch.stack(x) for x in zip(*traj)]

    @with_precision
    def iteration(ac: ActorCritic, optimizer: torch.optim.Optimizer, env_states,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None, resets=None):
        env_states, last_obs, (obs, raw, logp, value, rewards, dones) = collect(
            ac, env_states, generator, noise, resets)
        with torch.no_grad():
            last_value = ac.value(last_obs)
            advs = gae(cfg, value, rewards, dones, last_value)
            rets = advs + value

        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        batch = (flat(obs), flat(raw), flat(logp), flat(advs), flat(rets))
        for _ in range(cfg.epochs_per_iter):
            loss, (pg, vf) = ppo_loss(cfg, ac, batch)
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
        metrics = {
            "reward_mean": rewards.mean(),
            "loss": loss.detach(),
            "pg_loss": pg.detach(),
            "vf_loss": vf.detach(),
            "done_frac": dones.float().mean(),
        }
        return ac, optimizer, env_states, metrics

    return iteration


def train_ppo(env_params: Optional[EnvParams], cfg: PPOConfig = PPOConfig(),
              n_iters: int = 50, seed: int = 0, spec: Optional[EnvSpec] = None,
              device: DeviceLike = None) -> Tuple[ActorCritic, List[Dict[str, float]]]:
    """Run PPO on ``device`` (CUDA unless the caller names another; a
    ``spec``'s own device where it has one); returns (actor_critic, list of
    per-iteration metrics).  Weights, noise and resets are drawn from one
    ``torch.Generator`` seeded with ``seed``."""
    spec = spec or vision_env_spec(env_params, cfg.max_speed, device)
    dev = spec.device if spec.device is not None else resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    ac = init_actor_critic(generator, act_dim=spec.act_dim, obs_dim=spec.obs_dim, device=dev)
    optimizer = torch.optim.Adam(ac.parameters(), lr=cfg.lr)
    env_states = spec.reset(generator, cfg.num_envs)
    iteration = make_ppo_iteration(env_params, cfg, spec)
    history = []
    for _ in range(n_iters):
        ac, optimizer, env_states, metrics = iteration(ac, optimizer, env_states, generator)
        history.append({k: float(v) for k, v in metrics.items()})
    return ac, history
