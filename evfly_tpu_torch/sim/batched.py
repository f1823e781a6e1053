"""Lockstep batched closed-loop rollouts: G trials per device step.

Port of ``evfly_tpu/sim/batched.py``.  ``run_trial`` (closed_loop.py)
drives one trial; this module runs G trials in lockstep: per tick one
render + difflog of all G camera poses on the device (``_render_tick``: one
broadcast over G cameras, each trial with its own obstacle field padded to
a common K; the span ``evfly.sim.render``), and in vision/dagger modes one
``BatchedStreamingPipeline.step_frames`` that advances all G recurrent
policies at once (its LSTM one K4 or K5 launch for the G streams, inside
the pipeline's CUDA graph on the card).  Host work per tick is the
vectorized first-order dynamics, the (numpy) expert labels and one read of
the (G, 3) velocities.  The logged frames stay on the device, quantized
(depth and intensity to u8, events to int8 threshold counts), and are read
back in waves of ``fetch_every`` ticks.  ``BatchedTrials`` advances the
G trials one sensor tick at a time (``tick()``); ``run_trials_batched``
loops it to the end.

This replaces the reference's scaling mechanism, OpenMP-parallel sim envs
(flightmare vec_env_base.cpp:124,156, num_envs=100), for the full
sensor -> policy -> dynamics loop.

Modes (per-trial semantics identical to closed_loop.run_trial):
  state   expert commands, expert labels logged        -> training data
  planner occupancy-BFS + spline expert (sim/planner.py) commands + labels
  vision  policy commands (altitude hold + start ramp) -> protocol evaluation
  dagger  policy commands, EXPERT labels logged        -> DAgger aggregation
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.voxelizer import difflog_events
from ..utils import profiling
from .closed_loop import host_vector
from .evaluator import TrialEvaluator
from .expert import expert_velocity_command
from .obstacles import ObstacleField
from .render import render_depth_intensity


class BatchedQuads:
    """Vectorized VelocityTrackingQuad (sim/dynamics.py) over G quads."""

    def __init__(self, G: int, tau: float = 0.25, accel_limit: float = 12.0,
                 cmd_timeout: float = 0.5, start_pos=(0.0, 0.0, 2.0)):
        self.tau = tau
        self.accel_limit = accel_limit
        self.cmd_timeout = cmd_timeout
        self.G = G
        self.t = 0.0
        self.pos = np.tile(np.asarray(start_pos, float), (G, 1))
        self.vel = np.zeros((G, 3))
        self._cmd = np.zeros((G, 3))
        self._cmd_time = np.full(G, -np.inf)

    def set_commands(self, cmds: np.ndarray, mask: Optional[np.ndarray] = None):
        if mask is None:
            self._cmd = np.asarray(cmds, float)
            self._cmd_time[:] = self.t
        else:
            self._cmd[mask] = np.asarray(cmds, float)[mask]
            self._cmd_time[mask] = self.t

    def step(self, dt: float):
        stale = self.t - self._cmd_time > self.cmd_timeout
        cmd = np.where(stale[:, None], 0.0, self._cmd)
        accel = (cmd - self.vel) / self.tau
        a_norm = np.linalg.norm(accel, axis=1, keepdims=True)
        scale = np.where(a_norm > self.accel_limit, self.accel_limit / np.maximum(a_norm, 1e-9), 1.0)
        self.vel = self.vel + accel * scale * dt
        self.pos = self.pos + self.vel * dt
        self.t += dt
        return self.pos, self.vel, self.t


def pad_fields(fields: Sequence[ObstacleField], K_min: int = 0, device: DeviceLike = None):
    """Stack per-trial obstacles to (G, K, 3)/(G, K) tensors on ``device``;
    radius 0 = inert pad (the renderer and expert both treat radius <= 0
    as absent).  ``K_min`` pins a stable K across successive batches."""
    dev = resolve_device(device)
    K = max(max(len(f) for f in fields) + 1, K_min)  # +1: nonempty obstacle axis
    G = len(fields)
    centers = np.full((G, K, 3), 1e6, np.float32)
    radii = np.zeros((G, K), np.float32)
    for g, f in enumerate(fields):
        centers[g, : len(f)] = f.positions
        radii[g, : len(f)] = f.radii
    return torch.as_tensor(centers, device=dev), torch.as_tensor(radii, device=dev)


def _render_tick(cam_pos, centers, radii, prev_intensity, has_prev: bool, H: int, W: int,
                 is_trees: bool):
    """One lockstep sensor tick on the device of ``centers``: render G views
    and difflog each against its previous frame (zeros until ``has_prev``)."""
    dev = centers.device
    depth, intensity = render_depth_intensity(cam_pos, centers, radii, H=H, W=W,
                                              is_trees=is_trees, device=dev)
    events = difflog_events(intensity, prev_intensity, device=dev)
    if not has_prev:
        events = torch.zeros_like(events)
    return depth, intensity, events


def _render_tick_quantized(cam_pos, centers, radii, prev_intensity, has_prev: bool, H: int,
                           W: int, is_trees: bool):
    """_render_tick + quantization of the logged frames on the device:
    events to exact int8 difflog-threshold counts (difflog values are
    count x 0.2 by construction), depth and intensity to uint8, so the
    frames a trial logs equal the JAX package's and the host reads 8x fewer
    bytes.  The f32 intensity is returned as the next tick's difflog
    reference and the f32 events as the policy's input."""
    depth, intensity, events = _render_tick(
        cam_pos, centers, radii, prev_intensity, has_prev, H, W, is_trees
    )
    depth_u8 = torch.clamp(torch.round(depth * 255.0), 0, 255).to(torch.uint8)
    ev_i8 = torch.clamp(torch.round(events / 0.2), -127, 127).to(torch.int8)
    int_u8 = torch.clamp(torch.round(intensity * 255.0), 0, 255).to(torch.uint8)
    return intensity, events, depth_u8, ev_i8, int_u8


class BatchedTrials:
    """G trials in lockstep, advanced one sensor tick at a time: the loop
    body of ``run_trials_batched`` (same arguments), which is a loop of
    ``tick()`` then ``results()``.

    ``tick()`` runs the sim steps up to and including the next sensor tick:
    the dynamics and the evaluators at every sim step (and the state and
    planner commands between ticks), then at the tick the render + difflog
    + quantization (the span ``evfly.sim.render``), in vision and dagger
    modes one ``policy.step_frames``, the commands and the logged rows.  It
    returns False, without a tick, once every trial has ended or
    ``max_steps`` sim steps have run (``done``).  After a tick in a policy
    mode, ``last_frames`` (the (G, H, W) f32 events on the device),
    ``last_reset`` (the (G,) reset mask) and ``last_policy`` (the
    pipeline's velocities and depths, as it returned them) are what the
    policy was given and gave.
    """

    def __init__(
        self,
        fields: Sequence[ObstacleField],
        mode: str = "state",                 # 'state' | 'planner' | 'vision' | 'dagger'
        desired_vels=4.0,
        policy=None,                         # BatchedStreamingPipeline (vision/dagger)
        sim_dt: float = 0.01,
        policy_every: int = 6,               # ~16.7 Hz, the deployment's 15 Hz loop (run.py:43)
        command_every: Optional[int] = None, # state/planner command rate (defaults to
                                             # policy_every; datagen uses 3 = the expert's
                                             # 33 Hz sim rate so labels stay crash-free
                                             # while frames log at deployment rate)
        max_steps: int = 7000,
        H: int = 260,
        W: int = 346,
        seed: int = 0,
        log_images: bool = True,
        obstacle_pad: int = 0,
        fetch_every: int = 32,
        dynamics: str = "first_order",       # 'first_order' | 'rigid' (full stack)
        device: DeviceLike = None,
    ):
        self.dev = dev = resolve_device(device)
        self.fields = fields
        self.G = G = len(fields)
        self.mode, self.policy, self.sim_dt = mode, policy, sim_dt
        self.policy_every, self.max_steps = policy_every, max_steps
        self.H, self.W, self.log_images, self.fetch_every = H, W, log_images, fetch_every
        self.is_trees = fields[0].is_trees
        if command_every is None or mode in ("vision", "dagger"):
            command_every = policy_every  # policy modes need a frame per command
        self.command_every = command_every
        self.desired_vels = np.broadcast_to(np.asarray(desired_vels, float), (G,)).copy()
        self.rngs = [np.random.default_rng(seed + 977 * g) for g in range(G)]
        self.centers, self.radii = pad_fields(fields, K_min=obstacle_pad, device=dev)

        self.planners = None
        if mode == "planner":
            from .planner import PlannerExpert

            self.planners = [
                PlannerExpert(f, self.desired_vels[g]) for g, f in enumerate(fields)
            ]

        if dynamics == "rigid":
            # the full flight stack (velocity reference -> SE(3) controller ->
            # allocation + motor lag -> RK4 rigid body), vectorized over G; the
            # camera stays velocity-frame-aligned (position only), as in
            # run_trial(dynamics="rigid")
            from .rigid_body import VecRigidBodyQuads

            self.quads = VecRigidBodyQuads(G)
        else:
            self.quads = BatchedQuads(G)
        self.evals = [TrialEvaluator() for _ in range(G)]
        self.active = np.ones(G, bool)
        self.rows: List[List[List[float]]] = [[] for _ in range(G)]
        self.depth_frames: List[List[np.ndarray]] = [[] for _ in range(G)]
        self.intensity_frames: List[List[np.ndarray]] = [[] for _ in range(G)]
        self.event_frames: List[List[np.ndarray]] = [[] for _ in range(G)]

        self.prev_intensity = torch.zeros((G, H, W), device=dev)
        self.has_prev = False
        if policy is not None:
            policy.reset()
        self.need_images = log_images or mode in ("state", "planner", "dagger")

        # the quantized frames are read to the host in waves of fetch_every
        # ticks; pending holds device tensors, pending_active which trials were
        # live at each tick
        self.pending: List = []
        self.pending_active: List[np.ndarray] = []
        self.step_i = 0
        self.done = False
        self.last_frames = self.last_reset = self.last_policy = None

    def _drain(self):
        if not self.pending:
            return
        host = [t.cpu().numpy() for t in (torch.stack([p[i] for p in self.pending])
                                          for i in range(3))]
        for k, act in enumerate(self.pending_active):
            d_u8, e_i8, i_u8 = (h[k] for h in host)
            for g in range(self.G):
                if not act[g]:
                    continue
                self.depth_frames[g].append(d_u8[g].astype(np.float32) / 255.0)
                self.event_frames[g].append(e_i8[g].astype(np.float32) * 0.2)
                if self.log_images:
                    self.intensity_frames[g].append(i_u8[g].astype(np.float32) / 255.0)
        self.pending.clear()
        self.pending_active.clear()

    def tick(self) -> bool:
        """The sim steps up to and including the next sensor tick; False
        (and ``done``) where the trials ended first."""
        G, mode, fields, quads = self.G, self.mode, self.fields, self.quads
        active, evals, desired_vels = self.active, self.evals, self.desired_vels
        while not self.done and self.step_i < self.max_steps:
            step_i = self.step_i
            self.step_i += 1
            pos, vel, t = quads.step(self.sim_dt)
            for g in range(G):
                if active[g]:
                    active[g] = evals[g].update(t, pos[g], fields[g])
            if not active.any():
                break
            sensor_tick = step_i % self.policy_every == 0
            if not sensor_tick:
                if mode in ("state", "planner") and step_i % self.command_every == 0:
                    cmds = np.zeros((G, 3))
                    for g in range(G):
                        if not active[g]:
                            continue
                        if mode == "state":
                            cmds[g], _ = expert_velocity_command(
                                pos[g], fields[g], desired_vels[g], self.rngs[g]
                            )
                        else:
                            cmds[g] = self.planners[g].velocity_at(t, pos[g])
                    quads.set_commands(cmds, mask=active)
                continue
            self._sensor_tick(pos, vel, t)
            return True
        self.done = True
        return False

    def _sensor_tick(self, pos, vel, t):
        G, mode, fields = self.G, self.mode, self.fields
        active, desired_vels = self.active, self.desired_vels
        with profiling.span("evfly.sim.render"):
            intensity_d, events_d, depth_u8, ev_i8, int_u8 = _render_tick_quantized(
                torch.as_tensor(pos, dtype=torch.float32).to(self.dev), self.centers,
                self.radii, self.prev_intensity, self.has_prev, self.H, self.W, self.is_trees,
            )
        self.prev_intensity = intensity_d
        self.has_prev = True

        pol_vels = None
        if mode in ("vision", "dagger"):
            reset_mask = pos[:, 0] < 0.5  # hidden reset near start (run_competition.py:500-520)
            self.last_frames, self.last_reset = events_d, reset_mask
            self.last_policy = self.policy.step_frames(events_d, reset_mask=reset_mask)
            pol_vels = host_vector(self.last_policy[0])  # tiny: the only per-tick read
        if self.need_images:
            self.pending.append((depth_u8, ev_i8, int_u8))
            self.pending_active.append(active.copy())
            if len(self.pending) >= self.fetch_every:
                self._drain()

        cmds = np.zeros((G, 3))
        labels = np.zeros((G, 3))
        for g in range(G):
            if not active[g]:
                continue
            if mode in ("state", "dagger"):
                labels[g], _ = expert_velocity_command(
                    pos[g], fields[g], desired_vels[g], self.rngs[g]
                )
            elif mode == "planner":
                labels[g] = self.planners[g].velocity_at(t, pos[g])
            if mode in ("state", "planner"):
                cmds[g] = labels[g]
            else:
                cmd = pol_vels[g].copy()
                # z is unsupervised in training (the loss zeroes it,
                # learner.py:1065,1074); the deployment's altitude-hold P
                # control (run.py:303) and the start ramp
                # (run_competition.py:579-583) apply as in run_trial
                cmd[2] = 1.5 * (2.0 - pos[g, 2])
                if pos[g, 0] < 2.0:
                    cmd[0] = max(1.0, (pos[g, 0] / 2.0) * desired_vels[g])
                cmds[g] = cmd

        self.quads.set_commands(cmds, mask=active)

        for g in range(G):
            if not active[g]:
                continue
            margin = fields[g].nearest_margin(pos[g], self.evals[g].quad_radius)
            logged_vel = labels[g] if mode in ("state", "planner", "dagger") else cmds[g]
            self.rows[g].append(
                [len(self.rows[g]), t, desired_vels[g], 1.0, 0.0, 0.0, 0.0,
                 *pos[g], *vel[g], *logged_vel, 0.0, 0.0, 0.0, 0.0,
                 1.0 if margin < 0 else 0.0]
            )

    def results(self) -> List[Dict]:
        """A run_trial-style dict per trial, the pending frames read first."""
        self._drain()
        results = []
        for g in range(self.G):
            rows = self.rows[g]
            results.append(
                {
                    "summary": self.evals[g].summary(),
                    "log": np.array(rows, np.float32) if rows else np.zeros((0, 21), np.float32),
                    "depths": self.depth_frames[g],
                    "intensities": (self.intensity_frames[g] if self.intensity_frames[g]
                                    else self.depth_frames[g]),
                    "events": self.event_frames[g],
                }
            )
        return results


def run_trials_batched(fields: Sequence[ObstacleField], mode: str = "state", **kwargs
                       ) -> List[Dict]:
    """Run G trials in lockstep on ``device`` (CUDA unless the caller names
    another; the arguments are ``BatchedTrials``'); returns a
    run_trial-style dict per trial.

    In 'state'/'dagger' modes the logged velcmd columns hold the EXPERT
    label (the training target); in 'vision' they hold the executed policy
    command.
    """
    trials = BatchedTrials(fields, mode, **kwargs)
    while trials.tick():
        pass
    return trials.results()
