"""ROS-free closed-loop rollouts: expert data collection and vision evaluation.

Port of ``evfly_tpu/sim/closed_loop.py``.  It replaces the reference's
sim-in-the-loop harness (launch_evaluation.bash + run_competition.py +
evaluation_node.py) with an in-process loop:

  render (analytic, ``render``) -> difflog events (run_competition.py:603-635
  semantics) -> policy (the expert from ground truth, or the streaming
  vision model) -> velocity-tracking dynamics -> evaluator bookkeeping.

Render and difflog run on one device (CUDA unless the caller names
another); the frame stays there for the policy, and the host reads the
velocity command back once per tick.  Expert rollouts log the reference's
21-column data.csv row layout (run_competition.py:159-179,912-917):
  [idx, timestamp, desired_vel, quat_wxyz(4), pos(3), vel(3), velcmd(3),
   ct_cmd, br_cmd(3), is_collide]
and convert to the h5 trajectory schema for training
(``rollout_to_trajectory``).

Vision mode applies the reference's deployment behaviors: the manual
acceleration ramp below x = 2 m (run_competition.py:579-583), the
hidden-state reset below x = 0.5 m (:500-520) and the altitude hold on z.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.voxelizer import difflog_events
from .dynamics import VelocityTrackingQuad
from .evaluator import TrialEvaluator
from .expert import expert_velocity_command
from .obstacles import ObstacleField
from .render import render_depth_intensity


def host_vector(v) -> np.ndarray:
    """A policy's output (a tensor on any device, or an array) as a float64
    numpy vector."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, dtype=float)


def run_trial(
    obstacles: ObstacleField,
    mode: str = "state",                      # 'state' (expert) or 'vision'
    desired_vel: float = 4.0,
    policy=None,                              # vision: StreamingPipeline-like
    sim_dt: float = 0.01,
    policy_every: int = 3,                    # ~33 Hz sensor/policy rate
    max_steps: int = 10000,
    H: int = 260,
    W: int = 346,
    rng: Optional[np.random.Generator] = None,
    evaluator: Optional[TrialEvaluator] = None,
    log_images: bool = True,
    dynamics: str = "velocity",               # 'velocity' | 'rigid' (full stack)
    device: DeviceLike = None,
) -> Dict:
    """Run one trial; returns {'summary', 'log', 'depths', 'intensities',
    'events'}.  Frames render on ``device`` (CUDA unless the caller names
    another); in vision mode ``policy.step_frame`` gets the event frame
    there."""
    dev = resolve_device(device)
    if rng is None:
        rng = np.random.default_rng()
    if dynamics == "rigid":
        from .rigid_body import RigidBodyQuad

        quad = RigidBodyQuad()
    else:
        quad = VelocityTrackingQuad()
    ev = evaluator if evaluator is not None else TrialEvaluator()
    ev.reset()

    # pad an inert obstacle so the renderer's obstacle axis is never empty
    pos_arr = obstacles.positions.reshape(-1, 3)
    centers = torch.as_tensor(np.concatenate([pos_arr, [[1e6, 1e6, 1e6]]]),
                              dtype=torch.float32, device=dev)
    radii = torch.as_tensor(np.concatenate([obstacles.radii, [0.0]]),
                            dtype=torch.float32, device=dev)

    rows: List[List[float]] = []
    depth_frames: List[np.ndarray] = []
    intensity_frames: List[np.ndarray] = []
    event_frames: List[np.ndarray] = []
    prev_intensity = None
    vel_cmd = np.zeros(3)
    idx = 0

    if mode == "vision" and policy is not None and hasattr(policy, "reset"):
        policy.reset()

    for step_i in range(max_steps):
        s = quad.step(sim_dt)
        if not ev.update(s.t, s.pos, obstacles):
            break

        if step_i % policy_every != 0:
            continue

        depth, intensity = render_depth_intensity(
            torch.as_tensor(s.pos, dtype=torch.float32), centers, radii,
            H=H, W=W, is_trees=obstacles.is_trees, device=dev,
        )
        if prev_intensity is not None:
            events = difflog_events(intensity, prev_intensity, device=dev)
        else:
            events = torch.zeros(H, W, device=dev)
        prev_intensity = intensity

        if mode == "state":
            vel_cmd, _extras = expert_velocity_command(s.pos, obstacles, desired_vel, rng)
        elif mode == "vision":
            if s.pos[0] < 0.5 and hasattr(policy, "reset"):
                policy.reset()  # hidden-state reset near start
            vel, _depth_pred = policy.step_frame(events)
            vel_cmd = host_vector(vel)
            # the z output is unsupervised during training (the loss zeroes
            # it, learner.py:1065,1074); deployment replaces it with an
            # altitude-hold P-controller (run.py:303: 1.5 * (des_z - z))
            vel_cmd[2] = 1.5 * (2.0 - s.pos[2])
            # manual acceleration phase (run_competition.py:579-583)
            if s.pos[0] < 2.0:
                vel_cmd[0] = max(1.0, (s.pos[0] / 2.0) * desired_vel)
        else:
            raise ValueError(mode)
        quad.set_velocity_command(vel_cmd)

        margin = obstacles.nearest_margin(s.pos, ev.quad_radius)
        rows.append(
            [idx, s.t, desired_vel, *s.att, *s.pos, *s.vel, *vel_cmd, 0.0, 0.0, 0.0, 0.0,
             1.0 if margin < 0 else 0.0]
        )
        if log_images:
            depth_frames.append(depth.cpu().numpy())
            intensity_frames.append(intensity.cpu().numpy())
            event_frames.append(events.cpu().numpy())
        idx += 1

    return {
        "summary": ev.summary(),
        "log": np.array(rows, np.float32) if rows else np.zeros((0, 21), np.float32),
        "depths": depth_frames,
        "intensities": intensity_frames,
        "events": event_frames,
    }


def rollout_to_trajectory(result: Dict, name: str) -> Dict:
    """Convert a run_trial result into the h5 trajectory schema
    (utils/to_h5.py:16-47: data/ims/depths/desvel/evs)."""
    log = result["log"]
    T = len(result["depths"])
    return {
        "name": name,
        "data": log[:T],
        "ims": np.stack(result["intensities"][:T]) if T else np.zeros((0, 1, 1)),
        "depths": np.stack(result["depths"][:T]) if T else np.zeros((0, 1, 1)),
        "desvel": log[:T, 2],
        "evs": np.stack(result["events"][1:T]) if T > 1 else None,
    }
