"""Quadrotor state + velocity-command tracking dynamics.

A copy of ``evfly_tpu/sim/dynamics.py`` (numpy only): the JAX package's
``sim`` imports JAX when it is imported, so the port keeps its own.

The reference's closed loop executes LINVEL commands through
``VelocityReference::getSetpoint`` (integrates commanded velocity with a
timeout-to-zero, dodgelib velocity_reference.cpp:16-60) followed by a
geometric SE(3) controller and rigid-body RK4 integration (SURVEY.md §2.4).
For the learning-relevant behavior — the policy commands world-frame
velocities at 15-30 Hz and the platform tracks them with finite
responsiveness — we model the quadrotor as a velocity-tracking first-order
system with an acceleration limit, which reproduces the command→motion
contract at the fidelity the learner sees, without the flight-stack plumbing
(documented scope reduction; ROS/Flightmare glue is out of rebuild scope per
SURVEY.md "Rebuild scope").

Exposes the same knobs the reference exercises: command timeout (commands
older than ``cmd_timeout`` decay to zero, matching the deadman behavior in
velocity_reference.cpp and run.py:378-402) and the start-zone velocity ramp
(run_competition.py:579-583 manual acceleration phase is applied by the
caller).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class QuadState:
    t: float = 0.0
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    vel: np.ndarray = field(default_factory=lambda: np.zeros(3))
    att: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))  # wxyz


class VelocityTrackingQuad:
    """First-order velocity tracking with acceleration limiting."""

    def __init__(
        self,
        tau: float = 0.25,
        accel_limit: float = 12.0,
        cmd_timeout: float = 0.5,
        start_pos=(0.0, 0.0, 2.0),
    ):
        self.tau = tau
        self.accel_limit = accel_limit
        self.cmd_timeout = cmd_timeout
        self.state = QuadState(pos=np.array(start_pos, float))
        self._cmd = np.zeros(3)
        self._cmd_time = -np.inf

    def reset(self, start_pos=(0.0, 0.0, 2.0)):
        self.state = QuadState(pos=np.array(start_pos, float))
        self._cmd = np.zeros(3)
        self._cmd_time = -np.inf

    def set_velocity_command(self, vel_cmd: np.ndarray):
        self._cmd = np.asarray(vel_cmd, float)
        self._cmd_time = self.state.t

    def step(self, dt: float) -> QuadState:
        s = self.state
        cmd = self._cmd
        if s.t - self._cmd_time > self.cmd_timeout:
            cmd = np.zeros(3)  # stale-command decay (velocity_reference.cpp:16-60)
        accel = (cmd - s.vel) / self.tau
        a_norm = np.linalg.norm(accel)
        if a_norm > self.accel_limit:
            accel = accel / a_norm * self.accel_limit
        s.vel = s.vel + accel * dt
        s.pos = s.pos + s.vel * dt
        s.t += dt
        return s
