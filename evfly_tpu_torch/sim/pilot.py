"""Pilot state machine: off / takeoff / hover / velocity / feedthrough / land.

A copy of ``evfly_tpu/sim/pilot.py`` (numpy only): the JAX package's
``sim`` imports JAX when it is imported, so the port keeps its own.

Behavioral rebuild of the dodgelib Pilot
(dodgedrone_simulation/dodgelib/include/dodgelib/pilot/pilot.hpp:38-78,
src/pilot/pilot.cpp:104-203) — the layer the reference flies before and
after every trial: arm -> takeoff trajectory -> hover -> velocity tracking
(or feedthrough) -> land trajectory -> off.  Parameters are the shipped
simple_sim_pilot.yaml values (takeoff_height 1.0, takeoff_threshold 0.5,
start_land_speed 0.6, feedthrough_timeout 0.1, stop_after_feedthrough true).

Semantics preserved from the reference:

- ``start()`` (pilot.cpp:104-138): if z is already above the takeoff
  threshold the vehicle is assumed handheld and forced straight to hover;
  otherwise a rest-to-rest minimum-snap climb of ``takeoff_height`` at
  ``start_land_speed`` is flown (MinSnapTrajectory), ending in hover.
- ``land()`` (pilot.cpp:140-168): only legal from hover — anything else
  triggers forceHover and returns False ("Cannot land (yet) when not in
  hover!"); from hover a minimum-jerk descent to z=0 is flown
  (MinJerkTrajectory), ending with motors off.
- ``set_velocity_reference()`` (pilot.cpp:63-101): only accepted from
  hover or an active velocity reference; rejected (False) in any other
  mode, matching the "Not in hover, won't switch" guard.
- ``set_feedthrough_command()`` + ``feedthrough_timeout``: raw commands
  pass through; if none arrives within the timeout and
  ``stop_after_feedthrough`` is set, the pilot brakes to hover
  (pilot.cpp feedthrough watchdog).
- ``force_hover()`` (pilot.cpp:170-195): clears references, holds the
  current position.

Divergence (the rebuild's design): the reference pipeline samples full
QuadState setpoints into the GEO controller; here the pilot rides the
velocity-reference interface every vehicle here exposes
(``set_velocity_command`` on RigidBodyQuad / NativeFlightCore — the same
GEO controller + allocation + RK4 stack underneath), emitting
``v_ref + kp * (p_ref - p)``.  Trajectories are the closed-form
rest-to-rest polynomials the reference's generic solvers produce for this
boundary case: min-snap s(t) = 35t^4 - 84t^5 + 70t^6 - 20t^7 (takeoff),
min-jerk s(t) = 10t^3 - 15t^4 + 6t^5 (landing).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

MODE_OFF = "OFF"
MODE_TRAJECTORY = "TRAJECTORY"
MODE_HOVER = "HOVER"
MODE_VELOCITY = "VELOCITY"
MODE_FEEDTHROUGH = "FEEDTHROUGH"


@dataclass
class PilotParams:
    """simple_sim_pilot.yaml defaults (dodgeros/parameters)."""

    takeoff_height: float = 1.0
    takeoff_threshold: float = 0.5
    takeoff_y: float = 0.0          # pilot.cpp:126 added y offset
    start_land_speed: float = 0.6
    feedthrough_timeout: float = 0.1
    stop_after_feedthrough: bool = True
    kp_pos: float = 1.5             # hover/trajectory position correction
    hover_vel_max: float = 2.0      # per-axis clamp on the hover command


def _min_snap_s(tau: float) -> Tuple[float, float]:
    """Rest-to-rest minimum-snap time scaling: (s, ds/dtau)."""
    return (
        35 * tau**4 - 84 * tau**5 + 70 * tau**6 - 20 * tau**7,
        140 * tau**3 - 420 * tau**4 + 420 * tau**5 - 140 * tau**6,
    )


def _min_jerk_s(tau: float) -> Tuple[float, float]:
    """Rest-to-rest minimum-jerk time scaling: (s, ds/dtau)."""
    return (
        10 * tau**3 - 15 * tau**4 + 6 * tau**5,
        30 * tau**2 - 60 * tau**3 + 30 * tau**4,
    )


@dataclass
class _Segment:
    p0: np.ndarray
    p1: np.ndarray
    t0: float
    duration: float
    shape: str          # "min_snap" | "min_jerk"
    after: str          # mode entered on completion

    def sample(self, t: float) -> Tuple[np.ndarray, np.ndarray, bool]:
        tau = np.clip((t - self.t0) / max(self.duration, 1e-9), 0.0, 1.0)
        s, ds = (_min_snap_s if self.shape == "min_snap" else _min_jerk_s)(tau)
        d = self.p1 - self.p0
        p_ref = self.p0 + s * d
        v_ref = (ds / max(self.duration, 1e-9)) * d
        return p_ref, v_ref, bool(tau >= 1.0)


@dataclass
class Pilot:
    """Drives any vehicle exposing ``.state`` (with ``.pos``/``.t``) and
    ``set_velocity_command``; call ``update()`` once per control tick."""

    quad: object
    params: PilotParams = field(default_factory=PilotParams)

    def __post_init__(self):
        self.mode = MODE_OFF
        self._segment: Optional[_Segment] = None
        self._hover_pos: Optional[np.ndarray] = None
        self._vel_ref = np.zeros(3)
        self._ft_cmd = np.zeros(3)
        self._ft_time = -np.inf
        # episode artifact: [(t, from_mode, to_mode)]
        self.transitions: List[Tuple[float, str, str]] = []

    # -- mode bookkeeping ---------------------------------------------------

    def _enter(self, mode: str):
        if mode != self.mode:
            self.transitions.append((float(self.quad.state.t), self.mode, mode))
            self.mode = mode

    def is_in_hover(self) -> bool:
        return self.mode == MODE_HOVER

    def is_in_velocity_reference(self) -> bool:
        return self.mode == MODE_VELOCITY

    # -- commands (pilot.hpp:53-78 surface) ----------------------------------

    def start(self) -> bool:
        """Arm + take off (pilot.cpp:104-138)."""
        s = self.quad.state
        if s.pos[2] > self.params.takeoff_threshold:
            # "Z-position larger than takeoff threshold, assuming handheld
            # start!" -> straight to hover (pilot.cpp:118-122)
            return self.force_hover()
        p0 = np.asarray(s.pos, float)
        p1 = p0 + np.array([0.0, self.params.takeoff_y, self.params.takeoff_height])
        self._segment = _Segment(
            p0=p0, p1=p1, t0=float(s.t),
            duration=self.params.takeoff_height / self.params.start_land_speed,
            shape="min_snap", after=MODE_HOVER,
        )
        self._enter(MODE_TRAJECTORY)
        return True

    def land(self) -> bool:
        """Descend to z=0 then off — only from hover (pilot.cpp:140-168)."""
        if self.mode != MODE_HOVER:
            # "Cannot land (yet) when not in hover! Initiating force hover!"
            self.force_hover()
            return False
        p0 = self._hover_pos.copy()
        p1 = p0.copy()
        p1[2] = 0.0
        self._segment = _Segment(
            p0=p0, p1=p1, t0=float(self.quad.state.t),
            duration=abs(p1[2] - p0[2]) / self.params.start_land_speed,
            shape="min_jerk", after=MODE_OFF,
        )
        self._enter(MODE_TRAJECTORY)
        return True

    def off(self) -> bool:
        self._segment = None
        self._enter(MODE_OFF)
        return True

    def force_hover(self) -> bool:
        self._segment = None
        self._hover_pos = np.asarray(self.quad.state.pos, float).copy()
        self._enter(MODE_HOVER)
        return True

    def set_velocity_reference(self, velocity, yaw_rate: float = 0.0) -> bool:
        """Only from hover or an existing velocity reference
        (pilot.cpp:63-101); other modes reject the switch."""
        if self.mode not in (MODE_HOVER, MODE_VELOCITY):
            return False
        self._vel_ref = np.asarray(velocity, float)
        self._enter(MODE_VELOCITY)
        return True

    def set_feedthrough_command(self, command) -> bool:
        if self.mode == MODE_OFF:
            return False
        self._ft_cmd = np.asarray(command, float)
        self._ft_time = float(self.quad.state.t)
        self._enter(MODE_FEEDTHROUGH)
        return True

    # -- control tick ---------------------------------------------------------

    def command(self) -> np.ndarray:
        """Velocity command for the current mode at the vehicle's clock."""
        s = self.quad.state
        pos = np.asarray(s.pos, float)
        kp = self.params.kp_pos
        if self.mode == MODE_OFF:
            return np.zeros(3)
        if self.mode == MODE_TRAJECTORY:
            p_ref, v_ref, done = self._segment.sample(float(s.t))
            if done:
                after = self._segment.after
                self._hover_pos = self._segment.p1.copy()
                self._segment = None
                self._enter(after)
                if after == MODE_OFF:
                    return np.zeros(3)
                # fall through to hover hold at the endpoint
            else:
                return v_ref + kp * (p_ref - pos)
        if self.mode == MODE_HOVER:
            err = self._hover_pos - pos
            v = np.clip(kp * err, -self.params.hover_vel_max,
                        self.params.hover_vel_max)
            return v
        if self.mode == MODE_VELOCITY:
            return self._vel_ref
        if self.mode == MODE_FEEDTHROUGH:
            if (float(s.t) - self._ft_time > self.params.feedthrough_timeout
                    and self.params.stop_after_feedthrough):
                # feedthrough watchdog: brake to hover
                self.force_hover()
                err = self._hover_pos - pos
                return np.clip(kp * err, -self.params.hover_vel_max,
                               self.params.hover_vel_max)
            return self._ft_cmd
        return np.zeros(3)

    def update(self) -> np.ndarray:
        """Compute + apply the command; returns it."""
        cmd = self.command()
        self.quad.set_velocity_command(cmd)
        return cmd
