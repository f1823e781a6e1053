"""Deployment runner — evfly_ros/run.py behavioral parity, ROS-free.

Port of ``SafetyConfig`` and ``DeploymentRunner`` of
``evfly_tpu/stream/deploy.py``, every constant and guard the same; the
frame goes to the port's ``StreamingPipeline.step_frame`` as a numpy array
(the pipeline moves it to its device) and the velocity comes back to the
host.

The reference's real-flight node (run.py:32-414) runs a 15 Hz loop: convert
the accumulated uint8 event frame, forward the joint model with carried
hidden state, and publish a velocity command guarded by a trigger-topic
deadman (<0.1 s), a ramp-up limiter over the first seconds, a z-axis
P-controller to a desired altitude, and a position safety box with a latched
stop (run.py:366-414, README.md:430-434).

Here those behaviors are a host-side ``DeploymentRunner`` around the
``StreamingPipeline``: callers push events + odometry + trigger timestamps,
and ``tick()`` returns the guarded command — the same state machine without
rospy.  All safety semantics keep the reference's constants.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .accumulator import EventAccumulator, frame_from_accumulated


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class SafetyConfig:
    x_range: Tuple[float, float] = (-100.0, 100.0)
    y_range: Tuple[float, float] = (-100.0, 100.0)
    z_range: Tuple[float, float] = (-1.0, 100.0)
    trigger_timeout: float = 0.1     # deadman (run.py:378)
    ramp_duration: float = 3.0       # ramp-up window (run.py:381-391)
    des_z: float = 2.0               # altitude setpoint for z P-control
    z_gain: float = 1.5              # run.py:303: z = 1.5 * (des_z - z)
    dodge_scaler: float = 1.0


class DeploymentRunner:
    def __init__(
        self,
        pipeline,                    # StreamingPipeline
        des_fwd_vel: float = 4.0,
        safety: Optional[SafetyConfig] = None,
        accumulator: Optional[EventAccumulator] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.pipeline = pipeline
        self.des_fwd_vel = des_fwd_vel
        self.safety = safety or SafetyConfig()
        self.acc = accumulator or EventAccumulator()
        self.clock = clock

        self.odom_pos: Optional[np.ndarray] = None
        self.last_trigger_t: float = -np.inf
        self.first_trigger_t: Optional[float] = None
        self.safety_guard_triggered = False
        self.last_pred_vel = np.zeros(3)
        self.last_pred_depth = None

    # ---- inputs ------------------------------------------------------
    def push_events(self, x, y, pol):
        self.acc.accumulate(x, y, pol)

    def push_odometry(self, pos):
        self.odom_pos = np.asarray(pos, float)

    def push_trigger(self):
        t = self.clock()
        if self.first_trigger_t is None:
            self.first_trigger_t = t
        self.last_trigger_t = t

    # ---- the 15 Hz tick ---------------------------------------------
    def tick(self) -> np.ndarray:
        """Drain accumulator, run the model, apply guards; returns cmd (3,)."""
        frame_u8 = self.acc.drain()
        evframe = frame_from_accumulated(
            frame_u8, crop_hw=self.pipeline.input_hw,
            base=self.acc.base,
        )
        vel, depth = self.pipeline.step_frame(evframe)
        pred = _host(vel).astype(float)  # already scaled by desvel
        self.last_pred_depth = _host(depth) if depth is not None else None

        cmd = pred.copy()
        cmd[1] *= self.safety.dodge_scaler
        # z is a P-controller to the altitude setpoint, not the model output
        if self.odom_pos is not None:
            cmd[2] = self.safety.z_gain * (self.safety.des_z - self.odom_pos[2])
        else:
            cmd[2] = 0.0

        now = self.clock()

        # latched safety box (run.py:404-412)
        if self.odom_pos is not None and not self._in_safe_range():
            self.safety_guard_triggered = True
        if self.safety_guard_triggered:
            return np.zeros(3)

        # trigger deadman (run.py:378-402)
        if now - self.last_trigger_t >= self.safety.trigger_timeout:
            return np.zeros(3)

        # ramp-up over the first seconds of commanding (run.py:381-391)
        if self.first_trigger_t is not None:
            ramp_t = now - self.first_trigger_t
            if ramp_t < self.safety.ramp_duration:
                scaler = ramp_t / self.safety.ramp_duration
                cmd[0] *= scaler
                cmd[1] *= scaler
                cmd[0] = max(min(1.0 + cmd[0], self.des_fwd_vel), 0.0)

        self.last_pred_vel = cmd
        return cmd

    def _in_safe_range(self) -> bool:
        p = self.odom_pos
        s = self.safety
        return (
            s.x_range[0] < p[0] < s.x_range[1]
            and s.y_range[0] < p[1] < s.y_range[1]
            and s.z_range[0] < p[2] < s.z_range[1]
        )
