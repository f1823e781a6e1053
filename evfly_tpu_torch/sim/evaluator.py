"""Trial evaluation: crash counting, segment times, aborts, summary.yaml.

A copy of ``evfly_tpu/sim/evaluator.py`` (numpy only): the JAX package's
``sim`` imports JAX when it is imported, so the port keeps its own.

Behavioral parity with envtest/ros/evaluation_node.py and
evaluation_config.yaml:

* success = reach x = ``target`` (60 m) with 0 crashes,
* crash when margin = nearest-obstacle distance − obstacle radius −
  quad_radius < 0, counted once per contact episode (:142-161),
* per-meter first-crossing time bins; 10 m segment times in the summary
  (:115-117, :255-259),
* timeout (100 s) and bounding-box ([-5,65] × [±20] × [0,20]) aborts write
  ``Success: False`` (:123-129,163-174),
* trees use 2-D (x, y) distance (:144-147).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .obstacles import ObstacleField


class TrialEvaluator:
    def __init__(
        self,
        target: int = 60,
        timeout: float = 100.0,
        bounding_box=((-5, -20, 0), (65, 20, 20)),
        quad_radius: float = 0.35,
    ):
        self.xmax = int(target)
        self.timeout = timeout
        self.bounding_box = np.array(bounding_box, float)
        self.quad_radius = quad_radius
        self.reset()

    def reset(self):
        self.time_array = np.full(self.xmax + 1, np.nan)
        self.pos_log = []
        self.margin_log = []
        self.crash = 0
        self.hit_obstacle = False
        self.active = True
        self.finished = False
        self.aborted = False

    def update(self, t: float, pos: np.ndarray, obstacles: ObstacleField) -> bool:
        """Advance bookkeeping; returns False when the trial should stop."""
        if not self.active:
            return False
        self.pos_log.append([t, *pos])

        bin_x = int(max(min(np.floor(pos[0]), self.xmax), 0))
        if np.isnan(self.time_array[bin_x]):
            self.time_array[bin_x] = t

        margin = obstacles.nearest_margin(pos, self.quad_radius)
        self.margin_log.append([t, margin])
        if margin < 0:
            if not self.hit_obstacle:
                self.crash += 1
            self.hit_obstacle = True
        else:
            self.hit_obstacle = False

        if pos[0] > self.xmax:
            self.active = False
            self.finished = True
            return False
        t0 = self.time_array[0] if not np.isnan(self.time_array[0]) else t
        if t - t0 > self.timeout:
            self.active = False
            self.aborted = True
            return False
        if (pos < self.bounding_box[0]).any() or (pos > self.bounding_box[1]).any():
            self.active = False
            self.aborted = True
            return False
        return True

    def summary(self) -> dict:
        if self.aborted or not self.finished:
            return {"Success": False}
        ttf = float(self.time_array[-1] - self.time_array[0])
        seg = {}
        for i in range(10, self.xmax + 1, 10):
            seg[str(i)] = float(self.time_array[i] - self.time_array[0])
        return {
            "Success": self.crash == 0,
            "time_to_finish": ttf,
            "segment_times": seg,
            "number_crashes": int(self.crash),
        }

    def write_summary(self, path: str = "summary.yaml", rollout_name: Optional[str] = None):
        summary = self.summary()
        if rollout_name is None:
            rollout_name = os.getenv("ROLLOUT_NAME")
        payload = {rollout_name: summary} if rollout_name else summary
        try:
            import yaml

            with open(path, "w") as f:
                yaml.safe_dump(payload, f)
        except ImportError:
            with open(path, "w") as f:
                json.dump(payload, f, indent=2)
        return summary
