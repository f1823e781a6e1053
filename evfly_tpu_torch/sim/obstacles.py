"""Obstacle fields: generation, CSV (de)serialization, nearest queries.

A copy of ``evfly_tpu/sim/obstacles.py`` (numpy only): the JAX package's
``sim`` imports JAX when it is imported, so the port keeps its own.

Replaces the reference's environment-generation utilities
(utils/StaticobstacleGen.py, utils/make_new_envs.py,
envsim/generate_environment/obstacle_generator.py) and the obstacle CSV
contract consumed by the expert and evaluator:

* CSV row format ``name, x, y, z, qw, qx, qy, qz, sx, sy, sz``
  (StaticobstacleGen.py:22-24).
* The reference reader takes radius from columns (10, 8, 9)
  (read_obst_info.py:18 — "csv radius is in format y, z, x ???"); for the
  spherical/cylindrical obstacles used everywhere, sx == sy == sz so the
  permutation is inert; we read column 8 and mirror it on write.
* Trees are modeled as z-infinite cylinders (user_code.py:28-30,
  evaluation_node.py:144-147 use 2-D distance when ``is_trees``).
"""

from __future__ import annotations

import csv
import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class ObstacleField:
    positions: np.ndarray   # (N, 3)
    radii: np.ndarray       # (N,)
    is_trees: bool = False
    names: Optional[List[str]] = None

    def __len__(self):
        return len(self.radii)

    def relative_to(self, pos: np.ndarray) -> "ObstacleField":
        """Obstacles expressed relative to a query position, nearest first.

        Mirrors the sim's ground-truth obstacle publishing (nearest obstacles
        relative to the body frame, visionsim_node.cpp:190-219 /
        vision_env.cpp obs layout).
        """
        if len(self) == 0:
            return ObstacleField(np.zeros((0, 3)), np.zeros((0,)), self.is_trees)
        rel = self.positions - pos[None, :]
        if self.is_trees:
            d = np.linalg.norm(rel[:, :2], axis=1)
        else:
            d = np.linalg.norm(rel, axis=1)
        order = np.argsort(d)
        return ObstacleField(rel[order], self.radii[order], self.is_trees)

    def nearest_margin(self, pos: np.ndarray, quad_radius: float) -> float:
        """margin = dist - radius - quad_radius (evaluation_node.py:150)."""
        rel = self.relative_to(pos)
        if len(rel) == 0:
            return np.inf
        if self.is_trees:
            d = np.linalg.norm(rel.positions[0, :2])
        else:
            d = np.linalg.norm(rel.positions[0])
        return float(d - rel.radii[0] - quad_radius)


def generate_forest(
    rng: np.random.Generator,
    x_range: Tuple[float, float] = (8.0, 58.0),
    y_range: Tuple[float, float] = (-15.0, 15.0),
    num_obstacles: int = 60,
    radius_range: Tuple[float, float] = (0.4, 1.2),
    z_range: Tuple[float, float] = (0.0, 10.0),
    trees: bool = True,
    min_clearance: float = 2.2,
) -> ObstacleField:
    """Random forest layout in the flight corridor.

    Obstacles spawn between start (x=0) and goal (x=60) with a guaranteed
    minimum pairwise clearance so a path exists, matching the difficulty
    shape of the reference's medium forest levels (100 random layouts per
    environment folder).
    """
    positions = []
    radii = []
    attempts = 0
    while len(positions) < num_obstacles and attempts < num_obstacles * 50:
        attempts += 1
        p = np.array(
            [
                rng.uniform(*x_range),
                rng.uniform(*y_range),
                0.0 if trees else rng.uniform(*z_range),
            ]
        )
        r = rng.uniform(*radius_range)
        ok = True
        for q, rq in zip(positions, radii):
            d = np.linalg.norm((p - q)[:2] if trees else p - q)
            if d < r + rq + min_clearance:
                ok = False
                break
        if ok:
            positions.append(p)
            radii.append(r)
    pos_arr = np.array(positions).reshape(-1, 3)
    return ObstacleField(pos_arr, np.array(radii), is_trees=trees)


def save_obstacle_csv(path: str, field: ObstacleField) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for i in range(len(field)):
            name = field.names[i] if field.names else ("tree" if field.is_trees else "rpg_box01")
            x, y, z = field.positions[i]
            r = field.radii[i]
            w.writerow([name, x, y, z, 1.0, 0.0, 0.0, 0.0, r, r, r])


def load_obstacle_csv(path: str, is_trees: Optional[bool] = None) -> ObstacleField:
    positions, radii, names = [], [], []
    with open(path) as f:
        for row in csv.reader(f):
            try:
                positions.append([float(row[1]), float(row[2]), float(row[3])])
                radii.append(float(row[8]))
                names.append(row[0])
            except (ValueError, IndexError):
                continue
    trees = is_trees if is_trees is not None else any("tree" in n for n in names)
    return ObstacleField(np.array(positions), np.array(radii), is_trees=trees, names=names)
