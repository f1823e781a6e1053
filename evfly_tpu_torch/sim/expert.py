"""Privileged expert policy (user_code.py:59-170 behavioral parity).

A copy of ``evfly_tpu/sim/expert.py`` (numpy only): the JAX package's
``sim`` imports JAX when it is imported, so the port keeps its own.

Grid of candidate waypoints at x = +8 m, ±8 m lateral span with 0.5 m
spacing (user_code.py:90-93); each is line-sphere-checked against obstacles
inflated by 1 m within 10 m ahead (:82-83,123-127), trees treated as
z-infinite cylinders (:28-30); the collision-free waypoint closest to the
grid center wins (:48-57); the command is the waypoint direction scaled to
``desiredVel`` (:136-143) with altitude recovery below 1 m (:156-157).

Vectorized numpy: the whole grid × obstacle collision matrix is one
broadcast quadratic-discriminant evaluation instead of nested loops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .obstacles import ObstacleField


def _line_sphere_collides(wpts: np.ndarray, centers: np.ndarray, radii: np.ndarray) -> np.ndarray:
    """Segment-from-origin vs spheres: discriminant b²-4ac >= 0 per (wpt, obst).

    wpts: (M, 3) endpoints from the origin; centers: (K, 3); radii: (K,).
    Returns (M, K) bool.  Same quadratic as user_code.py:23-45.
    """
    d = wpts[:, None, :]                       # (M, 1, 3) direction (x2-x1 with x1=0)
    c = centers[None, :, :]                    # (1, K, 3)
    b = 2.0 * np.sum(d * (-c), axis=-1)        # 2 * (x2-x1)·(x1-x3), x1 = 0
    a = np.sum(d * d, axis=-1)
    cc = np.sum(c * c, axis=-1) - radii[None, :] ** 2
    return b**2 - 4.0 * a * cc >= 0.0


def expert_velocity_command(
    pos: np.ndarray,
    obstacles: ObstacleField,
    desired_vel: float,
    rng: Optional[np.random.Generator] = None,
    x_displacement: float = 8.0,
    grid_center_offset: float = 8.0,
    grid_displacement: float = 0.5,
    obst_dist_threshold: float = 10.0,
    obst_inflate_factor: float = 1.0,
) -> Tuple[np.ndarray, dict]:
    """World-frame LINVEL command from ground-truth obstacles.

    pos: current world position (3,).  Returns (velocity (3,), extras).
    """
    if rng is None:
        rng = np.random.default_rng()

    rel = obstacles.relative_to(pos)
    lateral = np.arange(grid_center_offset, -grid_center_offset - grid_displacement, -grid_displacement)
    ny = 1 if obstacles.is_trees else len(lateral)
    y_grid = np.array([0.0]) if obstacles.is_trees else lateral

    # candidate waypoints (ny, nx, 3) = [x_displacement, lateral_y, lateral_z]
    wy, wx = np.meshgrid(y_grid, lateral, indexing="ij")
    wpts = np.stack([np.full_like(wx, x_displacement), wx, wy], axis=-1)  # (ny, nx, 3)
    flat_wpts = wpts.reshape(-1, 3)

    # obstacles ahead within threshold (user_code.py:123)
    sel = (rel.positions[:, 0] + rel.radii + obst_inflate_factor > 0) & (
        rel.positions[:, 0] - (rel.radii + obst_inflate_factor) < obst_dist_threshold
    )
    centers = rel.positions[sel]
    radii = rel.radii[sel] + obst_inflate_factor
    if obstacles.is_trees:
        centers = centers.copy()
        centers[:, 2] = 0.0  # z-infinite cylinder spoof (user_code.py:28-30)

    if len(centers) == 0:
        collisions = np.zeros((ny, len(lateral)))
    else:
        coll_flat = _line_sphere_collides(flat_wpts, centers, radii).any(axis=1)
        collisions = coll_flat.reshape(ny, len(lateral)).astype(float)

    extras = {"collisions": collisions, "wpt_idx": None}

    if collisions.sum() == collisions.size:
        vel = np.array([desired_vel, 0.0, 0.0])
    else:
        # closest collision-free waypoint to grid center (user_code.py:48-57)
        center = np.array(collisions.shape) // 2
        dist_to_center = np.abs(np.indices(collisions.shape) - center.reshape(-1, 1, 1)).sum(0)
        zeros = np.argwhere(collisions == 0)
        dists = dist_to_center[tuple(zeros.T)]
        best = np.argwhere(dists == dists.min()).flatten()
        chosen = tuple(zeros[rng.choice(best)])
        extras["wpt_idx"] = chosen
        wpt = wpts[chosen[0], chosen[1]]
        wpt = wpt / np.linalg.norm(wpt) * desired_vel
        vel = wpt.copy()

    # altitude recovery (user_code.py:156-157)
    if pos[2] < 1.0:
        vel[2] = (2.0 - pos[2]) * 2.0
    return vel, extras
