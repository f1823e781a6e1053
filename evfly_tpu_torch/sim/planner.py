"""Occupancy-grid path planner + cubic-spline smoothing (alternate expert).

A copy of ``evfly_tpu/sim/planner.py`` (numpy only): the JAX package's
``sim`` imports JAX when it is imported, so the port keeps its own.

Behavioral rebuild of the reference ``Planner``
(envtest/ros/path_planning.py:10-256): a discretized occupancy map over
x∈[0,60], y∈[-20,20], z∈[0,20] at 1 m resolution, obstacles inflated by
0.3 m and stamped as axis-aligned boxes (fill_map, path_planning.py:44-55 —
the code says "ellipsoid" but tests |Δ| <= r per axis, i.e. a box; we
replicate the box); a greedy +x walk that, on hitting an occupied cell,
backtracks one cell and side-steps to the nearest free cell in ±y
(find_path, :141-196); and per-dimension clamped cubic splines over
distance-parameterized timesteps (fit_spline, :198-216 — x ends at slope
``velocity``, y/z clamped to zero slope at both ends).

Divergence note: in the reference this planner is VESTIGIAL — run_competition
hardcodes ``use_planner=False`` (:1129) and ``compute_command_state_based``
never reads its ``splines`` argument.  Here it is wired as a real expert
mode ("planner") that follows the spline velocity, giving a second,
smoother supervision source for behavior cloning (VERDICT.md next-round #9).

Vectorization: the reference builds ``map_positions`` with a triple Python
loop and answers ``idx_map`` queries by an O(grid) argmin; both are replaced
with closed-form index arithmetic that returns identical cells.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .obstacles import ObstacleField


class Planner:
    def __init__(self, ranges=None, discretization: float = 1.0,
                 obst_inflation_factor: float = 0.3):
        self.x_range = [0, 60] if ranges is None else list(ranges[0])
        self.y_range = [-20, 20] if ranges is None else list(ranges[1])
        self.z_range = [0, 20] if ranges is None else list(ranges[2])
        self.discretization = float(discretization)
        self.obst_inflation_factor = float(obst_inflation_factor)
        d = self.discretization
        shape = (
            int((self.x_range[1] - self.x_range[0]) / d) + 1,
            int((self.y_range[1] - self.y_range[0]) / d) + 1,
            int((self.z_range[1] - self.z_range[0]) / d) + 1,
        )
        self.map = np.zeros(shape)
        self.origin = np.array([self.x_range[0], self.y_range[0], self.z_range[0]], float)

    # -- occupancy ---------------------------------------------------------

    def grid_axes(self):
        d = self.discretization
        return tuple(
            self.origin[i] + d * np.arange(self.map.shape[i]) for i in range(3)
        )

    def fill_map(self, obstacles: Sequence[Tuple]):
        """obstacles: (x, y, z, radius) tuples; radius scalar or 3-vector.

        Inflated axis-aligned box stamp, |p_i - c_i| <= r_i + inflation
        (path_planning.py:44-55).
        """
        xs, ys, zs = self.grid_axes()
        for obstacle in obstacles:
            c = np.asarray(obstacle[:3], float)
            r = np.broadcast_to(np.asarray(obstacle[3], float), (3,)) + self.obst_inflation_factor
            mx = np.abs(xs - c[0]) <= r[0]
            my = np.abs(ys - c[1]) <= r[1]
            mz = np.abs(zs - c[2]) <= r[2]
            self.map[np.ix_(mx, my, mz)] = 1
        self.obstacles = list(obstacles)

    def fill_from_field(self, field: ObstacleField):
        """Adapter from the sim's ObstacleField: trees become z-spanning
        columns (user_code.py:28-30 z-infinite cylinder convention)."""
        obstacles = []
        for p, r in zip(field.positions, field.radii):
            if field.is_trees:
                zc = 0.5 * (self.z_range[0] + self.z_range[1])
                rz = 0.5 * (self.z_range[1] - self.z_range[0]) + 1.0
                obstacles.append((p[0], p[1], zc, (r, r, rz)))
            else:
                obstacles.append((p[0], p[1], p[2], (r, r, r)))
        self.fill_map(obstacles)

    def idx_map(self, p) -> Tuple[int, int, int]:
        """Nearest grid cell — closed form, equal to the reference's argmin
        over all map positions (path_planning.py:105-110)."""
        p = np.asarray(p, float)
        idx = np.rint((p - self.origin) / self.discretization).astype(int)
        idx = np.clip(idx, 0, np.asarray(self.map.shape) - 1)
        return tuple(idx)

    def query_map(self, p) -> float:
        return self.map[self.idx_map(p)]

    def is_valid_point(self, p) -> bool:
        p = np.asarray(p, float)
        lo = np.array([self.x_range[0], self.y_range[0], self.z_range[0]])
        hi = np.array([self.x_range[1], self.y_range[1], self.z_range[1]])
        return bool(np.all(p >= lo) and np.all(p <= hi))

    # -- search ------------------------------------------------------------

    def find_path(self, start, end):
        """Greedy +x walk with ±y sidestep (path_planning.py:141-196).

        Returns (path list of (3,) arrays) or -1 when boxed in.
        """
        if self.query_map(start) == 1:
            return -1
        d = self.discretization
        xs, ys, zs = self.grid_axes()
        start = np.array([xs[self.idx_map(start)[0]], ys[self.idx_map(start)[1]],
                          zs[self.idx_map(start)[2]]])
        end_x = xs[self.idx_map(end)[0]]

        path = [start]
        while path[-1][0] < end_x:
            next_point = path[-1] + np.array([d, 0.0, 0.0])
            if self.query_map(next_point) == 1:
                path.pop()
                left = next_point + np.array([0.0, d, 0.0])
                while self.is_valid_point(left) and self.query_map(left) == 1:
                    left = left + np.array([0.0, d, 0.0])
                right = next_point + np.array([0.0, -d, 0.0])
                while self.is_valid_point(right) and self.query_map(right) == 1:
                    right = right + np.array([0.0, -d, 0.0])
                lv, rv = self.is_valid_point(left), self.is_valid_point(right)
                if not lv and not rv:
                    return -1
                if not lv:
                    next_point = right
                elif not rv:
                    next_point = left
                elif np.linalg.norm(next_point - left) < np.linalg.norm(next_point - right):
                    next_point = left
                else:
                    next_point = right
            path.append(next_point)
        return path

    def find_path_bfs(self, start, end):
        """Breadth-first search over the occupancy grid — the graph
        traversal the reference's header comment promises
        (path_planning.py:1-3) but its ``find_path`` never implements.

        The greedy +x walk above cannot back out of a cul-de-sac: once the
        ±y sidestep scan is walled off it returns -1 (or worse, feeds the
        spline a path that dead-ends against the pocket).  Since planner
        rollouts are a training-data source here (unlike the reference,
        where the planner is vestigial), the expert uses this complete
        search (VERDICT r4 next #7).

        Same contract as ``find_path``: success = reaching any cell with
        x >= end's x (the reference's "consider any x >= end[0] a success",
        path_planning.py:141); returns a list of (3,) map positions or -1.
        6-connected; BFS on the uniform grid = fewest-cells path.  The raw
        cell chain is decimated to direction-change knots so the spline
        stays well-conditioned.
        """
        from collections import deque

        if self.query_map(start) == 1:
            return -1
        xs, ys, zs = self.grid_axes()
        start_idx = self.idx_map(start)
        goal_x = self.idx_map(end)[0]
        nx, ny, nz = self.map.shape
        blocked = self.map != 0

        parent = {start_idx: None}
        q = deque([start_idx])
        hit = None
        while q:
            cur = q.popleft()
            if cur[0] >= goal_x:
                hit = cur
                break
            ci, cj, ck = cur
            for di, dj, dk in ((1, 0, 0), (-1, 0, 0), (0, 1, 0),
                               (0, -1, 0), (0, 0, 1), (0, 0, -1)):
                nb = (ci + di, cj + dj, ck + dk)
                if (0 <= nb[0] < nx and 0 <= nb[1] < ny and 0 <= nb[2] < nz
                        and nb not in parent and not blocked[nb]):
                    parent[nb] = cur
                    q.append(nb)
        if hit is None:
            return -1

        cells = []
        cur = hit
        while cur is not None:
            cells.append(cur)
            cur = parent[cur]
        cells.reverse()

        def pos(c):
            return np.array([xs[c[0]], ys[c[1]], zs[c[2]]])

        # keep endpoints + direction changes (collinear runs add no shape
        # information and crowd the spline knots)
        path = [pos(cells[0])]
        for a, b, c in zip(cells, cells[1:], cells[2:]):
            d1 = np.subtract(b, a)
            d2 = np.subtract(c, b)
            if not np.array_equal(d1, d2):
                path.append(pos(b))
        if len(cells) > 1:
            path.append(pos(cells[-1]))
        return path

    # -- spline ------------------------------------------------------------

    def fit_spline(self, points, velocity: float = 1.0):
        """Per-dimension clamped cubic splines (path_planning.py:198-216)."""
        from scipy.interpolate import CubicSpline

        points = np.asarray(points, float)
        timesteps = np.cumsum(np.linalg.norm(np.diff(points, axis=0), axis=1) / velocity)
        timesteps = np.insert(timesteps, 0, 0.0)
        # strictly increasing guard: collapse duplicate knots (zero-length
        # segments from the backtracking walk)
        keep = np.concatenate([[True], np.diff(timesteps) > 1e-9])
        timesteps, points = timesteps[keep], points[keep]
        bcs = [((1, 0.0), (1, velocity)), ((1, 0.0), (1, 0.0)), ((1, 0.0), (1, 0.0))]
        splines = [CubicSpline(timesteps, points[:, i], bc_type=bcs[i]) for i in range(3)]
        return splines, timesteps

    def calculate_path_and_spline(self, start, end, velocity: float = 1.0,
                                  search: str = "greedy"):
        """search: "greedy" = the reference walk (parity default);
        "bfs" = complete grid search (the expert's choice — its rollouts
        feed training, so cul-de-sac dead-ends matter here)."""
        find = self.find_path_bfs if search == "bfs" else self.find_path
        path = find(start, end)
        if path == -1 or path is None or len(path) < 2:
            path = [np.asarray(start, float), np.asarray(end, float)]
        self.path = path
        self.splines, self.ts = self.fit_spline(path, velocity)
        return self.splines, self.ts


class PlannerExpert:
    """Follow a planned spline: velocity command = spline derivative at the
    elapsed time, with proportional position correction and the waypoint
    expert's altitude recovery (user_code.py:156-157)."""

    def __init__(self, field: ObstacleField, desired_vel: float,
                 start=(0.0, 0.0, 2.0), target_x: float = 60.0,
                 pos_gain: float = 0.8, obst_inflation_factor: float = 1.0,
                 search: str = "bfs"):
        self.desired_vel = float(desired_vel)
        self.pos_gain = float(pos_gain)
        # the vestigial reference default (0.3) leaves less clearance than
        # quad radius + spline-tracking lag; the flown expert inflates by the
        # waypoint expert's 1.0 m (user_code.py:83 obst_inflate_factor).
        # search defaults to the complete BFS (find_path_bfs): expert
        # rollouts feed training, and the greedy walk's teleporting sidestep
        # can thread knot segments through walls (tests/test_planner.py).
        planner = Planner(obst_inflation_factor=obst_inflation_factor)
        planner.fill_from_field(field)
        start = np.asarray(start, float)
        end = np.array([target_x, 0.0, start[2]])
        self.splines, self.ts = planner.calculate_path_and_spline(
            start, end, velocity=self.desired_vel, search=search
        )
        self.t_end = float(self.ts[-1])
        self.t0: Optional[float] = None

    def velocity_at(self, t: float, pos: np.ndarray) -> np.ndarray:
        if self.t0 is None:
            self.t0 = t
        tau = np.clip(t - self.t0, 0.0, self.t_end)
        ref_pos = np.array([s(tau) for s in self.splines])
        ref_vel = np.array([s(tau, 1) for s in self.splines])
        if t - self.t0 >= self.t_end:
            ref_vel = np.array([self.desired_vel, 0.0, 0.0])
        vel = ref_vel + self.pos_gain * (ref_pos - np.asarray(pos, float))
        if pos[2] < 1.0:
            vel[2] = (2.0 - pos[2]) * 2.0
        return vel
