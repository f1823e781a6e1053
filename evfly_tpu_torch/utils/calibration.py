"""Camera calibration / rectification — calibration_tools parity without cv2.

A numpy copy of ``evfly_tpu/utils/calibration.py`` (the port imports
nothing of the JAX package).  Rebuilds
utils/calibration_tools/{rectify_bag.py,camsys.py}: Kalibr-yaml camera
chains, undistort/rectify remap-map generation, image remapping, and
raw-event-stream remapping, as numpy map construction and a gather remap.
Semantics match cv2's pipeline:

* ``build_undistort_rectify_map(K, dist, P, size)`` ≡
  ``cv2.initUndistortRectifyMap(K, dist, None, P, size)``: for each
  destination pixel, back-project through P⁻¹, apply radtan (plumb_bob)
  distortion, project through K — producing (mapx, mapy) source
  coordinates (rectify_bag.py:60-77).
* ``undistort_points`` ≡ cv2.undistortPoints with (R, P): iterative
  undistortion then projection (rectify_bag.py:79-84, the event inverse map).
* ``Aligner`` (rectify_bag.py:119-140): fix_rotation=True camera system —
  depth camera remapped into the event camera's geometry.

Divergence: image remapping interpolates bilinearly (cv2.INTER_CUBIC in the
reference); event-frame alignment is insensitive to the kernel choice at
the 1e-3 level on smooth depth maps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class Camera:
    """Kalibr camera entry: intrinsics [fx, fy, cx, cy], radtan distortion."""

    def __init__(self, data: dict):
        self.intrinsics = np.eye(3)
        self.intrinsics[[0, 1, 0, 1], [0, 1, 2, 2]] = data["intrinsics"]
        self.distortion_coeffs = np.array(data["distortion_coeffs"], float)
        self.distortion_model = data.get("distortion_model", "radtan")
        self.resolution = data["resolution"]
        self.R = (
            np.array(data["T_cn_cnm1"])[:3, :3] if "T_cn_cnm1" in data else np.eye(3)
        )
        self.K = self.intrinsics

    @property
    def num_pixels(self):
        return int(np.prod(self.resolution))


def _radtan_distort(x: np.ndarray, y: np.ndarray, d: np.ndarray):
    k1, k2, p1, p2 = (list(d) + [0.0] * 4)[:4]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def build_undistort_rectify_map(
    K: np.ndarray, dist: np.ndarray, P: np.ndarray, size: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """(mapx, mapy) of shape (H, W): source pixel for each rectified pixel."""
    W, H = size
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    pts = np.stack([u, v, np.ones_like(u)], axis=0).reshape(3, -1)
    ray = np.linalg.inv(P) @ pts
    x = ray[0] / ray[2]
    y = ray[1] / ray[2]
    xd, yd = _radtan_distort(x, y, dist)
    mapx = (K[0, 0] * xd + K[0, 2]).reshape(H, W).astype(np.float32)
    mapy = (K[1, 1] * yd + K[1, 2]).reshape(H, W).astype(np.float32)
    return mapx, mapy


def undistort_points(
    coords: np.ndarray, K: np.ndarray, dist: np.ndarray,
    R: Optional[np.ndarray] = None, P: Optional[np.ndarray] = None,
    iters: int = 8,
) -> np.ndarray:
    """cv2.undistortPoints: pixel coords (N, 2) -> rectified coords (N, 2)."""
    x = (coords[:, 0] - K[0, 2]) / K[0, 0]
    y = (coords[:, 1] - K[1, 2]) / K[1, 1]
    x0, y0 = x.copy(), y.copy()
    for _ in range(iters):  # fixed-point inversion of the distortion
        xd, yd = _radtan_distort(x, y, dist)
        x = x - (xd - x0)
        y = y - (yd - y0)
    pts = np.stack([x, y, np.ones_like(x)], axis=0)
    if R is not None:
        pts = R @ pts
    if P is not None:
        pts = P @ pts
        return np.stack([pts[0] / pts[2], pts[1] / pts[2]], axis=1)
    return np.stack([pts[0] / pts[2], pts[1] / pts[2]], axis=1)


class CameraSystem:
    """Depth↔event camera pair from a Kalibr chain (rectify_bag.py:28-88)."""

    def __init__(self, data: dict, fix_rotation: bool = False):
        T = np.array(data["cam1"]["T_cn_cnm1"])
        cam0, cam1 = Camera(data["cam0"]), Camera(data["cam1"])
        self.cam, self.event_cam = (
            (cam0, cam1) if cam0.num_pixels > cam1.num_pixels else (cam1, cam0)
        )
        if not fix_rotation:
            self.newK = self.event_cam.K
            self.t = T[:3, 3]
            r3_cam0 = self.cam.R[:, 2]
            r1 = self.t / np.linalg.norm(self.t)
            r2 = np.cross(r3_cam0, r1)
            r3 = np.cross(r1, r2)
            self.newR = np.stack([r1, r2, r3], -1)
        else:
            self.newR = self.cam.R
            self.newK = self.event_cam.K
        self.newres = tuple(self.event_cam.resolution)

    def get_remapping(self) -> Dict[str, np.ndarray]:
        img_mapx, img_mapy = build_undistort_rectify_map(
            self.cam.K, self.cam.distortion_coeffs,
            self.newK @ self.newR @ self.cam.R.T, self.newres,
        )
        ev_mapx, ev_mapy = build_undistort_rectify_map(
            self.event_cam.K, self.event_cam.distortion_coeffs,
            self.newK @ self.newR @ self.event_cam.R.T, self.newres,
        )
        W, H = self.event_cam.resolution
        coords = np.stack(np.meshgrid(np.arange(W), np.arange(H))).reshape(2, -1).T.astype(np.float64)
        points = undistort_points(
            coords, self.event_cam.K, self.event_cam.distortion_coeffs,
            R=self.newR @ self.event_cam.R.T, P=self.newK,
        )
        inv_maps = points.reshape(H, W, 2)
        return {
            "img_mapx": img_mapx, "img_mapy": img_mapy,
            "ev_mapx": ev_mapx, "ev_mapy": ev_mapy,
            "inv_mapx": inv_maps[..., 0], "inv_mapy": inv_maps[..., 1],
        }


def remap_image(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """Bilinear remap (cv2.remap semantics, zero border)."""
    H, W = img.shape[:2]
    x0 = np.floor(mapx).astype(int)
    y0 = np.floor(mapy).astype(int)
    wx = mapx - x0
    wy = mapy - y0
    valid = (mapx >= 0) & (mapx <= W - 1) & (mapy >= 0) & (mapy <= H - 1)
    x0c = np.clip(x0, 0, W - 1)
    y0c = np.clip(y0, 0, H - 1)
    x1c = np.clip(x0 + 1, 0, W - 1)
    y1c = np.clip(y0 + 1, 0, H - 1)
    out = (
        img[y0c, x0c] * (1 - wy) * (1 - wx)
        + img[y0c, x1c] * (1 - wy) * wx
        + img[y1c, x0c] * wy * (1 - wx)
        + img[y1c, x1c] * wy * wx
    )
    return np.where(valid, out, 0.0).astype(img.dtype)


def remap_events(events: dict, mapx: np.ndarray, mapy: np.ndarray, shape, rotate=False):
    """Per-event rectification (rectify_bag.py:102-117)."""
    x = mapx[events["y"], events["x"]]
    y = mapy[events["y"], events["x"]]
    tw, th = shape
    if rotate:
        x = tw - 1 - x
        y = th - 1 - y
    mask = (x >= 0) & (x <= tw - 1) & (y >= 0) & (y <= th - 1)
    return {"x": x[mask], "y": y[mask], "t": events["t"][mask], "p": events["p"][mask]}


class Aligner:
    """Depth/DAVIS frame alignment from a Kalibr yaml (rectify_bag.py:119-140)."""

    def __init__(self, calib_file: str):
        import yaml

        with open(calib_file) as fh:
            cam_data = yaml.load(fh, Loader=yaml.SafeLoader)
        camsys = CameraSystem(cam_data, fix_rotation=True)
        maps = camsys.get_remapping()
        self.depth_map = (maps["img_mapx"], maps["img_mapy"])
        self.davis_map = (maps["ev_mapx"], maps["ev_mapy"])
        self.inv_map = (maps["inv_mapx"], maps["inv_mapy"])

    def align(self, depth=None, davis=None):
        out = {"depth": None, "davis": None}
        if depth is not None:
            out["depth"] = remap_image(depth, *self.depth_map)
        if davis is not None:
            out["davis"] = remap_image(davis, *self.davis_map)
        return out
