"""Analytic depth/intensity rendering, the stand-in for Unity.

Port of ``evfly_tpu/sim/render.py``.  The reference renders RGB + depth
through Flightmare's ZMQ bridge to a Unity binary (unity_bridge.cpp:110-328)
at 346x260 with a 70 deg FOV camera (flightpy/configs/vision/config.yaml).
Here the scene -- spheres and z-infinite tree cylinders -- is ray-cast
analytically over the pixel grid with plain torch ops on one device.  G
views are one broadcast over a (G, K, H, W) grid of hit distances, G
cameras each with its own K padded obstacles (``render_depth_intensity``
with (G, 3), (G, K, 3), (G, K) inputs): at G = 16,
K = 61 and 260x346 one such f32 temporary is 351 MB.

Depth is metric distance along the camera axis normalized by ``max_depth``
into [0, 1].  Intensity is a flat-shaded grayscale with depth attenuation,
a per-obstacle albedo, a hard stripe texture on obstacles and a checker on
the ground: difflog events fire only on edges crossing their +-0.2 log
threshold, so the textures are high-contrast steps.

The steps are thresholds (``sin(6 z) > 0``, ``sin(4.2 x) sin(3.4 y) > 0``)
and a nearest hit (``argmin``), so two implementations of ``sin``, ``sqrt``
or the reductions that differ in the last bits of an argument can differ
by a whole step at a pixel that lies on an edge.  ``render_margins`` says,
per pixel, how far it lies from every such edge (relative to the
argument's size); pixels below ``RENDER_MARGIN`` may differ between this
port and the JAX package, or between the card and the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device

# pixels whose render_margins lie below this may take the other side of a
# texture edge, a nearest hit or a silhouette under another implementation
# of the same float math (about 170 f32 rounding steps of the argument)
RENDER_MARGIN = 1e-5


def _as(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """sqrt(sum(x * x)) over the last axis, as jnp.linalg.norm."""
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def _rays(H: int, W: int, fov_deg: float, dev: torch.device):
    """Focal length and unit ray directions (H, W, 3): camera axis +x,
    image right -> -y, image down -> -z."""
    f = W / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
    u = torch.arange(W, dtype=torch.float32, device=dev) - (W - 1) / 2.0
    v = torch.arange(H, dtype=torch.float32, device=dev) - (H - 1) / 2.0
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dirs = torch.stack([torch.ones_like(uu), -uu / f, -vv / f], dim=-1)
    return f, dirs / _norm(dirs, keepdim=True)


def _hits(rel: torch.Tensor, radii: torch.Tensor, dirs: torch.Tensor, is_trees: bool):
    """Ray hits of G x K obstacles at ``rel`` (G, K, 3) = center - camera:
    the hit distance (G, K, H, W) (inf where missed), the discriminant and
    its scale b^2 + |4ac| (for the silhouettes' margins), and the nearer
    root before the validity test."""
    dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cx, cy, cz = (rel[..., i, None, None] for i in range(3))
    r = radii[..., None, None]
    if is_trees:
        a = dx * dx + dy * dy
        b = -2.0 * (dx * cx + dy * cy)
        c = (cx * cx + cy * cy) - r ** 2
    else:
        a = 1.0
        b = -2.0 * (dx * cx + dy * cy + dz * cz)
        c = (cx * cx + cy * cy + cz * cz) - r ** 2
    four_ac = 4.0 * a * c
    disc = b * b - four_ac
    t = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / (2.0 * a)
    valid = (disc >= 0.0) & (t > 1e-3) & (r > 0.0)
    return torch.where(valid, t, torch.inf), disc, b * b + four_ac.abs(), t


def _scene(cam_pos, centers, radii, H, W, fov_deg, max_depth, is_trees,
           margins: bool = False) -> Dict[str, torch.Tensor]:
    """The shared ray cast of G views: cam_pos (G, 3), centers (G, K, 3),
    radii (G, K) -> the rays, hits, depth and intensity, each (G, H, W)."""
    f, dirs = _rays(H, W, fov_deg, cam_pos.device)
    ts, disc, scale, t_raw = _hits(centers - cam_pos[:, None, :], radii, dirs, is_trees)
    t_obj, hit_idx = ts.min(dim=1)

    # ground plane z = 0 with a procedural texture: dense difflog events
    # under ego-motion, like the textured terrain of the reference's scenes
    cam_x, cam_y, cam_z = (cam_pos[:, i, None, None] for i in range(3))
    dz = dirs[..., 2]
    t_ground = torch.where(dz < -1e-5, -cam_z / dz, torch.inf)
    t_min = torch.minimum(t_obj, t_ground)
    ground_hit = t_ground < t_obj

    # metric axial depth (distance along the camera axis = t * dir_x)
    axial = t_min * dirs[..., 0]
    depth = torch.clamp(torch.where(torch.isfinite(axial), axial, max_depth) / max_depth,
                        0.0, 1.0)

    K = centers.shape[1]
    k = torch.arange(K, dtype=torch.float32, device=cam_pos.device)
    albedo = 0.25 + 0.35 * (torch.sin(k * 2.399) * 0.5 + 0.5)
    hit_z = cam_z + t_obj * dirs[..., 2]
    stripe = (torch.sin(6.0 * hit_z) > 0).float()
    obj_int = albedo[hit_idx] * (0.55 + 0.45 * stripe) * torch.exp(
        -torch.clamp(t_obj * dirs[..., 0], 0, max_depth) / (2.0 * max_depth))
    # ground: a world-anchored checker, whose sweeping edges fire dense events
    gx = cam_x + t_ground * dirs[..., 0]
    gy = cam_y + t_ground * dirs[..., 1]
    checker = ((torch.sin(4.2 * gx) * torch.sin(3.4 * gy)) > 0).float()
    ground_int = (0.28 + 0.42 * checker) * torch.exp(
        -torch.clamp(t_ground, 0, 4 * max_depth) / (4.0 * max_depth))
    finite = torch.isfinite(t_min)
    intensity = torch.where(finite, torch.where(ground_hit, ground_int, obj_int),
                            torch.full_like(t_min, 0.85))
    out = dict(f=f, dirs=dirs, t_obj=t_obj, hit_idx=hit_idx, t_ground=t_ground,
               t_min=t_min, ground_hit=ground_hit, finite=finite, depth=depth,
               intensity=intensity)
    if margins:
        out["margin"] = _margins(out, ts, disc, scale, t_raw, radii, hit_z, gx, gy,
                                 cam_pos, K)
    return out


def _margins(s, ts, disc, scale, t_raw, radii, hit_z, gx, gy, cam_pos, K):
    """Per pixel, the least relative distance from an edge of the render:
    the stripe's and the checker's zeros (|sin| over the size of its
    argument's terms), a tie between the two nearest obstacles or between
    an obstacle and the ground, and a silhouette (|disc| over b^2 + |4ac|)
    of an obstacle no farther than what the pixel shows.

    Depth away from these edges still carries the quadratic's cancellation:
    its rounding error grows as t / sqrt(|disc| / (b^2 + |4ac|)), up to
    about 2e-5 of max_depth for an obstacle 20 m away."""
    inf = torch.full_like(s["t_min"], torch.inf)
    dirs, t_obj, t_ground = s["dirs"], s["t_obj"], s["t_ground"]
    cam_x, cam_y, cam_z = (cam_pos[:, i, None, None] for i in range(3))
    obj_seen = s["finite"] & ~s["ground_hit"]
    ground_seen = s["finite"] & s["ground_hit"]

    def edge(arg, terms):
        return torch.sin(arg).abs() / torch.clamp_min(terms, 1.0)

    stripe = edge(6.0 * hit_z, 6.0 * (cam_z.abs() + (t_obj * dirs[..., 2]).abs()))
    checker = torch.minimum(
        edge(4.2 * gx, 4.2 * (cam_x.abs() + (t_ground * dirs[..., 0]).abs())),
        edge(3.4 * gy, 3.4 * (cam_y.abs() + (t_ground * dirs[..., 1]).abs())))
    margin = torch.minimum(torch.where(obj_seen, stripe, inf),
                           torch.where(ground_seen, checker, inf))
    if K > 1:
        two = ts.topk(2, dim=1, largest=False).values
        tie = (two[:, 1] - two[:, 0]) / torch.clamp_min(two[:, 0], 1.0)
        margin = torch.minimum(margin, torch.where(torch.isfinite(tie), tie, inf))
    both = torch.isfinite(t_obj) & torch.isfinite(t_ground)
    ground_tie = (t_ground - t_obj).abs() / torch.clamp_min(torch.minimum(t_obj, t_ground), 1.0)
    margin = torch.minimum(margin, torch.where(both, ground_tie, inf))
    near = ((t_raw > 1e-3) & (t_raw <= s["t_min"][:, None]) & (radii[..., None, None] > 0.0))
    graze = torch.where(near, disc.abs() / torch.clamp_min(scale, 1e-30), torch.inf)
    return torch.minimum(margin, graze.amin(dim=1))


def _views(cam_pos, centers, radii, dev):
    """Inputs as f32 tensors on ``dev``: one view ((3,), (K, 3), (K,)) or
    G views ((G, 3), (G, K, 3), (G, K)); returns the G-view form and
    whether it was one view."""
    cam_pos, centers, radii = _as(cam_pos, dev), _as(centers, dev), _as(radii, dev)
    single = cam_pos.dim() == 1
    if single:
        cam_pos, centers, radii = cam_pos[None], centers[None], radii[None]
    return cam_pos, centers, radii, single


def render_depth_intensity(
    cam_pos, centers, radii, H: int = 260, W: int = 346, fov_deg: float = 70.0,
    max_depth: float = 20.0, is_trees: bool = False, device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view: cam_pos (3,) world position (x fwd, y left, z up), centers
    (K, 3), radii (K,) (radius 0 = inert padding) -> (depth in [0, 1],
    intensity in [0, 1]), each (H, W), on ``device`` (CUDA unless the
    caller names another).  G views at once, each with its own obstacles
    ((G, 3), (G, K, 3), (G, K)), give (G, H, W) each."""
    dev = resolve_device(device)
    cam_pos, centers, radii, single = _views(cam_pos, centers, radii, dev)
    s = _scene(cam_pos, centers, radii, H, W, fov_deg, max_depth, is_trees)
    if single:
        return s["depth"][0], s["intensity"][0]
    return s["depth"], s["intensity"]


def render_batch(cam_positions, centers, radii, device: DeviceLike = None, **kw):
    """G camera positions (G, 3) in one obstacle field (K, 3), (K,) ->
    (depth, intensity), each (G, H, W)."""
    dev = resolve_device(device)
    cam_positions = _as(cam_positions, dev)
    G = cam_positions.shape[0]
    centers, radii = _as(centers, dev), _as(radii, dev)
    return render_depth_intensity(cam_positions, centers.expand(G, *centers.shape),
                                  radii.expand(G, *radii.shape), device=dev, **kw)


def render_margins(
    cam_pos, centers, radii, H: int = 260, W: int = 346, fov_deg: float = 70.0,
    max_depth: float = 20.0, is_trees: bool = False, device: DeviceLike = None,
) -> torch.Tensor:
    """Per pixel of ``render_depth_intensity`` (same arguments, one view or
    G), its relative distance from the nearest edge of the render: a
    texture threshold, a tie of nearest hits, or a silhouette.  Where it is
    below ``RENDER_MARGIN``, another implementation of the same math may
    give the other side of that edge."""
    dev = resolve_device(device)
    cam_pos, centers, radii, single = _views(cam_pos, centers, radii, dev)
    m = _scene(cam_pos, centers, radii, H, W, fov_deg, max_depth, is_trees,
               margins=True)["margin"]
    return m[0] if single else m


def render_rgbd_flow(
    cam_pos, cam_vel, cam_omega, centers, radii, H: int = 260, W: int = 346,
    fov_deg: float = 70.0, max_depth: float = 20.0, is_trees: bool = False,
    device: DeviceLike = None,
):
    """RGB + depth + optical flow, the sensor channels of the reference's
    Unity camera (rgb_camera.cpp:212+, visionsim_node.cpp:223-262): one view
    -> (rgb (H, W, 3) in [0, 1], depth (H, W) in [0, 1], flow (H, W, 2) in
    px/s).

    The scene is analytic, so the flow is the exact ego-motion field: for
    the scene point P = t d of a pixel, dP/dt = -v - w x P, projected
    through u = -f Y/X, v = -f Z/X.  Sky pixels get zero flow.  The RGB
    tints are scaled so that the Rec.601 luminance of every pixel equals
    ``render_depth_intensity``'s grayscale."""
    dev = resolve_device(device)
    cam_pos, centers, radii = _as(cam_pos, dev)[None], _as(centers, dev)[None], _as(radii, dev)[None]
    cam_vel = _as(cam_vel, dev).reshape(1, 1, 1, 3)
    cam_omega = _as(cam_omega, dev).reshape(1, 1, 1, 3)
    s = _scene(cam_pos, centers, radii, H, W, fov_deg, max_depth, is_trees)
    intensity, t_min, finite = s["intensity"], s["t_min"], s["finite"]

    # RGB: a luminance-preserving tint (Rec.601 weights); the per-obstacle
    # hue is mixed 65% toward white so that no channel can exceed 1 and the
    # clip below never bites
    lw = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=dev)
    k = torch.arange(centers.shape[1], dtype=torch.float32, device=dev)
    obj_tint = 0.65 + 0.35 * torch.stack([
        0.6 + 0.4 * torch.sin(k * 1.7),
        0.6 + 0.4 * torch.sin(k * 2.3 + 2.1),
        0.6 + 0.4 * torch.sin(k * 3.1 + 4.2),
    ], dim=-1)
    obj_tint = obj_tint / (obj_tint @ lw)[:, None]
    ground_tint = torch.tensor([0.85, 1.1, 0.8], dtype=torch.float32, device=dev)
    ground_tint = ground_tint / torch.dot(ground_tint, lw)
    sky_tint = torch.tensor([0.95, 1.0, 1.1], dtype=torch.float32, device=dev)
    sky_tint = sky_tint / torch.dot(sky_tint, lw)
    tint = torch.where(
        finite[..., None],
        torch.where(s["ground_hit"][..., None], ground_tint, obj_tint[s["hit_idx"]]),
        sky_tint,
    )
    rgb = torch.clamp(intensity[..., None] * tint, 0.0, 1.0)

    # optical flow: the exact ego-motion field (camera frame == world frame
    # for the axis-aligned analytic camera)
    f = s["f"]
    P = t_min[..., None] * s["dirs"]
    Pdot = -cam_vel - torch.cross(cam_omega.expand(P.shape), P, dim=-1)
    X, Y, Z = P[..., 0], P[..., 1], P[..., 2]
    Xd, Yd, Zd = Pdot[..., 0], Pdot[..., 1], Pdot[..., 2]
    safe_X = torch.where(torch.isfinite(X) & (X > 1e-6), X, 1.0)
    du = -f * (Yd * safe_X - Y * Xd) / (safe_X * safe_X)
    dv = -f * (Zd * safe_X - Z * Xd) / (safe_X * safe_X)
    flow = torch.where(finite[..., None], torch.stack([du, dv], dim=-1), 0.0)
    return rgb[0], s["depth"][0], flow[0]
