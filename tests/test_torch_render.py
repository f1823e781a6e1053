"""The port's analytic renderer (evfly_tpu_torch/sim/render.py) against the
JAX package's (evfly_tpu/sim/render.py) at 40x52, on random forests of
trees and of spheres, on the CPU.

The margin rule: the render has hard steps (the stripe sin(6 z) > 0, the
checker sin(4.2 x) sin(3.4 y) > 0, the nearest hit, the silhouettes), and
XLA's sin and sqrt and torch's differ in the last bits, so a pixel within a
few rounding steps of a step may take its other side.  ``render_margins``
gives each pixel's relative distance from every step; pixels below
RENDER_MARGIN (1e-5, about 170 f32 roundings of the argument) are left out
of the comparison, and their number is printed and held below 5% of the
frame (0.15-0.8% at 260x346 on twelve views).  Elsewhere:
- depth within 3e-5 (of max_depth): the nearer root of the ray's
  quadratic loses digits to the cancellation in b^2 - 4ac, so an obstacle
  20 m away near its silhouette rounds up to 2e-5 apart at 260x346 (1.4e-5
  at 40x52); the mean difference stays below 1e-6;
- intensity within 5e-6 (f32 sin and exp, and the depth's attenuation);
- difflog events equal wherever neither frame is flagged and the quotient
  lies farther than 1e-5 from a quantization crossing (difflog_margins).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evfly_tpu.ops.voxelizer import difflog_events as j_difflog
from evfly_tpu.sim.obstacles import generate_forest
from evfly_tpu.sim.render import render_batch as j_render_batch
from evfly_tpu.sim.render import render_depth_intensity as j_render
from evfly_tpu.sim.render import render_rgbd_flow as j_render_flow
from evfly_tpu_torch.ops.voxelizer import difflog_events, difflog_margins
from evfly_tpu_torch.sim import render

from torch_helpers import cuda_device  # noqa: F401  (fixture)

H, W = 40, 52
CPU = "cpu"
DEPTH_ATOL, INT_ATOL, EVENT_MARGIN = 3e-5, 5e-6, 1e-5


def _views(trees, n=4, seed=0, forest=generate_forest):
    """n (cam_pos (3,), centers (K, 3), radii (K,)) in random forests, one
    inert pad obstacle each; ``forest`` is the JAX package's
    generate_forest or the port's copy (the same draws: on the GPU machine
    the JAX package is inert)."""
    rng = np.random.default_rng(seed + (0 if trees else 100))
    out = []
    for _ in range(n):
        f = forest(rng, num_obstacles=30, trees=trees)
        c = np.concatenate([f.positions, [[1e6, 1e6, 1e6]]]).astype(np.float32)
        r = np.concatenate([f.radii, [0.0]]).astype(np.float32)
        pos = np.array([rng.uniform(0, 20), rng.uniform(-3, 3), rng.uniform(1, 3)], np.float32)
        out.append((pos, c, r))
    return out


def _jax(pos, c, r, trees):
    d, i = j_render(jnp.asarray(pos), jnp.asarray(c), jnp.asarray(r), H=H, W=W, is_trees=trees)
    return np.asarray(d), np.asarray(i)


def _held(label, got_d, got_i, ref_d, ref_i, margin):
    ok = margin >= render.RENDER_MARGIN
    flagged = int((~ok).sum())
    dd, di = np.abs(got_d - ref_d), np.abs(got_i - ref_i)
    print(f"{label}: {flagged} of {ok.size} pixels within the margin; away from it max "
          f"|depth diff| {dd[ok].max():.3g}, max |intensity diff| {di[ok].max():.3g}; "
          f"{int((di > INT_ATOL).sum())} pixels' intensity differs in all")
    assert flagged < ok.size // 20
    assert dd[ok].max() <= DEPTH_ATOL and dd[ok].mean() <= 1e-6
    assert di[ok].max() <= INT_ATOL
    return ok


@pytest.mark.parametrize("trees", [True, False], ids=["trees", "spheres"])
def test_render_depth_intensity_matches_jax(trees):
    for k, (pos, c, r) in enumerate(_views(trees)):
        d, i = render.render_depth_intensity(pos, c, r, H=H, W=W, is_trees=trees, device=CPU)
        assert d.shape == i.shape == (H, W) and d.dtype == torch.float32
        m = render.render_margins(pos, c, r, H=H, W=W, is_trees=trees, device=CPU).numpy()
        _held(f"view {k}", d.numpy(), i.numpy(), *_jax(pos, c, r, trees), m)
        assert 0.0 <= d.min() and d.max() <= 1.0 and 0.0 <= i.min() and i.max() <= 1.0


@pytest.mark.parametrize("trees", [True, False], ids=["trees", "spheres"])
def test_render_of_g_views_equals_single_views(trees):
    """G views, each with its own field, in one broadcast: bit for bit the
    single views; render_batch (one field, G cameras) against JAX's."""
    views = _views(trees, n=3, seed=7)
    pos = np.stack([v[0] for v in views])
    c, r = np.stack([v[1] for v in views]), np.stack([v[2] for v in views])
    d, i = render.render_depth_intensity(pos, c, r, H=H, W=W, is_trees=trees, device=CPU)
    margins = render.render_margins(pos, c, r, H=H, W=W, is_trees=trees, device=CPU)
    assert d.shape == (3, H, W) and margins.shape == (3, H, W)
    for g, (p, cg, rg) in enumerate(views):
        d1, i1 = render.render_depth_intensity(p, cg, rg, H=H, W=W, is_trees=trees, device=CPU)
        assert torch.equal(d[g], d1) and torch.equal(i[g], i1)
    db, ib = render.render_batch(pos, c[0], r[0], H=H, W=W, is_trees=trees, device=CPU)
    jd, ji = j_render_batch(jnp.asarray(pos), jnp.asarray(c[0]), jnp.asarray(r[0]), H=H, W=W,
                            is_trees=trees)
    mb = render.render_margins(pos, np.broadcast_to(c[0], c.shape).copy(),
                               np.broadcast_to(r[0], r.shape).copy(), H=H, W=W, is_trees=trees,
                               device=CPU).numpy()
    _held("render_batch", db.numpy(), ib.numpy(), np.asarray(jd), np.asarray(ji), mb)


@pytest.mark.parametrize("trees", [True, False], ids=["trees", "spheres"])
def test_difflog_of_rendered_frames_matches_jax(trees):
    """Two frames 0.1 m apart: the port's difflog events against JAX's,
    equal away from the render's margin in either frame and from the
    quantization crossings."""
    n_far = 0
    for k, (pos, c, r) in enumerate(_views(trees, n=3, seed=3)):
        pos2 = pos + np.array([0.1, 0.02, 0.0], np.float32)
        _, i0 = render.render_depth_intensity(pos, c, r, H=H, W=W, is_trees=trees, device=CPU)
        _, i1 = render.render_depth_intensity(pos2, c, r, H=H, W=W, is_trees=trees, device=CPU)
        got = difflog_events(i1, i0, device=CPU).numpy()
        (_, j0), (_, j1) = _jax(pos, c, r, trees), _jax(pos2, c, r, trees)
        ref = np.asarray(j_difflog(jnp.asarray(j1), jnp.asarray(j0)))
        ok = ((render.render_margins(pos, c, r, H=H, W=W, is_trees=trees, device=CPU).numpy()
               >= render.RENDER_MARGIN)
              & (render.render_margins(pos2, c, r, H=H, W=W, is_trees=trees,
                                       device=CPU).numpy() >= render.RENDER_MARGIN)
              & (difflog_margins(i1, i0, device=CPU).numpy() >= EVENT_MARGIN))
        assert (got != 0).any()
        np.testing.assert_array_equal(got[ok], ref[ok])
        n_far += int((got != ref).sum())
    print(f"difflog events differing at flagged pixels: {n_far}")


@pytest.mark.parametrize("trees", [True, False], ids=["trees", "spheres"])
def test_render_rgbd_flow_matches_jax(trees):
    rng = np.random.default_rng(5)
    for k, (pos, c, r) in enumerate(_views(trees, n=3, seed=11)):
        vel = rng.normal(size=3).astype(np.float32) * 3
        omega = rng.normal(size=3).astype(np.float32)
        rgb, d, flow = render.render_rgbd_flow(pos, vel, omega, c, r, H=H, W=W, is_trees=trees,
                                               device=CPU)
        assert rgb.shape == (H, W, 3) and d.shape == (H, W) and flow.shape == (H, W, 2)
        jrgb, jd, jflow = (np.asarray(x) for x in j_render_flow(
            jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(omega), jnp.asarray(c),
            jnp.asarray(r), H=H, W=W, is_trees=trees))
        ok = render.render_margins(pos, c, r, H=H, W=W, is_trees=trees,
                                   device=CPU).numpy() >= render.RENDER_MARGIN
        _, i = render.render_depth_intensity(pos, c, r, H=H, W=W, is_trees=trees, device=CPU)
        _held(f"rgbd view {k}", d.numpy(), i.numpy(), jd, np.asarray(_jax(pos, c, r, trees)[1]),
              ok.astype(float))
        np.testing.assert_allclose(rgb.numpy()[ok], jrgb[ok], rtol=0, atol=INT_ATOL * 2)
        # flow ~ f v / X px/s: its f32 rounding scales with the depth's
        np.testing.assert_allclose(flow.numpy()[ok], jflow[ok], rtol=1e-4, atol=1e-3)


def _sphere_scene():
    centers = np.array([[6.0, 0.0, 2.0], [9.0, -2.5, 2.0], [14.0, 2.5, 2.0]], np.float32)
    return centers, np.ones(3, np.float32)


def test_rgb_luminance_matches_grayscale():
    """Rec.601 luminance of the RGB render equals render_depth_intensity's
    grayscale everywhere, as tests/test_sim_render.py holds the JAX
    package's."""
    c, r = _sphere_scene()
    pos = np.array([0.0, 0.0, 2.0], np.float32)
    rgb, depth, _ = render.render_rgbd_flow(pos, [4.0, 0.0, 0.0], [0.0, 0.0, 0.0], c, r,
                                            H=64, W=86, device=CPU)
    d_ref, i_ref = render.render_depth_intensity(pos, c, r, H=64, W=86, device=CPU)
    lum = rgb.double().numpy() @ np.array([0.299, 0.587, 0.114])
    np.testing.assert_allclose(lum, i_ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), d_ref.numpy(), atol=1e-7)
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0
    assert (rgb[..., 0] - rgb[..., 2]).abs().max() > 0.05


def test_sky_flow_zero():
    c, r = _sphere_scene()
    _, depth, flow = render.render_rgbd_flow([0.0, 0.0, 2.0], [4.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                                             c, r, H=64, W=86, device=CPU)
    assert (depth[:4] >= 1.0 - 1e-6).all()
    assert flow[:4].abs().max() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("trees", [True, False], ids=["trees", "spheres"])
def test_render_on_the_card_matches_the_cpu(cuda_device, trees):
    """One view at 260x346 rendered on the card against the CPU, under the
    margin rule: away from RENDER_MARGIN depth within 5e-5 (the nearer
    root's cancellation, which nvcc contracts into an fma), its mean within
    1e-6, intensity within 5e-6; flow within the JAX bound above."""
    from evfly_tpu_torch.sim import generate_forest as port_forest

    pos, c, r = _views(trees, n=1, seed=21, forest=port_forest)[0]
    got = render.render_depth_intensity(pos, c, r, is_trees=trees, device=cuda_device)
    ref = render.render_depth_intensity(pos, c, r, is_trees=trees, device=CPU)
    ok = (render.render_margins(pos, c, r, is_trees=trees, device=CPU)
          >= render.RENDER_MARGIN).numpy()
    (gd, gi), (rd, ri) = ([t.cpu().numpy() for t in x] for x in (got, ref))
    dd, di = np.abs(gd - rd)[ok], np.abs(gi - ri)[ok]
    print(f"card vs CPU: {int((~ok).sum())} of {ok.size} pixels within the margin; away from "
          f"it max |depth diff| {dd.max():.3g} (mean {dd.mean():.3g}), max |intensity diff| "
          f"{di.max():.3g}")
    assert (~ok).sum() < ok.size // 20
    assert dd.max() <= 5e-5 and dd.mean() <= 1e-6 and di.max() <= INT_ATOL
    vel, omega = np.array([4.0, 0.5, 0.0], np.float32), np.zeros(3, np.float32)
    fg = render.render_rgbd_flow(pos, vel, omega, c, r, is_trees=trees, device=cuda_device)[2]
    fr = render.render_rgbd_flow(pos, vel, omega, c, r, is_trees=trees, device=CPU)[2]
    np.testing.assert_allclose(fg.cpu().numpy()[ok], fr.numpy()[ok], rtol=1e-4, atol=1e-3)
