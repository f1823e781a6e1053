"""The port's voxelizer (evfly_tpu_torch.ops.voxelizer) against the JAX package.

The same numpy events go through the JAX ``event_histogram`` (K1),
``event_histogram_scaled`` (K2) and ``event_histogram_scaled_resized`` (K3),
their Pallas kernels in interpret mode on the CPU as the JAX package's own
tests run them, and through the port's wrappers, which on CPU tensors take
their plain PyTorch versions.  Tolerances:

- K1: exact.  Counts are integers and the thresholds are applied with the
  same f32 multiplies (and subtract, for unequal thresholds).
- K2: the quantile exact (an order statistic of integer counts), the frame
  within 2e-5, the JAX package's own bound for this kernel
  (tests/test_fused_voxelizer.py:34).
- K3: the quantile exact, the output within 3e-5, the JAX package's bound
  (tests/test_fused_voxelizer.py:68): the resize sums its taps in another
  order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evfly_tpu.ops import percentile as jpercentile
from evfly_tpu.ops import voxelizer as jvox
from evfly_tpu.ops.imageops import resize_matrix as jax_resize_matrix
from evfly_tpu_torch.ops import imageops, percentile, voxelizer
from torch_helpers import cuda_device  # noqa: F401  (fixture)

ATOL = 3e-5
K2_ATOL = 2e-5


def _events(seed, B, N, H, W):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, W, (B, N)).astype(np.float32)
    y = rng.uniform(0, H, (B, N)).astype(np.float32)
    p = rng.choice([-1, 1], (B, N)).astype(np.int32)
    return x, y, p


def _jax_windows(x, y, p, H, W, ho, wo):
    """Per window: (JAX public output, JAX kernel's quantile)."""
    outs, qs = [], []
    for b in range(x.shape[0]):
        xb, yb, pb = (jnp.asarray(a[b]) for a in (x, y, p))
        outs.append(np.asarray(jvox.event_histogram_scaled_resized(xb, yb, pb, H, W, ho, wo)))
        xi, yi, sign = jvox._bin_events(xb, yb, pb, H, W)
        _, q = jvox._hist_pallas_fused_quantile_resize(
            yi, xi, sign, H=H, W=W, h_out=ho, w_out=wo, chunk=512, interpret=True,
            q=0.97, iters=18, thresh=0.2,
        )
        qs.append(float(q))
    return np.stack(outs), np.asarray(qs, np.float32)


@pytest.mark.parametrize(
    "H,W,ho,wo,B,N",
    [
        (64, 86, 20, 26, 1, 0),
        (64, 86, 20, 26, 3, 37),
        (64, 86, 20, 26, 2, 5000),
        (64, 86, 20, 26, 1, 20000),  # more than the one-block kernel of before took
        (260, 346, 60, 90, 2, 5000),
    ],
)
def test_plain_k3_matches_jax(H, W, ho, wo, B, N):
    x, y, p = _events(B * 1000 + N, B, N, H, W)
    ref, qref = _jax_windows(x, y, p, H, W, ho, wo)
    out, q = voxelizer.hist_scaled_resized(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(p), H, W, ho, wo
    )
    assert out.shape == (B, ho, wo)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    np.testing.assert_array_equal(q.numpy(), qref)


def test_sparse_window_zero_quantile():
    """<= 100 events at the sensor size: the 97th percentile of |counts| is
    exactly 0, so the frame is scaled by thresh (the exact-zero snap)."""
    H, W = 260, 346
    x, y, p = _events(5, 1, 80, H, W)
    ref, qref = _jax_windows(x, y, p, H, W, 60, 90)
    out, q = voxelizer.hist_scaled_resized(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(p), H, W, 60, 90
    )
    assert qref[0] == 0.0 and q.item() == 0.0
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert np.abs(out.numpy()).max() > 0


def test_entry_point_on_cpu_matches_jax():
    H, W = 64, 86
    x, y, p = _events(11, 2, 700, H, W)
    ref, _ = _jax_windows(x, y, p, H, W, 20, 26)
    out = voxelizer.event_histogram_scaled_resized(x, y, p, H, W, 20, 26, device="cpu")
    assert out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_bin_events_edge_rules():
    H, W = 4, 5
    x = np.array([0.0, 5.0, 4.999, -0.1, 5.1, 2.5, 2.5, 1.0, np.nan, 3.0], np.float32)
    y = np.array([0.0, 4.0, 3.999, 1.0, 1.0, 4.0, 4.01, 2.0, 1.0, np.inf], np.float32)
    p = np.array([1, -1, 1, 1, 1, 1, -1, 0, 1, 1], np.int32)
    jxi, jyi, jsign = (np.asarray(a) for a in jvox._bin_events(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(p), H, W))
    xi, yi, sign = voxelizer.bin_events(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(p), H, W)
    np.testing.assert_array_equal(sign.numpy(), jsign)
    # x == W and y == H land in the last bin; out of range, NaN and pol 0 get sign 0
    np.testing.assert_array_equal(sign.numpy(), [1, -1, 1, 0, 0, 1, 0, 0, 0, 0])
    live = jsign != 0
    np.testing.assert_array_equal(xi.numpy()[live], jxi[live])
    np.testing.assert_array_equal(yi.numpy()[live], jyi[live])
    assert xi.numpy()[1] == W - 1 and yi.numpy()[1] == H - 1
    assert ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).all()


@pytest.mark.parametrize("kind", ["counts", "continuous", "sparse"])
def test_approx_abs_quantile_bit_identical(kind):
    rng = np.random.default_rng({"counts": 1, "continuous": 2, "sparse": 3}[kind])
    if kind == "counts":
        frames = rng.integers(-6, 7, (4, 60, 90)).astype(np.float32) * np.float32(0.2)
    elif kind == "continuous":
        frames = rng.normal(size=(4, 37, 41)).astype(np.float32)
    else:
        frames = np.zeros((3, 50, 50), np.float32)
        frames[:, 3, 4] = 2.0
    ref = np.asarray(jpercentile.approx_abs_quantile(jnp.asarray(frames), 0.97))
    got = percentile.approx_abs_quantile(torch.from_numpy(frames), 0.97).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_in,n_out,align", [(260, 60, False), (346, 90, False), (15, 16, True)])
def test_resize_matrix_copy(n_in, n_out, align):
    np.testing.assert_array_equal(
        imageops.resize_matrix(n_in, n_out, align), jax_resize_matrix(n_in, n_out, align)
    )


def test_k3_wrapper_counts_only_kernel_launches():
    x, y, p = (torch.from_numpy(a) for a in _events(3, 1, 50, 16, 20))
    before = voxelizer.hist_scaled_resized.launches
    voxelizer.hist_scaled_resized(x, y, p, 16, 20, 8, 10)
    assert voxelizer.hist_scaled_resized.launches == before


@pytest.mark.gpu
def test_k3_kernel_matches_plain_on_gpu(cuda_device):
    x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _events(9, 16, 5000, 260, 346))
    out, q = voxelizer.hist_scaled_resized(x, y, p, 260, 346, 60, 90)
    ref, qref = voxelizer.hist_scaled_resized_plain(x, y, p, 260, 346, 60, 90)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    assert torch.equal(q, qref)


@pytest.mark.parametrize("n_in,n_out,align", [(260, 60, False), (346, 90, False), (20, 26, False)])
def test_kernel_taps_rebuild_resize_matrix(n_in, n_out, align):
    """The kernel's <= 2 taps per output row are exactly the rows of
    resize_matrix (edge rows with one merged tap included)."""
    taps, rh, _ = voxelizer._resize_operators(n_in, 4, n_out, 4, align, torch.device("cpu"))
    taps = taps[:n_out].numpy()
    R = np.zeros((n_out, n_in), np.float32)
    for i, (i0, i1, w0, w1) in enumerate(taps):
        R[i, int(i0)] += w0
        R[i, int(i1)] += w1
    np.testing.assert_array_equal(R, rh.numpy())


def _edge_events(seed, N, H, W):
    """Events over and past the frame's edges: x == W, y == H, negative
    coordinates, NaN and pol 0 among uniform ones."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, W + 2, N).astype(np.float32)
    y = rng.uniform(-2, H + 2, N).astype(np.float32)
    p = rng.choice([-1, 0, 1], N).astype(np.int32)
    if N >= 8:
        x[:2], y[2:4], x[4], y[5], x[6] = W, H, -0.5, np.nan, np.nan
        p[7] = 0
    return x, y, p


@pytest.mark.parametrize("thresholds", [(0.2, 0.2), (0.2, 0.3)], ids=["equal", "unequal"])
@pytest.mark.parametrize("N", [0, 37, 5000])
def test_plain_k1_matches_jax_exactly(N, thresholds):
    H, W = 64, 86
    x, y, p = _edge_events(N + 1, N, H, W)
    ref = np.asarray(jvox.event_histogram(jnp.asarray(x), jnp.asarray(y), jnp.asarray(p),
                                          H, W, *thresholds))
    got = voxelizer.event_histogram(x, y, p, H, W, *thresholds, device="cpu")
    assert got.shape == (H, W) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_ref = np.asarray(jvox.event_histogram_reference(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(p), H, W, *thresholds))
    got_ref = voxelizer.event_histogram_reference(x, y, p, H, W, *thresholds, device="cpu")
    np.testing.assert_allclose(got_ref.numpy(), ref_ref, atol=1e-6)


def test_k1_batch_equals_windows():
    """A (B, N) batch is B independent windows."""
    H, W = 32, 40
    x, y, p = _events(4, 3, 300, H, W)
    batch = voxelizer.event_histogram(x, y, p, H, W, 0.2, 0.3, device="cpu")
    for b in range(3):
        one = voxelizer.event_histogram(x[b], y[b], p[b], H, W, 0.2, 0.3, device="cpu")
        assert torch.equal(batch[b], one)


def test_k1_takes_more_events_than_int16_counts():
    """K1 has no cap: 40,000 events on one pixel, past any int16 count."""
    H, W = 16, 20
    x, y, p = _events(6, 1, 60000, H, W)
    x = np.concatenate([x[0], np.full(40000, 3.5, np.float32)])
    y = np.concatenate([y[0], np.full(40000, 7.25, np.float32)])
    p = np.concatenate([p[0], np.ones(40000, np.int32)])
    ref = np.asarray(jvox.event_histogram_reference(jnp.asarray(x), jnp.asarray(y),
                                                    jnp.asarray(p), H, W, 1.0, 1.0))
    got = voxelizer.event_histogram(x, y, p, H, W, 1.0, 1.0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[7, 3] > 40000


@pytest.mark.parametrize("N", [0, 37, 5000])
def test_plain_k2_matches_jax(N):
    H, W = 64, 86
    x, y, p = _edge_events(N + 11, N, H, W)
    xb, yb, pb = (jnp.asarray(a) for a in (x, y, p))
    ref = np.asarray(jvox.event_histogram_scaled(xb, yb, pb, H, W))
    xi, yi, sign = jvox._bin_events(xb, yb, pb, H, W)
    _, qref = jvox._hist_pallas_fused_quantile(
        yi, xi, sign, H=H, W=W, chunk=512, interpret=True, q=0.97, iters=18)
    got = voxelizer.event_histogram_scaled(x, y, p, H, W, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, atol=K2_ATOL)
    frame, q = voxelizer.hist_scaled(*(torch.from_numpy(a)[None] for a in (x, y, p)), H, W)
    assert torch.equal(frame[0], got)
    assert q.item() == float(qref)


def test_k2_zero_quantile_fallback():
    """tests/test_fused_voxelizer.py:37-50: a frame whose 97th percentile is
    0 is the value frame thresh * counts, clipped."""
    H, W = 32, 40
    x = np.array([3.0, 3.0, 3.0], np.float32)
    y = np.array([5.0, 5.0, 5.0], np.float32)
    p = np.array([1, 1, 1], np.int32)
    ref = np.asarray(jvox.event_histogram_scaled(jnp.asarray(x), jnp.asarray(y),
                                                 jnp.asarray(p), H, W))
    got = voxelizer.event_histogram_scaled(x, y, p, H, W, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=K2_ATOL)
    assert got[5, 3] == pytest.approx(min(3 * 0.2, 1.0))
    assert np.count_nonzero(got) == 1


def test_k1_k2_wrappers_count_only_kernel_launches():
    x, y, p = (torch.from_numpy(a) for a in _events(3, 1, 50, 16, 20))
    before = (voxelizer.hist_frame.launches, voxelizer.hist_scaled.launches)
    voxelizer.hist_frame(x, y, p, 16, 20)
    voxelizer.hist_scaled(x, y, p, 16, 20)
    assert (voxelizer.hist_frame.launches, voxelizer.hist_scaled.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("thresholds", [(0.2, 0.2), (0.2, 0.3)], ids=["equal", "unequal"])
@pytest.mark.parametrize("H,W", [(260, 346), (480, 640), (720, 1280)])
def test_k1_kernel_matches_plain_on_gpu(cuda_device, H, W, thresholds):
    """K1 against its plain version on each route: the band route
    (``hist_frame``) at every shape, and the route the shape takes
    (``hist_frame_routed``: 8 CTAs at 260x346, 16 at 640x480 with two
    thresholds and 1280x720 with one, else the band route), with 40,000
    events of a window on one pixel."""
    x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _events(8, 2, 100000, H, W))
    x[:, :40000], y[:, :40000] = 17.5, 101.5
    ref = voxelizer.hist_frame_plain(x, y, p, H, W, *thresholds)
    before = voxelizer.hist_frame.launches
    got = voxelizer.hist_frame(x, y, p, H, W, *thresholds)
    assert voxelizer.hist_frame.launches == before + 1
    assert torch.equal(got, ref)
    route = voxelizer.k1_route(H, W, thresholds[0] != thresholds[1])
    counts = (voxelizer.hist_frame.launches, voxelizer.hist_frame_cluster.by_route[str(route)])
    got = voxelizer.hist_frame_routed(x, y, p, H, W, *thresholds)
    assert (voxelizer.hist_frame.launches, voxelizer.hist_frame_cluster.by_route[str(route)]) \
        == (counts[0] + (route.kind == "band"), counts[1] + (route.kind == "cluster"))
    assert torch.equal(got, ref)


@pytest.mark.gpu
def test_k2_kernel_matches_plain_on_gpu(cuda_device):
    x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _events(10, 16, 5000, 260, 346))
    out, q = voxelizer.hist_scaled(x, y, p, 260, 346)
    ref, qref = voxelizer.hist_scaled_plain(x, y, p, 260, 346)
    torch.testing.assert_close(out, ref, atol=K2_ATOL, rtol=0)
    assert torch.equal(q, qref)


# ------------------------------------ more events per window than K2 and K3 take


def test_scaled_route_by_shape():
    """K2 and K3 take a batch on their cluster kernels up to their caps (the
    band and the window's list of large counts in a block's shared memory);
    any larger batch takes K1's counts and a scale kernel."""
    for H, W in ((260, 346), (64, 86)):
        cap = voxelizer.scaled_cluster_cap(H, W)
        for n in (5000, 20000, 32767, 32768, 40000, cap):
            assert voxelizer.scaled_route(n, H, W) == "cluster"
        assert voxelizer.scaled_route(cap + 1, H, W) == "k1"
    assert voxelizer.scaled_cluster_cap(260, 346) == 823807
    assert voxelizer.scaled_route(823808, 260, 346) == "k1"


def _cap_events(seed, N, H, W, hot=1000):
    """N events, ``hot`` of them on one pixel, so the quantile is not 0 and a
    count passes what a window of uniform events reaches."""
    x, y, p = _events(seed, 1, N, H, W)
    x[0, :hot], y[0, :hot], p[0, :hot] = 5.5, 9.25, 1
    return x, y, p


def test_k1_route_above_the_cap_matches_jax():
    """40,000 events in one window through both scaled entry points (the K1
    route; on the CPU, K1's plain version) against the JAX functions."""
    H, W, ho, wo, N = 64, 86, 20, 26, 40000
    x, y, p = _cap_events(30, N, H, W)
    frame = voxelizer.event_histogram_scaled(x[0], y[0], p[0], H, W, device="cpu")
    small = voxelizer.event_histogram_scaled_resized(x, y, p, H, W, ho, wo, device="cpu")
    jx, jy, jp = (jnp.asarray(a[0]) for a in (x, y, p))
    ref = np.asarray(jvox.event_histogram_scaled(jx, jy, jp, H, W))
    ref_small = np.asarray(jvox.event_histogram_scaled_resized(jx, jy, jp, H, W, ho, wo))
    np.testing.assert_allclose(frame.numpy(), ref, atol=K2_ATOL)
    np.testing.assert_allclose(small[0].numpy(), ref_small, atol=ATOL)


def test_k1_route_quantile_equals_the_plain_version():
    H, W, N = 64, 86, 40000
    x, y, p = (torch.from_numpy(a) for a in _cap_events(31, N, H, W))
    counts = voxelizer.hist_frame(x, y, p, H, W, 1.0, 1.0)
    frame, q = voxelizer.scale_counts(counts)
    ref, qref = voxelizer.hist_scaled_plain(x, y, p, H, W)
    assert torch.equal(q, qref) and torch.equal(frame, ref)
    assert torch.equal(voxelizer.hist_scaled_routed(x, y, p, H, W)[0], ref)
    small, qs = voxelizer.hist_scaled_resized_routed(x, y, p, H, W, 20, 26)
    ref_small, qs_ref = voxelizer.hist_scaled_resized_plain(x, y, p, H, W, 20, 26)
    assert torch.equal(qs, qs_ref)
    torch.testing.assert_close(small, ref_small, atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_scaled_entry_points_above_the_cap_on_gpu(cuda_device):
    H, W = 260, 346
    # past K2's cap and K3's
    N = max(voxelizer.scaled_cluster_cap(H, W), voxelizer.resized_cluster_cap(H, W, 60, 90)) + 1
    x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _cap_events(32, N, H, W))
    before = (voxelizer.hist_frame_cluster.launches, voxelizer.scale_counts.launches,
              voxelizer.scale_counts_resized.launches)
    frame, q = voxelizer.hist_scaled_routed(x, y, p, H, W)
    small, qs = voxelizer.hist_scaled_resized_routed(x, y, p, H, W, 60, 90)
    assert (voxelizer.hist_frame_cluster.launches, voxelizer.scale_counts.launches,
            voxelizer.scale_counts_resized.launches) == (before[0] + 2, before[1] + 1,
                                                         before[2] + 1)
    ref, qref = voxelizer.hist_scaled_plain(x, y, p, H, W)
    ref_small, qs_ref = voxelizer.hist_scaled_resized_plain(x, y, p, H, W, 60, 90)
    assert torch.equal(q, qref) and torch.equal(qs, qs_ref)
    torch.testing.assert_close(frame, ref, atol=K2_ATOL, rtol=0)
    torch.testing.assert_close(small, ref_small, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [0, 8, 16], ids=["band", "cluster8", "cluster16"])
def test_k1_takes_more_windows_than_grid_y_on_gpu(cuda_device, cluster):
    """70,000 windows, past grid.y's 65,535, on the band route and on
    clusters of 8 and 16 CTAs (windows x CTAs on grid.x)."""
    H, W = 64, 86
    x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _events(33, 70000, 16, H, W))
    if cluster:
        got = voxelizer._frame_cluster_launch(x, y, p, H, W, 0.2, 0.2, cluster)
    else:
        got = voxelizer.hist_frame(x, y, p, H, W)
    assert torch.equal(got, voxelizer.hist_frame_plain(x, y, p, H, W))
