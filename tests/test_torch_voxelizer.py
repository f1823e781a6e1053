"""The port's voxelizer (evfly_tpu_torch.ops.voxelizer) against the JAX package.

The same numpy events go through the JAX ``event_histogram_scaled_resized``
(its Pallas kernel in interpret mode on the CPU, as the JAX package's own
tests run it) and through the port's K3 wrapper, which on CPU tensors takes
its plain PyTorch version.  Output atol 3e-5 is the JAX package's own bound
for this kernel (tests/test_fused_voxelizer.py:68): the resize sums its taps
in another order.  The quantile is an order statistic of integer counts and
must be equal.
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
