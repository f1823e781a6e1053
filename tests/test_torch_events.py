"""The port's event generation and K1 over time windows against the JAX package.

The same numpy inputs go through the JAX functions (the Pallas K1 in
interpret mode on the CPU, as tests/test_torch_voxelizer.py runs it) and
through the port's on the CPU:

- ``event_frames_from_windows``: bit for bit, on unsorted events with
  out-of-range coordinates, pol 0 and events stamped on window edges,
  over overlapping, reversed, empty and NaN-edged windows, with one and with
  two thresholds (two thresholds: ``fused_two_pass``, the JAX function's
  FMA).
- ESIM (``esim_event_frames``, ``_esim_block``, ``esim_event_frames_upsampled``)
  and ``difflog_events``: XLA's ``log`` and PyTorch's (and CUDA's ``logf``
  on the card) may differ by an ulp, and a count flips where the quotient
  its floor takes sits on an integer.  So the frames are equal at every
  pixel whose quotient lay farther than 1e-5 from an integer (for ESIM in
  this window or an earlier one, the carried reference passing a flip on:
  ``esim_margins``; for difflog also the frame's max |difflog| /
  max(thresh) from 1: ``difflog_margins``); the pixels that differ are
  counted, each within one quantum (the larger threshold), and the
  per-pixel sums over all windows agree within 1e-5 + one quantum.  On
  flow-upsampled frames, which agree within 1e-5 (next item), the margin is
  1e-3: a change of 1e-5 in an intensity of 0.05 moves log I / 0.2 by 1e-3.
- ``warp_backward``, ``interp_pair``, ``upsample_sequence``,
  ``upsample_fixed``, ``interpolate_bilinear_mm`` within 1e-5 (f32 sums and
  products in another order or contracted); ``linear_log_upsample``,
  ``esim_events_list`` and ``adaptive_factor`` (with inf and NaN flows)
  exactly.
- ``data.to_events`` over an h5 dataset and through its CLI, against the
  JAX package's ``generate_events_for_dataset``.

The ``gpu`` tests hold K1's window launch (``hist_frame_windows``) against
its plain version on the card, bit for bit, on each of its routes (8 and
16 CTAs, the band route), and count its launches.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evfly_tpu.data import to_events as jto_events
from evfly_tpu.ops import esim as jesim
from evfly_tpu.ops import imageops as jimageops
from evfly_tpu.ops import upsample as jupsample
from evfly_tpu.ops import voxelizer as jvox
from evfly_tpu_torch.data import to_events
from evfly_tpu_torch.ops import esim, imageops, upsample, voxelizer
from torch_helpers import cuda_device  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN, FLOW_MARGIN = 1e-5, 1e-3
UPSAMPLE_ATOL = 1e-5


# ------------------------------------------------------------------ helpers

def assert_quantized_close(got, ref, margins, quantum, margin=MARGIN):
    """got == ref wherever ``margins`` >= margin; elsewhere within one
    quantum; per-pixel sums over the windows within 1e-5 + one quantum.
    Returns the count of pixels that differ."""
    got, ref, margins = (np.asarray(a) for a in (got, ref, margins))
    assert got.shape == ref.shape == margins.shape
    diff = got != ref
    assert not (diff & (margins >= margin)).any(), \
        f"{int((diff & (margins >= margin)).sum())} pixels differ away from a crossing"
    assert np.abs(got - ref).max(initial=0.0) <= quantum + 1e-6
    if got.ndim == 3:
        assert np.abs(got.sum(0) - ref.sum(0)).max() <= 1e-5 + quantum
    return int(diff.sum())


def texture_trajectory(T=8, H=30, W=40, dt=0.05, speeds=None, seed=0):
    """A smooth texture translating along x with its exact flow field:
    (frames (T, H, W) in [0.05, 0.95], flows (T, H, W, 2) px/s, times (T,) s).
    ``speeds`` (T,) px per frame."""
    rng = np.random.default_rng(seed)
    if speeds is None:
        speeds = np.linspace(0.5, 6.0, T)
    shift = np.concatenate([[0.0], np.cumsum(speeds[1:])])
    a, b, c = rng.uniform(0.1, 0.3, 3)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    frames = np.stack([
        0.5 + 0.3 * np.sin(a * (xx - s)) * np.cos(b * yy) + 0.15 * np.sin(c * (xx - s + yy))
        for s in shift]).astype(np.float32)
    flows = np.zeros((T, H, W, 2), np.float32)
    flows[..., 0] = (speeds / dt)[:, None, None]
    return frames, flows, np.arange(T) * dt


def _window_case(seed, N=4000, H=30, W=40):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 1.0, N).astype(np.float32)
    t[:40] = 0.25          # on a window edge: in the window it starts
    t[40:60] = 0.5
    t[60:70] = 1.5         # after every window
    x = rng.uniform(-2, W + 2, N).astype(np.float32)
    y = rng.uniform(-2, H + 2, N).astype(np.float32)
    x[:5], y[:5] = W, H    # the right edges land in the last bin
    p = rng.choice([-1, 0, 1], N).astype(np.int32)
    # overlapping, reversed (empty), zero-length, nested, beyond the data
    starts = np.array([0.0, 0.25, 0.5, 0.1, 0.7, 0.9, 0.3, 0.0, 1.2], np.float32)
    ends = np.array([0.25, 0.5, 1.0, 0.6, 0.7, 0.2, 0.3, 1.0, 2.0], np.float32)
    return t, x, y, p, starts, ends


# ---------------------------------------------------- K1 over time windows

@pytest.mark.parametrize("thresholds", [(0.2, 0.2), (0.2, 0.3), (0.3, 0.2)],
                         ids=["one_threshold", "pos_lt_neg", "pos_gt_neg"])
def test_event_frames_from_windows_matches_jax(thresholds):
    t, x, y, p, starts, ends = _window_case(1)
    H, W = 30, 40
    ref = np.asarray(jvox.event_frames_from_windows(
        *(jnp.asarray(a) for a in (t, x, y, p, starts, ends)), H, W, *thresholds))
    got = voxelizer.event_frames_from_windows(t, x, y, p, starts, ends, H, W, *thresholds,
                                              device="cpu")
    assert got.dtype == torch.float32 and got.shape == (len(starts), H, W)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[2] != 0).any() and not ref[4].any() and not ref[5].any()


def test_event_frames_from_windows_unsorted_equals_sorted():
    t, x, y, p, starts, ends = _window_case(2)
    order = np.argsort(t, kind="stable")
    a = voxelizer.event_frames_from_windows(t, x, y, p, starts, ends, 30, 40, device="cpu")
    b = voxelizer.event_frames_from_windows(t[order], x[order], y[order], p[order], starts,
                                            ends, 30, 40, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_window_offsets_are_the_time_masks():
    """[begin, end) of the sorted stream holds exactly t0 <= t < t1; NaN
    times lie in no window, NaN edges give empty windows."""
    t, _, _, _, starts, ends = _window_case(3)
    t = t.copy()
    t[100:103] = np.nan
    starts = np.append(starts, [np.nan, 0.1]).astype(np.float32)
    ends = np.append(ends, [0.9, np.nan]).astype(np.float32)
    order, begin, end = voxelizer.window_offsets(*(torch.from_numpy(a) for a in (t, starts, ends)))
    ts = t[order.numpy()]
    for b in range(len(starts)):
        with np.errstate(invalid="ignore"):
            want = np.sort(np.nonzero((t >= starts[b]) & (t < ends[b]))[0])
        got = np.sort(order.numpy()[begin[b]:max(begin[b], end[b])])
        np.testing.assert_array_equal(got, want)
    assert np.isnan(ts[-3:]).all()


@pytest.mark.parametrize("thresholds", [(0.2, 0.2), (0.2, 0.3)])
def test_windows_plain_is_one_frame_per_window(thresholds):
    """hist_frame_windows_plain: window b's frame is hist_frame_plain's of
    its events (fused_two_pass's value with two thresholds)."""
    rng = np.random.default_rng(4)
    N, H, W = 3000, 20, 24
    x = torch.tensor(rng.uniform(0, W, N), dtype=torch.float32)
    y = torch.tensor(rng.uniform(0, H, N), dtype=torch.float32)
    p = torch.tensor(rng.choice([-1, 1], N), dtype=torch.int32)
    begin = torch.tensor([0, 100, 2500, 700, 3000, 50], dtype=torch.int64)
    end = torch.tensor([1000, 100, 3000, 2900, 3000, 10], dtype=torch.int64)
    got = voxelizer.hist_frame_windows(x, y, p, begin, end, H, W, *thresholds)
    assert voxelizer.hist_frame_windows.launches == 0  # the CPU takes the plain version
    for b in range(len(begin)):
        s = slice(int(begin[b]), max(int(begin[b]), int(end[b])))
        if thresholds[0] == thresholds[1]:
            ref = voxelizer.hist_frame_plain(x[None, s], y[None, s], p[None, s], H, W,
                                             *thresholds)[0]
        else:
            sign = voxelizer.bin_events(x[s], y[s], p[s], H, W)
            idx = sign[1] * W + sign[0]
            pc = torch.zeros(H * W).index_add_(0, idx, sign[2].clamp_min(0))
            nc = torch.zeros(H * W).index_add_(0, idx, (-sign[2]).clamp_min(0))
            ref = voxelizer.fused_two_pass(pc, nc, *thresholds).reshape(H, W)
        np.testing.assert_array_equal(got[b].numpy(), ref.numpy())


def test_fused_two_pass_is_one_rounding():
    """fused_two_pass against an exact rational evaluation rounded once."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    pc = rng.integers(0, 3000, 4000).astype(np.float32)
    nc = rng.integers(0, 3000, 4000).astype(np.float32)
    got = voxelizer.fused_two_pass(torch.from_numpy(pc), torch.from_numpy(nc), 0.2, 0.3).numpy()
    pos, neg = np.float32(0.2), np.float32(0.3)
    for i in range(0, 4000, 37):
        exact = Fraction(float(pos)) * int(pc[i]) - Fraction(float(np.float32(neg * nc[i])))
        # the f32 nearest the exact value: round through f64 (exact here)
        assert got[i] == np.float32(float(exact))


# ---------------------------------------------------------- ESIM and difflog

def test_esim_event_frames_matches_jax():
    frames, _, _ = texture_trajectory(T=10)
    ref = np.asarray(jesim.esim_event_frames(jnp.asarray(frames)))
    got = esim.esim_event_frames(frames, device="cpu")
    margins = esim.esim_margins(frames, device="cpu")
    assert got.shape == (9, 30, 40) and (ref != 0).any()
    assert_quantized_close(got, ref, margins, 0.2)


def test_esim_unequal_thresholds_and_block():
    frames, _, _ = texture_trajectory(T=7, seed=2)
    ref = np.asarray(jesim.esim_event_frames(jnp.asarray(frames), 0.15, 0.25))
    got = esim.esim_event_frames(frames, 0.15, 0.25, device="cpu")
    assert_quantized_close(got, ref, esim.esim_margins(frames, 0.15, 0.25, device="cpu"), 0.25)
    ref0 = jnp.log(jnp.asarray(frames[0]) + 1e-10)
    jsum, jref = jesim._esim_block(ref0, jnp.asarray(frames[1:]), 0.15, 0.25)
    tsum, tref = esim._esim_block(torch.log(torch.from_numpy(frames[0]) + 1e-10),
                                  torch.from_numpy(frames[1:]), 0.15, 0.25)
    # the block's sum telescopes to the sum of the windows
    np.testing.assert_allclose(tsum.numpy(), got.numpy().sum(0), atol=1e-5)
    margins = esim.esim_margins(frames, 0.15, 0.25, device="cpu")[-1].numpy()
    assert_quantized_close(tsum, np.asarray(jsum), margins, 0.25)
    # the carried level: the logs' ulp, and one quantum where a count flipped
    bound = np.where(margins < MARGIN, 0.25, 0.0) + 1e-5
    assert (np.abs(tref.numpy() - np.asarray(jref)) <= bound).all()


def test_esim_margins_bound_a_flip():
    """Pixels whose quotient lies on an integer: a log one ulp off flips
    them, and esim_margins marks exactly those."""
    frames = np.full((3, 2, 2), 0.5, np.float32)
    frames[1] = np.float32(np.exp(np.log(0.5) + 0.4))   # two quanta up, give or take an ulp
    frames[2] = frames[1]
    margins = esim.esim_margins(frames, device="cpu").numpy()
    assert (margins[0] < MARGIN).all() and (margins[1] < MARGIN).all()
    frames[1] = 0.6
    assert (esim.esim_margins(frames, device="cpu").numpy()[0] > MARGIN).all()


def test_difflog_matches_jax():
    frames, _, _ = texture_trajectory(T=6, seed=3)
    still = np.stack([frames[0], frames[0] * 1.05])  # every |difflog| below 0.2: zeroed
    for thresholds in ((0.2, 0.2), (0.1, 0.3)):
        for a, b in ((frames[1], frames[0]), (frames[5], frames[2]), (still[1], still[0])):
            ref = np.asarray(jvox.difflog_events(jnp.asarray(a), jnp.asarray(b), *thresholds))
            got = voxelizer.difflog_events(a, b, *thresholds, device="cpu")
            margins = voxelizer.difflog_margins(a, b, *thresholds, device="cpu")
            assert_quantized_close(got, ref, margins, max(thresholds))
    assert not voxelizer.difflog_events(still[1], still[0], device="cpu").any()
    # a batch of pairs: each pair on its own
    batch = voxelizer.difflog_events(np.stack([frames[1], still[1]]),
                                     np.stack([frames[0], still[0]]), device="cpu")
    np.testing.assert_array_equal(batch[0].numpy(),
                                  voxelizer.difflog_events(frames[1], frames[0],
                                                           device="cpu").numpy())
    assert not batch[1].any()


@pytest.mark.parametrize("fixed_factor", [None, 3])
def test_esim_upsampled_matches_jax(fixed_factor):
    frames, flows, ts = texture_trajectory(T=6, seed=4, speeds=np.array([0, 0.5, 2, 5, 9, 3.]))
    ref = jesim.esim_event_frames_upsampled(frames, flows, ts, fixed_factor=fixed_factor)
    got = esim.esim_event_frames_upsampled(frames, flows, ts, fixed_factor=fixed_factor,
                                           device="cpu")
    fine, _, factors = upsample.upsample_sequence(frames, flows, ts, fixed_factor=fixed_factor,
                                                  return_factors=True, device="cpu")
    _, _, jfactors = jupsample.upsample_sequence(frames, flows, ts, fixed_factor=fixed_factor,
                                                 return_factors=True)
    np.testing.assert_array_equal(factors, jfactors)
    assert factors.max() == (9 if fixed_factor is None else 3)
    last = np.cumsum(factors) - 1  # each pair's last fine step
    margins = esim.esim_margins(fine, device="cpu").numpy()[last]
    assert_quantized_close(got, ref, margins, 0.2, FLOW_MARGIN)


def test_esim_events_list_equals_jax():
    frames, _, ts = texture_trajectory(T=5, seed=5)
    ref = jesim.esim_events_list(frames, ts)
    got = esim.esim_events_list(frames, ts)
    assert len(got[0]) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype


# ---------------------------------------------------------------- upsampling

def test_warp_backward_matches_jax():
    frames, flows, _ = texture_trajectory(T=2, seed=6)
    rng = np.random.default_rng(6)
    disp = rng.normal(0, 4, (30, 40, 2)).astype(np.float32)  # past the borders too
    ref = np.asarray(jupsample.warp_backward(jnp.asarray(frames[0]), jnp.asarray(disp)))
    got = upsample.warp_backward(torch.from_numpy(frames[0]), torch.from_numpy(disp))
    np.testing.assert_allclose(got.numpy(), ref, atol=UPSAMPLE_ATOL)
    # f16 flows are read as f32
    d16 = disp.astype(np.float16)
    ref16 = np.asarray(jupsample.warp_backward(jnp.asarray(frames[0]), jnp.asarray(d16)))
    got16 = upsample.warp_backward(torch.from_numpy(frames[0]), torch.from_numpy(d16))
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(got16.numpy(), ref16, atol=UPSAMPLE_ATOL)


@pytest.mark.parametrize("factor", [1, 2, 5])
def test_interp_pair_matches_jax(factor):
    frames, flows, _ = texture_trajectory(T=2, seed=7, speeds=np.array([0.0, 4.0]))
    args = (frames[0], frames[1], flows[0], flows[1])
    ref = np.asarray(jupsample.interp_pair(*(jnp.asarray(a) for a in args), 0.05, factor))
    got = upsample.interp_pair(*(torch.from_numpy(a) for a in args), 0.05, factor)
    assert got.shape == ref.shape == (factor - 1, 30, 40)
    np.testing.assert_allclose(got.numpy(), ref, atol=UPSAMPLE_ATOL)


def test_upsample_sequence_and_fixed_match_jax():
    frames, flows, ts = texture_trajectory(T=5, seed=8, speeds=np.array([0, 1, 3.5, 0.2, 7]))
    rf, rt, rk = jupsample.upsample_sequence(frames, flows, ts, return_factors=True)
    gf, gt, gk = upsample.upsample_sequence(frames, flows, ts, return_factors=True,
                                            device="cpu")
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_array_equal(gt, rt)
    np.testing.assert_allclose(gf, rf, atol=UPSAMPLE_ATOL)
    ref = np.asarray(jupsample.upsample_fixed(jnp.asarray(frames), jnp.asarray(flows), 0.05, 3))
    got = upsample.upsample_fixed(torch.from_numpy(frames), torch.from_numpy(flows), 0.05, 3)
    assert got.shape == ref.shape == (13, 30, 40)
    np.testing.assert_allclose(got.numpy(), ref, atol=UPSAMPLE_ATOL)
    np.testing.assert_array_equal(upsample.linear_log_upsample(frames, 4),
                                  jupsample.linear_log_upsample(frames, 4))


def test_adaptive_factor_equals_jax_with_inf_and_nan():
    rng = np.random.default_rng(9)
    f = rng.normal(0, 30, (6, 8, 2)).astype(np.float32)
    inf = f.copy()
    inf[2, 3, 0] = np.inf
    nan = f.copy()
    nan[1, 1, 1] = np.nan
    with np.errstate(over="ignore"):
        f16 = (f * 4000).astype(np.float16)  # past 65504: inf in f16
    cases = [(f, f, 0.02), (f, None, 0.05), (None, None, 0.1), (inf, f, 0.01),
             (f, nan, 0.01), (np.zeros_like(f), np.zeros_like(f), 0.1), (f16, f, 0.02),
             (f, f, 10.0)]
    for f0, f1, dt in cases:
        for max_disp, max_factor in ((1.0, 16), (0.5, 8)):
            got = upsample.adaptive_factor(f0, f1, dt, max_disp, max_factor)
            assert got == jupsample.adaptive_factor(f0, f1, dt, max_disp, max_factor)
            assert isinstance(got, int)
    assert upsample.adaptive_factor(inf, f, 0.01) == 16
    assert upsample.adaptive_factor(f, nan, 0.01, 1.0, 8) == 8


@pytest.mark.parametrize("size,align_corners", [((15, 20), False), ((45, 71), True),
                                                ((30, 40), False)])
def test_interpolate_bilinear_mm_matches_jax(size, align_corners):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 3, 30, 40)).astype(np.float32)
    ref = np.asarray(jimageops.interpolate_bilinear_mm(jnp.asarray(x), size, align_corners))
    got = imageops.interpolate_bilinear_mm(torch.from_numpy(x), size, align_corners)
    np.testing.assert_allclose(got.numpy(), ref, atol=UPSAMPLE_ATOL)
    gather = imageops.interpolate_bilinear(torch.from_numpy(x), size, align_corners)
    np.testing.assert_allclose(got.numpy(), gather.numpy(), atol=UPSAMPLE_ATOL)


# --------------------------------------------------------------- to_events

def _write_dataset(path, T=6, seed=11):
    import h5py

    with h5py.File(path, "w") as f:
        for i, speeds in enumerate((np.array([0, 1, 2, 4, 1, 0.5]), np.linspace(0.2, 3, T))):
            frames, flows, ts = texture_trajectory(T=T, seed=seed + i, speeds=speeds)
            g = f.create_group(f"traj_{i:03d}")
            g.create_dataset("ims", data=frames)
            g.create_dataset("flows", data=flows.astype(np.float16))  # as datagen stores them
            data = np.zeros((T, 21), np.float32)
            data[:, 1] = ts
            g.create_dataset("data", data=data)


def _margins(path, scheme, thresh=0.2):
    """Per trajectory, the margins of the scheme's crossings (CPU)."""
    import h5py

    out = []
    with h5py.File(path, "r") as f:
        for name in f:
            ims = np.asarray(f[name]["ims"][()], np.float32)
            if scheme == "esim":
                out.append(esim.esim_margins(ims, thresh, thresh, device="cpu").numpy())
            elif scheme == "difflog":
                out.append(voxelizer.difflog_margins(ims[1:], ims[:-1], thresh, thresh,
                                                     device="cpu").numpy())
            else:
                flows = np.asarray(f[name]["flows"][()], np.float32)
                ts = np.asarray(f[name]["data"][()], np.float32)[:, 1]
                fine, _, k = upsample.upsample_sequence(ims, flows, ts, return_factors=True,
                                                        device="cpu")
                out.append(esim.esim_margins(fine, thresh, thresh,
                                             device="cpu").numpy()[np.cumsum(k) - 1])
    return out


@pytest.mark.parametrize("scheme", to_events.SCHEMES)
def test_to_events_dataset_matches_jax(tmp_path, scheme):
    import h5py

    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    _write_dataset(ours / "data.h5")
    _write_dataset(theirs / "data.h5")
    got = to_events.generate_events_for_dataset(str(ours / "data.h5"), scheme, device="cpu")
    ref = jto_events.generate_events_for_dataset(str(theirs / "data.h5"), scheme)
    margin = FLOW_MARGIN if scheme == "esim_flow" else MARGIN
    for g, r, m in zip(got, ref, _margins(ours / "data.h5", scheme)):
        assert g.dtype == np.float32 and g.shape == r.shape == (5, 30, 40)
        assert_quantized_close(g, r, m, 0.2, margin)
    with h5py.File(ours / "data.h5", "r") as f:
        for name, g in zip(f, got):
            np.testing.assert_array_equal(f[name]["evs"][()], g)
    suffix = "_difflog" if scheme == "difflog" else ""
    saved = np.load(ours / f"evs_frames{suffix}.npy", allow_pickle=True)
    assert len(saved) == 2 and all(np.array_equal(s, g) for s, g in zip(saved, got))


def test_to_events_cli_and_h5_view(tmp_path):
    """``python -m evfly_tpu_torch.data.to_events --device cpu`` writes evs
    into the h5 and the .npy beside it; package_h5 lists them."""
    import h5py

    _write_dataset(tmp_path / "data.h5")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", "evfly_tpu_torch.data.to_events", "--dataset",
                           str(tmp_path / "data"), "--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    saved = np.load(tmp_path / "evs_frames.npy", allow_pickle=True)
    with h5py.File(tmp_path / "data.h5", "r") as f:
        names = list(f)
        for name, s in zip(names, saved):
            np.testing.assert_array_equal(f[name]["evs"][()], s)
            np.testing.assert_array_equal(
                s, esim.esim_event_frames(f[name]["ims"][()], device="cpu").numpy())
    view = subprocess.run([sys.executable, "-m", "evfly_tpu_torch.data.package_h5",
                           str(tmp_path / "data.h5"), "view"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert view.returncode == 0 and all(n in view.stdout for n in names)
    assert "- evs:" in view.stdout


def test_to_events_esim_flow_needs_flows(tmp_path):
    import h5py

    with h5py.File(tmp_path / "d.h5", "w") as f:
        f.create_group("t").create_dataset("ims", data=np.ones((3, 4, 4), np.float32))
    with pytest.raises(ValueError, match="flows"):
        to_events.generate_events_for_dataset(str(tmp_path / "d.h5"), "esim_flow",
                                              device="cpu")


# --------------------------------------------------------------------- card

def _stream(seed, N, H, W, device, t_max=2.0):
    rng = np.random.default_rng(seed)
    t = torch.tensor(rng.uniform(0, t_max, N), dtype=torch.float32, device=device)
    x = torch.tensor(rng.uniform(0, W, N), dtype=torch.float32, device=device)
    y = torch.tensor(rng.uniform(0, H, N), dtype=torch.float32, device=device)
    p = torch.tensor(rng.choice([-1, 1], N), dtype=torch.int32, device=device)
    return t, x, y, p


# K1's routes by name (str of voxelizer.K1Route), for forcing one
K1_ROUTES = {"cluster8": voxelizer.K1Route("cluster", 8),
             "cluster16": voxelizer.K1Route("cluster", 16), "band": voxelizer.BAND_ROUTE}


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,thresholds,route", [
    (260, 346, (0.2, 0.2), "cluster8"), (260, 346, (0.2, 0.3), "cluster8"),
    (480, 640, (0.2, 0.2), "cluster8"), (480, 640, (0.2, 0.3), "cluster16"),
    (720, 1280, (0.2, 0.2), "cluster16"), (720, 1280, (0.2, 0.3), "band"),
])
def test_k1_windows_kernel_matches_plain(cuda_device, H, W, thresholds, route):
    """K1's window launch on the route its shape takes, one launch per
    call, bit for bit against its plain version: sorted, shuffled,
    overlapping and empty windows."""
    assert str(voxelizer.k1_route(H, W, thresholds[0] != thresholds[1])) == route
    t, x, y, p = _stream(1, 300_000, H, W, cuda_device)
    edges = torch.linspace(0, 2.0, 31, device=cuda_device)
    starts = torch.cat([edges[:-1], torch.tensor([0.1, 0.5, 1.0, 1.5], device=cuda_device)])
    ends = torch.cat([edges[1:], torch.tensor([0.9, 0.5, 0.2, 1.9], device=cuda_device)])
    for perm in (None, torch.randperm(len(t), device=cuda_device)):
        tt, xx, yy, pp = (a if perm is None else a[perm] for a in (t, x, y, p))
        order, begin, end = voxelizer.window_offsets(tt, starts, ends)
        args = (xx[order], yy[order], pp[order], begin, end, H, W, *thresholds)
        n0 = voxelizer.hist_frame_windows.launches
        r0 = voxelizer.hist_frame_windows.by_route[route]
        got = voxelizer.hist_frame_windows(*args)
        torch.cuda.synchronize()
        assert voxelizer.hist_frame_windows.launches == n0 + 1
        assert voxelizer.hist_frame_windows.by_route[route] == r0 + 1
        ref = voxelizer.hist_frame_windows_plain(*args)
        assert torch.equal(got, ref)
        # the routed entry point: the same frames, one more launch
        frames = voxelizer.event_frames_from_windows(tt, xx, yy, pp, starts, ends, H, W,
                                                     *thresholds, device=cuda_device)
        assert torch.equal(frames, ref)
        assert voxelizer.hist_frame_windows.launches == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("thresholds", [(0.2, 0.2), (0.2, 0.3)], ids=["one", "two"])
@pytest.mark.parametrize("route", list(K1_ROUTES))
def test_k1_windows_unaligned_and_short(cuda_device, monkeypatch, route, thresholds):
    """Windows starting at every offset mod 4 (no 16-byte alignment) and of
    0 to 9 events, on each route (forced)."""
    monkeypatch.setattr(voxelizer, "k1_route", lambda H, W, two_pass: K1_ROUTES[route])
    t, x, y, p = _stream(2, 5_000, 64, 86, cuda_device)
    begin = torch.arange(0, 200, device=cuda_device, dtype=torch.int64)
    end = begin + torch.arange(200, device=cuda_device) % 10
    got = voxelizer.hist_frame_windows(x, y, p, begin, end, 64, 86, *thresholds)
    torch.cuda.synchronize()
    assert torch.equal(got, voxelizer.hist_frame_windows_plain(x, y, p, begin, end, 64, 86,
                                                               *thresholds))


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(K1_ROUTES))
def test_k1_windows_past_grid_y(cuda_device, monkeypatch, route):
    """More than 65,535 windows in one launch (windows on grid.x), on each
    route (forced)."""
    monkeypatch.setattr(voxelizer, "k1_route", lambda H, W, two_pass: K1_ROUTES[route])
    T = 70_000
    t, x, y, p = _stream(3, 16 * T, 64, 86, cuda_device, t_max=float(T))
    starts = torch.arange(T, device=cuda_device, dtype=torch.float32)
    n0 = voxelizer.hist_frame_windows.launches
    got = voxelizer.event_frames_from_windows(t, x, y, p, starts, starts + 1, 64, 86,
                                              device=cuda_device)
    torch.cuda.synchronize()
    assert voxelizer.hist_frame_windows.launches == n0 + 1
    order, begin, end = voxelizer.window_offsets(t, starts, starts + 1)
    ref = voxelizer.hist_frame_windows_plain(x[order], y[order], p[order], begin, end, 64, 86)
    assert got.shape == (T, 64, 86) and torch.equal(got, ref)


@pytest.mark.gpu
def test_k1_windows_refused_route_raises(cuda_device):
    """No route falls back: 16 CTAs forced on a frame they do not hold, and
    the band route on a frame it has no band for, raise."""
    t, x, y, p = _stream(5, 1000, 720, 1280, cuda_device)
    begin, end = (torch.tensor([v], device=cuda_device) for v in (0, 1000))
    with pytest.raises(RuntimeError, match="evfly_hist_frame_cluster_windows"):
        voxelizer._frame_windows_launch(x, y, p, begin, end, 720, 1280, 0.2, 0.3,
                                        K1_ROUTES["cluster16"])
    with pytest.raises(ValueError, match="no band"):
        voxelizer._frame_windows_launch(x, y, p, begin, end, 2 ** 15, 2 ** 15, 0.2, 0.2,
                                        K1_ROUTES["band"])


@pytest.mark.gpu
def test_k1_windows_rejects_bad_offsets(cuda_device):
    t, x, y, p = _stream(4, 100, 8, 8, cuda_device)
    begin = torch.tensor([0, 90], device=cuda_device)
    with pytest.raises(ValueError, match="offsets"):
        voxelizer.hist_frame_windows(x, y, p, begin, begin + 20, 8, 8)
