"""The port's real-data path against the JAX package: EVT3 decoding,
calibration and ``package_real_sequence``.

- ``data.evt3`` (the port's copy of ``native/evt3.cpp``, built by
  ``native._build``): events encoded by tests/test_evt3.py's independent
  EVT3 encoder decode back exactly (single and vector words, 24-bit time
  rollover, a file with a header's geometry, ``max_events``).
- ``utils.calibration``, a numpy copy: every map, remap and point exactly
  equal to the JAX package's on the same inputs.
- ``data.realdata``: ``sync_depth_events`` and ``fix_corrupted_depth``
  exactly; ``package_real_sequence`` on the CPU exactly equal to the JAX
  package's, key by key (``evs`` through ``event_frames_from_windows``, bit
  for bit: the f64 rebase, then the f32 cast of times and window edges
  before the windows are cut), on a DAVIS-like stream, on an EVT3 round
  trip, and on a Prophesee-like 640x480 recording with ns epoch stamps and
  {0, 1} polarity, with one and with two thresholds.
"""

import numpy as np
import pytest

from evfly_tpu.data import realdata as jrealdata
from evfly_tpu.utils import calibration as jcal
from evfly_tpu_torch.data import evt3, realdata
from evfly_tpu_torch.native import _build
from evfly_tpu_torch.utils import calibration
from test_evt3 import _word, encode_events
from test_realdata_e2e import _synth_prophesee_recording
from torch_helpers import cuda_device  # noqa: F401  (fixture)


def _assert_traj_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if k == "name":
            assert got[k] == ref[k]
            continue
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, k
        np.testing.assert_array_equal(g, r, err_msg=k)


# --------------------------------------------------------------------- EVT3

def test_evt3_builds_from_the_ports_copy():
    path = _build.library_path("evt3")
    assert path.parent == _build.BUILD_DIR and "evfly_tpu/native" not in str(path)
    assert (_build.SRC_DIR / "evt3.cpp").read_bytes() == \
        (_build.SRC_DIR.parent.parent / "evfly_tpu" / "native" / "evt3.cpp").read_bytes()


@pytest.mark.parametrize("vect", [False, True], ids=["addr_x", "vect_12"])
def test_decode_evt3_bytes_roundtrip(vect):
    rng = np.random.default_rng(0 + vect)
    n = 2000
    t = np.sort(rng.integers(0, 1 << 22, n))
    x = rng.integers(0, 640, n)
    y = rng.integers(0, 480, n)
    p = rng.choice([-1, 1], n)
    ev = evt3.decode_evt3_bytes(encode_events(t, x, y, p, vect=vect))
    for key, want, dtype in (("t", t, np.int64), ("x", x, np.uint16), ("y", y, np.uint16),
                             ("p", p, np.int8)):
        assert ev[key].dtype == dtype
        np.testing.assert_array_equal(ev[key], want)
    assert (ev["width"], ev["height"]) == (0, 0)


def test_decode_evt3_vector_mask_and_rollover():
    buf = bytearray()
    buf += _word(0x8, 0) + _word(0x6, 100) + _word(0x0, 7)
    buf += (0x3 << 12 | 0x0800 | 40).to_bytes(2, "little")  # base x 40, polarity +
    buf += _word(0x4, 0b101000000011)                          # offsets 0, 1, 9, 11
    ev = evt3.decode_evt3_bytes(bytes(buf))
    np.testing.assert_array_equal(ev["x"], [40, 41, 49, 51])
    t = np.array([(1 << 24) - 5, (1 << 24) - 1, (1 << 24) + 3, (1 << 24) + 10])
    ev = evt3.decode_evt3_bytes(encode_events(t & 0xFFFFFF, [1, 2, 3, 4], [5, 6, 7, 8],
                                              [1, -1, 1, -1]))
    np.testing.assert_array_equal(ev["t"], t)


def test_read_evt3_file_with_header(tmp_path):
    header = b"% evt 3.0\n% format EVT3;height=480;width=640\n% geometry 640x480\n% end\n"
    path = tmp_path / "rec.raw"
    path.write_bytes(header + encode_events([10, 20, 30], [0, 639, 320], [0, 479, 240],
                                            [1, 1, -1]))
    ev = evt3.read_evt3(str(path))
    assert (ev["width"], ev["height"]) == (640, 480)
    np.testing.assert_array_equal(ev["t"], [10, 20, 30])
    assert len(evt3.read_evt3(str(path), max_events=2)["t"]) == 2
    with pytest.raises(IOError):
        evt3.read_evt3(str(tmp_path / "missing.raw"))


# -------------------------------------------------------------- calibration

CALIB = {
    "cam0": {"intrinsics": [390.0, 391.0, 320.0, 240.0],
             "distortion_coeffs": [-0.1, 0.02, 0.0, 0.0], "distortion_model": "radtan",
             "resolution": [640, 480]},
    "cam1": {"intrinsics": [330.0, 331.0, 170.0, 128.0],
             "distortion_coeffs": [-0.3, 0.1, 0.001, -0.001], "distortion_model": "radtan",
             "resolution": [346, 260],
             "T_cn_cnm1": [[1, 0, 0, 0.05], [0, 1, 0, 0.0], [0, 0, 1, 0], [0, 0, 0, 1]]},
}


@pytest.mark.parametrize("fix_rotation", [True, False])
def test_calibration_equals_jax(fix_rotation):
    got = calibration.CameraSystem(CALIB, fix_rotation=fix_rotation).get_remapping()
    ref = jcal.CameraSystem(CALIB, fix_rotation=fix_rotation).get_remapping()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rng = np.random.default_rng(3)
    img = rng.random((260, 346)).astype(np.float32)
    np.testing.assert_array_equal(calibration.remap_image(img, got["ev_mapx"], got["ev_mapy"]),
                                  jcal.remap_image(img, ref["ev_mapx"], ref["ev_mapy"]))
    events = {"x": rng.integers(0, 346, 500), "y": rng.integers(0, 260, 500),
              "t": np.arange(500), "p": rng.choice([-1, 1], 500)}
    for rotate in (False, True):
        a = calibration.remap_events(events, got["inv_mapx"], got["inv_mapy"], (346, 260),
                                     rotate)
        b = jcal.remap_events(events, ref["inv_mapx"], ref["inv_mapy"], (346, 260), rotate)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    K = np.array([[320.0, 0.0, 170.0], [0.0, 321.0, 130.0], [0.0, 0.0, 1.0]])
    pts = rng.uniform([20, 20], [320, 240], size=(50, 2))
    dist = np.array([-0.25, 0.08, 0.0005, -0.0003])
    np.testing.assert_array_equal(calibration.undistort_points(pts, K, dist, np.eye(3), K),
                                  jcal.undistort_points(pts, K, dist, np.eye(3), K))


def test_aligner_equals_jax(tmp_path):
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "calib.yaml"
    path.write_text(yaml.safe_dump(CALIB))
    got, ref = calibration.Aligner(str(path)), jcal.Aligner(str(path))
    rng = np.random.default_rng(4)
    depth = rng.random((480, 640)).astype(np.float32)
    davis = rng.random((260, 346)).astype(np.float32)
    a, b = got.align(depth=depth, davis=davis), ref.align(depth=depth, davis=davis)
    np.testing.assert_array_equal(a["depth"], b["depth"])
    np.testing.assert_array_equal(a["davis"], b["davis"])


# ----------------------------------------------------------------- realdata

def test_sync_and_hole_filling_equal_jax():
    depth_ts = np.array([0.0, 0.03, 0.03, 0.07, 0.1, 0.5, 0.6])
    event_t = np.linspace(0.01, 0.45, 50)
    assert realdata.sync_depth_events(depth_ts, event_t) == \
        jrealdata.sync_depth_events(depth_ts, event_t)
    rng = np.random.default_rng(5)
    depth = rng.random((40, 50)).astype(np.float32)
    depth[rng.random((40, 50)) < 0.3] = 0.0
    depth[:12, :12] = 0.0  # holes whose whole window is zero: NaN
    np.testing.assert_array_equal(realdata.fix_corrupted_depth(depth.copy()),
                                  jrealdata.fix_corrupted_depth(depth.copy()))


def _davis_stream(seed, n=6000, H=26, W=34, fps=30.0, frames=7):
    rng = np.random.default_rng(seed)
    depth_ts = 1_000.0 + np.arange(frames) / fps           # seconds since boot
    t = np.sort(rng.uniform(depth_ts[0] - 0.01, depth_ts[-1] + 0.02, n))
    t[1:31] = depth_ts[2]                                   # stamped on window edges
    # out of order between the first and the last event, which
    # sync_depth_events reads as the stream's extent
    t[1:-1] = rng.permutation(t[1:-1])
    x = rng.integers(0, W, n).astype(np.int32)
    y = rng.integers(0, H, n).astype(np.int32)
    p = rng.choice([-1, 1], n).astype(np.int32)
    depths = rng.random((frames, H, W)).astype(np.float32)
    depths[:, 3:6, 4:9] = 0.0
    return t, x, y, p, depths, depth_ts


@pytest.mark.parametrize("thresholds", [(0.2, 0.2), (0.2, 0.3)])
def test_package_real_sequence_equals_jax(thresholds):
    """An unsorted DAVIS-like stream, events on window edges, depth holes."""
    t, x, y, p, depths, depth_ts = _davis_stream(6)
    got = realdata.package_real_sequence("real_000", t, x, y, p, depths, depth_ts,
                                         pos_thresh=thresholds[0], neg_thresh=thresholds[1],
                                         device="cpu")
    ref = jrealdata.package_real_sequence("real_000", t, x, y, p, depths, depth_ts,
                                          pos_thresh=thresholds[0], neg_thresh=thresholds[1])
    _assert_traj_equal(got, ref)
    assert got["evs"].shape == (6, 26, 34) and np.abs(got["evs"]).sum() > 0


def test_package_real_sequence_from_evt3():
    rng = np.random.default_rng(7)
    n = 4000
    t_us = np.sort(rng.integers(0, 500_000, n))
    ev = evt3.decode_evt3_bytes(encode_events(t_us, rng.integers(0, 346, n),
                                              rng.integers(0, 260, n), rng.choice([-1, 1], n)))
    depth_ts = np.arange(0.0, 0.5, 1 / 15)
    depth = rng.random((len(depth_ts), 260, 346)).astype(np.float32)
    args = ("real_evt3", ev["t"] * 1e-6, ev["x"].astype(np.int32), ev["y"].astype(np.int32),
            ev["p"].astype(np.int32), depth, depth_ts)
    got = realdata.package_real_sequence(*args, sensor_hw=(260, 346), device="cpu")
    ref = jrealdata.package_real_sequence(*args, sensor_hw=(260, 346))
    _assert_traj_equal(got, ref)


@pytest.mark.parametrize("thresholds", [(0.2, 0.2), (0.2, 0.3)])
def test_package_prophesee_recording_equals_jax(thresholds):
    """640x480, ns UNIX-epoch stamps, {0, 1} polarity
    (tests/test_realdata_e2e.py's generator)."""
    rng = np.random.default_rng(8)
    (et, ex, ey, ep), depths, dts = _synth_prophesee_recording(rng, n_frames=5)
    got = realdata.package_real_sequence("real_000", et, ex, ey, ep, depths, dts,
                                         pos_thresh=thresholds[0], neg_thresh=thresholds[1],
                                         device="cpu")
    ref = jrealdata.package_real_sequence("real_000", et, ex, ey, ep, depths, dts,
                                          pos_thresh=thresholds[0], neg_thresh=thresholds[1])
    _assert_traj_equal(got, ref)
    assert got["evs"].shape == (4, 480, 640)
    assert got["evs"].max() > 0 and got["evs"].min() < 0


def test_package_real_sequence_with_aligner(tmp_path):
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "calib.yaml"
    path.write_text(yaml.safe_dump(CALIB))
    t, x, y, p, _, depth_ts = _davis_stream(9, n=3000, H=260, W=346, frames=4)
    depths = np.random.default_rng(9).random((4, 480, 640)).astype(np.float32)
    got = realdata.package_real_sequence("al", t, x, y, p, depths, depth_ts,
                                         aligner=calibration.Aligner(str(path)),
                                         sensor_hw=(260, 346), device="cpu")
    ref = jrealdata.package_real_sequence("al", t, x, y, p, depths, depth_ts,
                                          aligner=jcal.Aligner(str(path)), sensor_hw=(260, 346))
    _assert_traj_equal(got, ref)


def test_package_real_sequence_raises_without_windows():
    with pytest.raises(ValueError, match="no synced"):
        realdata.package_real_sequence("x", np.array([10.0, 10.1]), np.zeros(2), np.zeros(2),
                                       np.ones(2), np.zeros((2, 4, 4), np.float32),
                                       np.array([0.0, 1.0]), device="cpu")


@pytest.mark.gpu
def test_package_real_sequence_on_the_card_equals_the_cpu(cuda_device):
    """The 640x480 recording through K1's window launch (one launch for all
    windows), key by key equal to the CPU's, with one and two thresholds
    (the band kernel)."""
    from evfly_tpu_torch.ops import voxelizer

    rng = np.random.default_rng(10)
    (et, ex, ey, ep), depths, dts = _synth_prophesee_recording(rng, n_frames=8)
    for thresholds in ((0.2, 0.2), (0.2, 0.3)):
        n0 = voxelizer.hist_frame_windows.launches
        got = realdata.package_real_sequence("r", et, ex, ey, ep, depths, dts,
                                             pos_thresh=thresholds[0],
                                             neg_thresh=thresholds[1], device=cuda_device)
        assert voxelizer.hist_frame_windows.launches == n0 + 1
        ref = realdata.package_real_sequence("r", et, ex, ey, ep, depths, dts,
                                             pos_thresh=thresholds[0],
                                             neg_thresh=thresholds[1], device="cpu")
        _assert_traj_equal(got, ref)
