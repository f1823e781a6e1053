"""The port's dataloader (``evfly_tpu_torch.data.dataloading``, a numpy copy)
against the JAX package's, on the CPU.

On a toy h5 dataset (the schema of tests/test_learner.py) and a folder
dataset (tests/test_folder_dataset.py's layout), with shuffles, splits, the
97th-percentile event rescale, depth rescale and the event cutoff, both
packages return the same splits: exactly, except after a bilinear resize,
which runs through each package's ``interpolate_bilinear``: the same taps
and formula, within 2e-5 (XLA fuses the products and sums into FMAs,
PyTorch rounds each: 1.8e-6 on depths up to 2, and the event frames are
then divided by their 97th percentile, about 0.3 here).  The preprocessed-tensor cache keeps
the JAX package's key and version, so each package hits the other's cache,
and a cache hit needs no ``h5py``.
"""

import builtins
import os

import numpy as np
import pytest

from evfly_tpu.data import dataloading as jdl
from evfly_tpu_torch.data import dataloading as dl

H, W = 24, 32


def _trajs(rng, n_traj=5, T=9, hw=(H, W)):
    trajs = []
    for i in range(n_traj):
        t_len = T + i
        meta = np.zeros((t_len, 21), np.float32)
        meta[:, 0] = np.arange(t_len)
        meta[:, 1] = np.arange(t_len) * 0.03
        meta[:, 2] = 4.0
        meta[:, 13] = 4.0
        meta[:, 14] = rng.standard_normal(t_len) * 0.3
        if i == 1:
            meta[-1, -1] = 1.0  # a collision
        evs = rng.standard_normal((t_len - 1, *hw)) * 0.4
        evs[0] = 0.0  # an all-zero frame: its percentile is 0
        trajs.append({"name": f"traj_{i:03d}", "data": meta,
                      "ims": rng.random((t_len, *hw)).astype(np.float32),
                      "depths": (rng.random((t_len, *hw)) * 2).astype(np.float32),
                      "desvel": meta[:, 2], "evs": evs.astype(np.float32)})
    return trajs


@pytest.fixture
def h5_base(tmp_path):
    base = str(tmp_path / "toy")
    dl.write_h5_dataset(base + ".h5", _trajs(np.random.default_rng(3)))
    return base


def _assert_splits_equal(got, ref, atol=0.0, dirs=str):
    for a, b in zip(got[:2], ref[:2]):
        for name in ("meta", "ims", "depths", "trajlength", "desvel"):
            np.testing.assert_allclose(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                       atol=atol, rtol=0, err_msg=name)
        assert (a.evs is None) == (b.evs is None)
        if a.evs is not None:
            assert len(a.evs) == len(b.evs)
            for ea, eb in zip(a.evs, b.evs):
                np.testing.assert_allclose(np.asarray(ea), np.asarray(eb), atol=atol, rtol=0)
        assert list(map(dirs, a.dirs)) == list(map(dirs, b.dirs))
        assert [int(i) for i in a.dirs_ids] == [int(i) for i in b.dirs_ids]
    assert got[2] == ref[2]


H5_CASES = {
    "seeded": dict(val_split=0.4, seed=5, events="evs_frames", keep_collisions=True,
                   rescale_evs=-1.0, rescale_depth=1.0),
    "val-train, no collisions": dict(val_split=0.3, seed=7, events="evs_frames",
                                     keep_collisions=False, rescale_evs=-1.0,
                                     split_method="val-train", evs_min_cutoff=0.15),
    "fixed rescale, short, unshuffled": dict(val_split=0.5, seed=-2, events="evs_frames",
                                             keep_collisions=True, rescale_evs=2.0, short=4),
    "no events": dict(val_split=0.2, seed=1, keep_collisions=True),
}


@pytest.mark.parametrize("case", sorted(H5_CASES))
def test_h5_splits_equal_jax(h5_base, monkeypatch, case):
    monkeypatch.setenv("EVFLY_DATA_CACHE", "0")
    kw = dict(H5_CASES[case], logger=lambda m: None)
    _assert_splits_equal(dl.dataloader(h5_base, **kw), jdl.dataloader(h5_base, **kw))


def test_h5_resized_splits_match_jax(h5_base, monkeypatch):
    monkeypatch.setenv("EVFLY_DATA_CACHE", "0")
    kw = dict(val_split=0.4, seed=5, events="evs_frames", keep_collisions=True,
              rescale_evs=-1.0, resize_input=[15, 20], logger=lambda m: None)
    got, ref = dl.dataloader(h5_base, **kw), jdl.dataloader(h5_base, **kw)
    assert got[0].ims.shape[-2:] == (15, 20)
    _assert_splits_equal(got, ref, atol=2e-5)


def test_train_val_dirs_restore_equals_jax(h5_base, monkeypatch):
    monkeypatch.setenv("EVFLY_DATA_CACHE", "0")
    kw = dict(val_split=0.4, seed=5, events="evs_frames", keep_collisions=True,
              rescale_evs=-1.0, logger=lambda m: None)
    tr, va, _ = jdl.dataloader(h5_base, **kw)
    tvd = (tr.dirs[::-1], va.dirs, tr.dirs_ids[::-1], va.dirs_ids)
    kw.update(seed=9, train_val_dirs=tvd)
    got, ref = dl.dataloader(h5_base, **kw), jdl.dataloader(h5_base, **kw)
    _assert_splits_equal(got, ref)
    assert list(got[0].dirs) == list(tr.dirs[::-1])


def test_h5_written_by_the_port_reads_in_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("EVFLY_DATA_CACHE", "0")
    trajs = _trajs(np.random.default_rng(4), n_traj=3)
    dl.write_h5_dataset(str(tmp_path / "a.h5"), trajs)
    jdl.write_h5_dataset(str(tmp_path / "b.h5"), trajs)
    kw = dict(val_split=0.34, seed=2, events="evs_frames", keep_collisions=True,
              logger=lambda m: None)
    _assert_splits_equal(jdl.dataloader(str(tmp_path / "a"), **kw),
                         jdl.dataloader(str(tmp_path / "b"), **kw), dirs=os.path.basename)


def test_cache_round_trip_and_shared_with_jax(h5_base):
    """The port caches and hits its own cache; a cache the JAX package
    wrote is the one the port hits (same key, same version)."""
    logs = []
    kw = dict(val_split=0.4, seed=5, events="evs_frames", keep_collisions=True,
              rescale_evs=-1.0)
    fresh = dl.dataloader(h5_base, logger=logs.append, **kw)
    assert any("Cached preprocessed tensors" in m for m in logs)
    hit = dl.dataloader(h5_base, logger=logs.append, **kw)
    assert "Cache hit" in logs[-1]
    _assert_splits_equal(hit, fresh)

    jlogs = []
    kw["seed"] = 6
    ref = jdl.dataloader(h5_base, logger=jlogs.append, **kw)
    assert not any("Cache hit" in m for m in jlogs)
    logs.clear()
    got = dl.dataloader(h5_base, logger=logs.append, **kw)
    assert any("Cache hit" in m for m in logs)
    _assert_splits_equal(got, ref)
    assert dl._CACHE_VERSION == jdl._CACHE_VERSION


def test_cache_hit_needs_no_h5py(h5_base, monkeypatch):
    """With the source h5 gone (its .stat.json stamp kept) and h5py not
    importable, a cache hit still loads; a load that must open an h5
    raises ImportError."""
    kw = dict(val_split=0.4, seed=5, events="evs_frames", keep_collisions=True,
              rescale_evs=-1.0, logger=lambda m: None)
    ref = dl.dataloader(h5_base, **kw)
    os.remove(h5_base + ".h5")
    assert os.path.exists(h5_base + ".h5.stat.json")

    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("h5py is not installed")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    _assert_splits_equal(dl.dataloader(h5_base, **kw), ref)
    other = str(os.path.dirname(h5_base) + "/other")
    monkeypatch.setattr(builtins, "__import__", real_import)
    dl.write_h5_dataset(other + ".h5", _trajs(np.random.default_rng(5), n_traj=2))
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError):
        dl.dataloader(other, **kw)


def test_cache_dataset_equals_the_h5_load_and_hits_without_h5py(tmp_path, monkeypatch):
    """``cache_dataset`` preprocesses in-memory trajectories as the
    dataloader reads an h5 file of them (here JAX's dataloader on the file),
    and the dataloader's next call takes the cache hit with no h5 file and
    no h5py."""
    trajs = _trajs(np.random.default_rng(8))
    jdl.write_h5_dataset(str(tmp_path / "file.h5"), trajs)
    kw = dict(val_split=0.4, seed=5, events="evs_frames", keep_collisions=False,
              rescale_evs=-1.0, rescale_depth=1.0)
    ref = jdl.dataloader(str(tmp_path / "file"), logger=lambda m: None, **kw)
    logs = []
    made = dl.cache_dataset(str(tmp_path / "mem"), trajs, logger=logs.append, **kw)
    assert any("from memory" in m for m in logs) and not (tmp_path / "mem.h5").exists()
    _assert_splits_equal(made, ref, dirs=os.path.basename)

    real_import = builtins.__import__
    monkeypatch.setattr(builtins, "__import__", lambda name, *a, **k: (
        (_ for _ in ()).throw(ImportError(name)) if name == "h5py" else real_import(name, *a, **k)))
    logs.clear()
    hit = dl.dataloader(str(tmp_path / "mem"), logger=logs.append, **kw)
    assert "Cache hit" in logs[-1]
    _assert_splits_equal(hit, made)
    with pytest.raises(FileExistsError):
        dl.cache_dataset(str(tmp_path / "file"), trajs, **kw)


def _write_folder(root, rng, n_traj=4):
    """Rollout folders (tests/test_folder_dataset.py's layout): data.csv with
    21 columns and a header, {ts}_im.png and {ts}_depth.png, and one
    object array of event frames at the root; one trajectory with a
    duplicated timestamp row and an image without metadata."""
    cv2 = pytest.importorskip("cv2")
    evobj = np.empty(n_traj, object)
    for i in range(n_traj):
        T = 7 + i
        folder = root / f"{i:03d}"
        folder.mkdir(parents=True)
        ts = 100.0 + np.arange(T) * 0.05
        meta = np.zeros((T, 21))
        meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 13] = np.arange(T), ts, 4.0, 4.0
        meta[:, 14] = rng.standard_normal(T) * 0.3
        rows = list(meta)
        if i == 2:
            rows.insert(3, meta[3].copy())  # a duplicated timestamp
        lines = ["idx," + ",".join(f"c{j}" for j in range(20))]
        lines += [",".join(f"{v:.6f}" for v in r) for r in rows]
        (folder / "data.csv").write_text("\n".join(lines) + "\n")
        extra = [ts[-1] + 0.05] if i == 3 else []  # an image with no metadata
        for t in list(ts) + extra:
            cv2.imwrite(str(folder / f"{t:.6f}_im.png"), rng.integers(0, 256, (H, W)).astype(np.uint8))
            cv2.imwrite(str(folder / f"{t:.6f}_depth.png"),
                        rng.integers(0, 256, (H, W)).astype(np.uint8))
        evobj[i] = (rng.standard_normal((T - 1, H, W)) * 0.4).astype(np.float32)
    np.save(str(root / "evs_frames.npy"), evobj)


def test_folder_splits_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("EVFLY_DATA_CACHE", "0")
    root = tmp_path / "forest_run"
    _write_folder(root, np.random.default_rng(6))
    logs = []
    kw = dict(use_h5=False, val_split=0.5, seed=3, events="evs_frames", keep_collisions=True,
              rescale_evs=-1.0)
    got = dl.dataloader(str(root), logger=logs.append, **kw)
    ref = jdl.dataloader(str(root), logger=lambda m: None, **kw)
    _assert_splits_equal(got, ref)
    assert any("Unmatched timestamps" in m for m in logs)
    assert got[2] is True
