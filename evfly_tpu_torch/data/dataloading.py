"""Trajectory dataset loading with reference-dataloader parity.

A copy of ``evfly_tpu/data/dataloading.py`` (numpy; the port imports
nothing of the JAX package) with two changes that give no different
result: the bilinear resize runs the port's ``imageops.interpolate_bilinear``
on CPU tensors, and ``h5py`` is imported only where an h5 file is opened or
written, so a cache hit needs numpy alone.

Reproduces the reference ``dataloader()`` (learner/dataloading.py:30-560) for
both input formats — the h5 schema (the primary training format, SURVEY.md
§2.2) and the raw trajectory-folder format (folder of ``*_im.png`` /
``*_depth.png`` + ``data.csv`` + ``evs_frames*.npy``, the format rollouts
are recorded in):

* h5 schema: one group per trajectory with datasets ``data`` (metadata),
  ``ims``, ``depths``, ``trajlength``, ``desvel``, ``evs``, ``dirs``,
  ``dirs_ids`` (utils/to_h5.py:16-47).
* seeded shuffle with *python* ``random.shuffle`` — seed >= 0 fixed seed,
  -1 time seed, -2 no shuffling (dataloading.py:131-136).
* NaN-metadata and collision-trajectory filtering (dataloading.py:233-245).
* bilinear (align_corners=False) resize to ``resize_input``
  (dataloading.py:398-416).
* depth rescale/clamp; event-frame rescaling by fixed factor or per-frame
  97th-percentile of |evs| with ±1 clamp (dataloading.py:501-533); the
  percentile uses linear interpolation (torch.quantile default == numpy).
* train/val split in 'train-val' or 'val-train' order over the pre-shuffled
  trajectory list (dataloading.py:440-461).
* ``train_val_dirs`` restore for split persistence (dataloading.py:82-104).

Folder-format specifics (dataloading.py:108-136, 247-345):

* trajectory folders = sorted ``<data_dir>/*/``; event frames from one
  object-array ``<events>.npy`` at the dataset root, reindexed by the
  shuffled folder ids (dataloading.py:164-166).
* ``data.csv``: header row dropped; a malformed file falls back to
  line-by-line parsing keeping only 21-column rows (dataloading.py:207-226).
* images: ``*_depth.png`` present → paired ``*_im.png``; else ``*.png``
  (or legacy ``*.npy`` scaled by 1/0.09).  png grayscale scaled by 1/255.
* timestamp hygiene: duplicate metadata timestamps drop the FIRST
  occurrence (np.unique return_index semantics — a reference quirk we
  replicate, dataloading.py:306-310); image-filename timestamps are
  set-matched against metadata timestamps and unmatched entries deleted on
  both sides (dataloading.py:312-330); metadata timestamps re-zeroed to the
  trajectory start (dataloading.py:343).
* legacy npy datasets approximate desvel as ``max(meta[:, 12])``
  (dataloading.py:367).

Outputs are numpy float32 (host); the Learner puts them on the device.
"""

from __future__ import annotations

import dataclasses
import glob
import inspect
import json
import os
import random
import re
import time
from dataclasses import dataclass, field
from os.path import join as opj
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np


def _h5py():
    """h5py, imported where an h5 file is opened or written."""
    import h5py

    return h5py


def _resize_bilinear_np(frames: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Batched torch-style bilinear resize (align_corners=False), on the CPU."""
    import torch

    from ..ops.imageops import interpolate_bilinear

    out = interpolate_bilinear(torch.from_numpy(np.asarray(frames, np.float32)), size,
                               align_corners=False)
    return out.numpy()


class ConcatFrames:
    """Lazy row-wise concatenation of frame arrays (mmap-friendly).

    ``np.concatenate`` over the per-dataset mmap'd cache arrays materializes
    the whole multi-dataset mix as anonymous host RAM (tens of GB of f32
    frames for a large training mix).  This wrapper keeps the parts (typically ``np.load(...,
    mmap_mode='r')`` views) and serves reads on demand: integer / slice /
    fancy-index ``__getitem__`` returns exactly what the concatenated array
    would, while untouched rows never leave the page cache.

    Only the ndarray surface the Learner actually uses is implemented
    (shape/dtype/size/nbytes/ndim/len, row-first indexing, block iteration
    for device staging).  ``np.asarray(cf)`` still materializes — callers
    that need the whole thing must opt in explicitly.
    """

    def __init__(self, parts: Sequence[np.ndarray]):
        assert parts, "ConcatFrames needs at least one part"
        tail = parts[0].shape[1:]
        for p in parts:
            assert p.shape[1:] == tail and p.dtype == parts[0].dtype
        self.parts = list(parts)
        lens = np.array([p.shape[0] for p in parts], np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(lens)])

    @property
    def shape(self):
        return (int(self._offsets[-1]),) + tuple(self.parts[0].shape[1:])

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def ndim(self):
        return self.parts[0].ndim

    @property
    def size(self):
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self):
        return self.size * self.dtype.itemsize

    def __len__(self):
        return self.shape[0]

    def _gather(self, idx: np.ndarray, rest: tuple = ()) -> np.ndarray:
        idx = np.asarray(idx)
        n = self.shape[0]
        if idx.dtype == bool:
            # ndarray semantics: a boolean mask selects rows; treating it as
            # integer indices would silently return rows 0/1
            if idx.shape != (n,):
                raise IndexError(
                    f"boolean row mask has shape {idx.shape}, expected ({n},)"
                )
            idx = np.nonzero(idx)[0]
        idx = np.where(idx < 0, idx + n, idx)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"index out of range for length {n}")
        # Trailing int/slice indices are applied PER PART, so a read like
        # cf[:, 0] materializes only the (rows, rest-indexed) result — never
        # the full concatenated rows (the host-RAM OOM this class
        # prevents).  Array-valued `rest` falls back to gather-then-index
        # (numpy advanced-indexing broadcast semantics are not worth
        # replicating here).
        per_part = rest and all(
            isinstance(r, (int, np.integer, slice)) for r in rest
        )
        deferred = () if per_part else rest
        tail = (
            self.parts[0][:1][(slice(None),) + rest].shape[1:]
            if per_part
            else self.shape[1:]
        )
        out = np.empty(idx.shape + tail, self.dtype)
        for pi in np.unique(part_ids := np.searchsorted(self._offsets, idx, side="right") - 1):
            m = part_ids == pi
            rows = self.parts[pi][idx[m] - self._offsets[pi]]
            out[m] = rows[(slice(None),) + rest] if per_part else rows
        return out[(slice(None),) + deferred] if deferred else out

    def __getitem__(self, key):
        rest = ()
        if isinstance(key, tuple):
            key, rest = key[0], key[1:]
        if isinstance(key, (int, np.integer)):
            n = self.shape[0]
            i = int(key) + (n if key < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {key} out of range for length {n}")
            pi = int(np.searchsorted(self._offsets, i, side="right") - 1)
            row = self.parts[pi][i - self._offsets[pi]]
            return row[rest] if rest else row
        if isinstance(key, slice):
            key = np.arange(*key.indices(self.shape[0]))
        return self._gather(key, rest)

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate(self.parts)
        return out.astype(dtype) if dtype is not None else out

    def iter_blocks(self, block_rows: int = 512):
        """Yield (global_start, contiguous ndarray) covering all rows in order."""
        off = 0
        for p in self.parts:
            for i in range(0, p.shape[0], block_rows):
                b = p[i : i + block_rows]
                yield off + i, np.asarray(b)
            off += p.shape[0]


def concat_frames(parts: Sequence[np.ndarray], lazy_bytes: int = 2 << 30):
    """Concatenate frame arrays; lazily (ConcatFrames) above ``lazy_bytes``.

    Small inputs keep exact ndarray semantics (np.concatenate); large ones —
    the multi-dataset training mixes — stay as mmap-backed parts.  Override
    the threshold with EVFLY_LAZY_CONCAT_BYTES (0 forces lazy always).
    """
    env = os.environ.get("EVFLY_LAZY_CONCAT_BYTES")
    if env is not None:
        lazy_bytes = int(env)
    total = sum(p.shape[0] for p in parts) * int(
        np.prod(parts[0].shape[1:], dtype=np.int64)
    ) * parts[0].dtype.itemsize
    if len(parts) == 1:
        # np.concatenate of ONE part still copies (materializing an mmap);
        # pass the original through instead
        return parts[0]
    if total > lazy_bytes:
        return ConcatFrames(parts)
    return np.concatenate(parts)


@dataclass
class TrajectorySplit:
    """One split (train or val) in the reference's return layout."""

    meta: np.ndarray              # (ΣT, 21) float32
    ims: np.ndarray               # (ΣT, H, W) float32
    depths: Optional[np.ndarray]  # (ΣT, H, W) float32
    trajlength: np.ndarray        # (num_trajs,) int
    desvel: np.ndarray            # (ΣT,) float32
    evs: Optional[List[np.ndarray]]  # per-traj (T_i - 1, H, W) float32
    dirs: List[str]
    dirs_ids: List[int]

    @property
    def velcmd(self) -> np.ndarray:
        """Velocity commands = meta columns 13:16 (learner.py:564)."""
        return self.meta[:, 13:16]

    @property
    def traj_starts(self) -> np.ndarray:
        return np.cumsum(self.trajlength) - self.trajlength

    def __len__(self):
        return len(self.trajlength)


def write_h5_dataset(
    h5_path: str,
    trajectories: Sequence[dict],
) -> None:
    """Write trajectories to the reference h5 schema (utils/to_h5.py:16-47).

    Each trajectory dict: {'name', 'data' (T,21), 'ims' (T,H,W),
    'depths' (T,H,W), 'desvel' (T,), 'evs' (T-1,H,W) optional}.
    """
    if os.path.exists(h5_path):
        os.remove(h5_path)
    with _h5py().File(h5_path, "w") as f:
        for traj in trajectories:
            g = f.create_group(traj["name"])
            g.create_dataset("data", data=np.asarray(traj["data"], np.float32))
            g.create_dataset("ims", data=np.asarray(traj["ims"], np.float32))
            g.create_dataset("depths", data=np.asarray(traj["depths"], np.float32))
            g.create_dataset("trajlength", data=len(traj["ims"]))
            g.create_dataset("desvel", data=np.asarray(traj["desvel"], np.float32))
            if "evs" in traj and traj["evs"] is not None:
                g.create_dataset("evs", data=np.asarray(traj["evs"], np.float32))
            if "flows" in traj and traj["flows"] is not None:
                # optional per-frame optical flow (T, H, W, 2) px/s — consumed
                # by the flow-upsampled event generator (ops/upsample.py);
                # f16: flow magnitudes are O(100) px/s, storage halves
                g.create_dataset("flows", data=np.asarray(traj["flows"], np.float16))
            g.create_dataset("dirs", data=traj["name"])
            g.create_dataset("dirs_ids", data=traj.get("dirs_ids", 0))


def _read_gray_png(path: str) -> np.ndarray:
    """Grayscale png → float array (cv2.IMREAD_GRAYSCALE equivalent)."""
    try:
        import cv2

        return np.asarray(cv2.imread(path, cv2.IMREAD_GRAYSCALE), np.float32)
    except ImportError:  # pragma: no cover
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), np.float32)


def _im_timestamp(filename: str, is_png: bool) -> float:
    """Timestamp from an image filename.

    png: first numeric component (reference regex, dataloading.py:290-304);
    legacy npy: fixed-position slice of the basename (dataloading.py:287).
    """
    base = os.path.basename(filename)
    if not is_png:
        return float(base[6:-4])
    m = re.search(r"(\d+(\.\d+)?)", base)
    if m is None:
        raise ValueError(f"no numeric timestamp in image filename {base}")
    return float(m.group(1))


def _read_data_csv(path: str, is_png: bool) -> np.ndarray:
    """data.csv → (T, 21) float64, header dropped.

    Falls back to per-line parsing that silently drops rows with the wrong
    column count — interrupted rollouts can truncate a row mid-write
    (reference dataloading.py:207-226).  png datasets keep the reference's
    exact rule (21 columns); for legacy non-png folders — where the
    reference raises NotImplementedError (dataloading.py:221-222) — the
    expected column count is taken from the header row instead, so every
    folder dataset recovers from truncated rows.
    """
    try:
        meta = np.genfromtxt(path, delimiter=",", dtype=np.float64)[1:]
        if np.isnan(meta).any():
            raise ValueError("ragged rows produce NaN cells")
        return meta
    except Exception:
        with open(path) as fh:
            lines = fh.readlines()
        want = 21 if is_png else len(lines[0].strip().split(","))
        rows = []
        for line in lines[1:]:
            cells = line.strip().split(",")
            if len(cells) == want:
                try:
                    rows.append([float(x) for x in cells])
                except ValueError:
                    continue  # right arity but a truncated/garbled cell
        return np.array(rows, dtype=np.float64)


def _match_im_meta_timestamps(
    traj_ims, traj_depths, traj_meta, im_ts, logger, name
):
    """Delete duplicate-timestamp metadata rows and unmatched im/meta pairs.

    Duplicates: collisions force logging, producing repeated timestamps; the
    FIRST occurrence of each duplicated value is dropped (np.unique
    return_index semantics — reference quirk, dataloading.py:306-310).
    Matching is set-membership both ways (dataloading.py:21-28,312-330).
    """
    _, first_idx, counts = np.unique(traj_meta[:, 1], return_index=True, return_counts=True)
    traj_meta = np.delete(traj_meta, first_idx[counts > 1], axis=0)

    meta_ts = set(traj_meta[:, 1].tolist())
    ims_ts_set = set(im_ts)
    bad_ims = [i for i, t in enumerate(im_ts) if t not in meta_ts]
    bad_meta = [i for i, t in enumerate(traj_meta[:, 1].tolist()) if t not in ims_ts_set]
    if bad_ims or bad_meta:
        logger(f"[DATALOADER] Unmatched timestamps in {name}: (deleting these!)")
        logger(f"[DATALOADER]\tIdxs of images: {bad_ims}")
        logger(f"[DATALOADER]\tIdxs of metadata: {bad_meta}")
        traj_ims = np.delete(traj_ims, bad_ims, axis=0)
        if traj_depths is not None:
            traj_depths = np.delete(traj_depths, bad_ims, axis=0)
        traj_meta = np.delete(traj_meta, bad_meta, axis=0)
    return traj_ims, traj_depths, traj_meta


def _load_folder_traj(folder: str, meta: np.ndarray, is_png: bool, logger):
    """One trajectory folder → (meta, ims, depths|None) or None if empty.

    Loads the image/depth pngs (or legacy npy frames), runs the
    duplicate/unmatched timestamp hygiene against ``meta``, and re-zeroes
    metadata timestamps (reference dataloading.py:247-345).
    """
    depth_files = sorted(glob.glob(opj(folder, "*_depth.png")))
    if depth_files:
        im_files = sorted(glob.glob(opj(folder, "*_im.png")))
    else:
        im_files = sorted(glob.glob(opj(folder, "*.png" if is_png else "*.npy")))
    if not im_files:
        logger(f"[DATALOADER] No images in {os.path.basename(folder)}, skipping.")
        return None

    depths = None
    if is_png:
        ims = np.stack([_read_gray_png(p) for p in im_files]) / 255.0
        if depth_files:
            depths = np.stack([_read_gray_png(p) for p in depth_files]) / 255.0
    else:
        ims = np.stack([np.load(p, allow_pickle=True) for p in im_files]).astype(np.float32) / 0.09

    im_ts = [_im_timestamp(p, is_png) for p in im_files]
    ims, depths, meta = _match_im_meta_timestamps(
        ims, depths, meta, im_ts, logger, os.path.basename(folder)
    )
    meta[:, 1] -= meta[0, 1]  # 0-start timestamps (dataloading.py:343)
    return meta, ims.astype(np.float32), depths


_CACHE_VERSION = 1


def _cache_dir_for(data_dir: str, key_parts) -> Optional[str]:
    """Preprocessed-tensor cache location for a dataloader() call, or None.

    The reference re-pays the full python load (h5 read, timestamp hygiene,
    resize, percentile rescale — reference dataloading.py:398-533) in EVERY
    process that opens the dataset; at 40k+ frames on one core that is
    20-30 min per training phase.  We key a directory of .npy files on the
    dataset file identity (path, mtime, size) plus every argument that
    changes the returned tensors, and mmap it back on hit (<2 min instead).
    Opt out with EVFLY_DATA_CACHE=0.
    """
    if os.environ.get("EVFLY_DATA_CACHE", "1") == "0":
        return None
    import hashlib
    import json as _json

    h = hashlib.blake2b(
        _json.dumps(key_parts, sort_keys=True, default=str).encode(), digest_size=16
    ).hexdigest()
    return os.path.abspath(data_dir.rstrip("/")) + f"_cache/{h}"


def _cache_save(cdir: str, train: "TrajectorySplit", val: "TrajectorySplit",
                is_png: bool, key_parts=None):
    import json as _json

    tmp = cdir + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    if key_parts is not None:
        # record the source-h5 identity (and full arg key) this entry was
        # built from, so a tool that deletes cached h5 files can refuse one
        # whose caches are stale (a regenerated h5 with an old cache would
        # lose the dataset)
        with open(opj(tmp, "cache_key.json"), "w") as fh:
            _json.dump(key_parts, fh, sort_keys=True, default=str)
    meta = {"version": _CACHE_VERSION, "is_png": bool(is_png)}
    for tag, split in (("train", train), ("val", val)):
        np.save(opj(tmp, f"{tag}_meta.npy"), split.meta)
        np.save(opj(tmp, f"{tag}_ims.npy"), split.ims)
        np.save(opj(tmp, f"{tag}_depths.npy"), split.depths)
        np.save(opj(tmp, f"{tag}_trajlength.npy"), split.trajlength)
        np.save(opj(tmp, f"{tag}_desvel.npy"), split.desvel)
        meta[f"{tag}_has_evs"] = split.evs is not None
        if split.evs is not None:
            np.save(opj(tmp, f"{tag}_evs.npy"),
                    np.concatenate(split.evs) if split.evs else np.zeros((0, 1, 1), np.float32))
            np.save(opj(tmp, f"{tag}_ev_lens.npy"),
                    np.array([ev.shape[0] for ev in split.evs], np.int64))
        meta[f"{tag}_dirs"] = list(map(str, split.dirs))
        meta[f"{tag}_dirs_ids"] = [int(i) for i in split.dirs_ids]
    with open(opj(tmp, "meta.json"), "w") as fh:
        _json.dump(meta, fh)
    if os.path.isdir(cdir):  # concurrent writer beat us; keep theirs
        import shutil

        shutil.rmtree(tmp)
    else:
        os.rename(tmp, cdir)


def _cache_load(cdir: str, load_evs: bool):
    import json as _json

    with open(opj(cdir, "meta.json")) as fh:
        meta = _json.load(fh)
    if meta.get("version") != _CACHE_VERSION:
        return None

    def split(tag):
        evs = None
        if meta[f"{tag}_has_evs"]:
            ev_lens = np.load(opj(cdir, f"{tag}_ev_lens.npy"))
            evs_cat = np.load(opj(cdir, f"{tag}_evs.npy"), mmap_mode="r")
            evs = np.split(evs_cat, np.cumsum(ev_lens)[:-1]) if len(ev_lens) else []
        elif load_evs:
            raise KeyError("cache entry lacks event frames")
        return TrajectorySplit(
            meta=np.load(opj(cdir, f"{tag}_meta.npy"), mmap_mode="r"),
            ims=np.load(opj(cdir, f"{tag}_ims.npy"), mmap_mode="r"),
            depths=np.load(opj(cdir, f"{tag}_depths.npy"), mmap_mode="r"),
            trajlength=np.load(opj(cdir, f"{tag}_trajlength.npy")),
            desvel=np.load(opj(cdir, f"{tag}_desvel.npy"), mmap_mode="r"),
            evs=evs,
            dirs=list(meta[f"{tag}_dirs"]),
            dirs_ids=list(meta[f"{tag}_dirs_ids"]),
        )

    return split("train"), split("val"), bool(meta["is_png"])


def dataloader(
    data_dir: str,
    val_split: float = 0.0,
    short: int = 0,
    seed: Optional[int] = None,
    train_val_dirs=None,
    do_transform: bool = False,
    events: str = "",
    keep_collisions: bool = False,
    logger: Optional[Callable[[str], None]] = None,
    use_h5: bool = True,
    resize_input: Optional[List[int]] = None,
    split_method: str = "train-val",
    rescale_depth: float = 0.0,
    rescale_evs: float = 0.0,
    evs_min_cutoff: Optional[float] = None,
) -> Tuple[TrajectorySplit, TrajectorySplit, bool]:
    """Load an h5 trajectory dataset -> (train, val, is_png_or_h5)."""
    return _dataloader(data_dir, None, val_split, short, seed, train_val_dirs, do_transform,
                       events, keep_collisions, logger, use_h5, resize_input, split_method,
                       rescale_depth, rescale_evs, evs_min_cutoff)


def _dataloader(data_dir, source: Optional[Mapping[str, Mapping[str, np.ndarray]]],
                val_split, short, seed, train_val_dirs, do_transform, events,
                keep_collisions, logger, use_h5, resize_input, split_method, rescale_depth,
                rescale_evs, evs_min_cutoff):
    """``dataloader``'s body.  ``source`` (``cache_dataset``'s, else None)
    stands in for the opened h5 file: a mapping, in the file's key order,
    of trajectory name -> {'data', 'ims', 'depths', 'evs'} arrays, read as
    the file's datasets would be."""
    if logger is None:
        logger = lambda msg: print(msg)

    # ---- preprocessed-tensor cache probe ----
    _src = data_dir + ("_tf" if (do_transform and "_tf" not in data_dir) else "") + ".h5"
    _st = None
    if use_h5:
        if os.path.exists(_src):
            s = os.stat(_src)
            _st = (s.st_mtime_ns, s.st_size)
            # stamp the source identity so the (large) h5 can be deleted
            # once its preprocessed caches exist; cache keys keep hitting
            # via the stamp
            try:
                with open(_src + ".stat.json", "w") as fh:
                    json.dump({"mtime_ns": _st[0], "size": _st[1]}, fh)
            except OSError:
                pass
        elif os.path.exists(_src + ".stat.json"):
            with open(_src + ".stat.json") as fh:
                stamp = json.load(fh)
            _st = (int(stamp["mtime_ns"]), int(stamp["size"]))
    cache_dir = None
    cache_key = None
    if _st is not None:
        tvd_key = (
            None
            if train_val_dirs is None
            else [list(map(str, part)) for part in train_val_dirs[:2]]
            + [list(map(int, part)) for part in train_val_dirs[2:]]
        )
        cache_key = dict(
            v=_CACHE_VERSION, src=_src, mtime=_st[0], size=_st[1],
            val_split=val_split, short=short, seed=seed, tvd=tvd_key,
            do_transform=do_transform, events=events,
            keep_collisions=keep_collisions, resize_input=resize_input,
            split_method=split_method, rescale_depth=rescale_depth,
            rescale_evs=rescale_evs, evs_min_cutoff=evs_min_cutoff,
        )
        cache_dir = _cache_dir_for(data_dir, cache_key)
    if cache_dir is not None and os.path.isdir(cache_dir):
        try:
            hit = _cache_load(cache_dir, load_evs="frames" in events)
            if hit is not None:
                logger(f"[DATALOADER] Cache hit: {cache_dir}")
                return hit
        except Exception as e:  # corrupted/stale cache: fall through to full load
            logger(f"[DATALOADER] Cache load failed ({e}), reloading from source")

    if events != "" and "." not in events:
        events = events + ("_tf.npy" if do_transform else ".npy")

    h5_filename = data_dir + ("_tf" if (do_transform and "_tf" not in data_dir) else "") + ".h5"
    found_h5 = (os.path.exists(h5_filename) or source is not None) and use_h5
    f = None
    if found_h5 and source is not None:
        logger(f"[DATALOADER] Reading {len(source)} trajectories from memory in place of {h5_filename}")
        f = source
    elif found_h5:
        logger(f"[DATALOADER] Found {h5_filename}, loading dataset")
        f = _h5py().File(h5_filename, "r")
    elif not os.path.isdir(data_dir):
        hint = (
            " (a .stat.json stamp exists: the source h5 was deleted after caching,"
            " but this call's args missed every cache entry — regenerate the h5"
            " or rerun with the original preprocessing args)"
            if os.path.exists(h5_filename + ".stat.json")
            else ""
        )
        raise FileNotFoundError(
            f"dataset not found: neither {h5_filename} nor a trajectory folder at {data_dir}{hint}"
        )

    dataset_name = os.path.basename(data_dir)

    # ---- choose trajectory folders (order + shuffle parity) ----
    tvd_invalid = True
    if train_val_dirs is not None:
        for part in (train_val_dirs[0], train_val_dirs[1]):
            for folder in part:
                if dataset_name in str(folder):
                    tvd_invalid = False
                    break
    logger(f"[DATALOADER] train_val_dirs_is_invalid={tvd_invalid}")

    if train_val_dirs is not None and not tvd_invalid:
        tvd = [list(el) if isinstance(el, np.ndarray) else list(el) for el in train_val_dirs]
        new = [[], [], [], []]
        for i in range(len(tvd[0])):
            if dataset_name in str(tvd[0][i]):
                new[0].append(tvd[0][i])
                new[2].append(tvd[2][i])
        for i in range(len(tvd[1])):
            if dataset_name in str(tvd[1][i]):
                new[1].append(tvd[1][i])
                new[3].append(tvd[3][i])
        traj_folders = list(new[0]) + list(new[1])
        val_split = len(new[1]) / len(traj_folders)
        traj_folders_ids = list(np.hstack((new[2], new[3])).astype(int)) if traj_folders else []
    else:
        if found_h5:
            traj_folders = [os.path.join(data_dir, k) for k in f.keys()]
        else:
            traj_folders = sorted(glob.glob(opj(data_dir, "*/")))
        traj_folders_ids = list(range(len(traj_folders)))
        if seed is not None and seed > -2:
            s = int(time.time() * 1e3) if seed == -1 else seed
            random.seed(s)
            random.shuffle(traj_folders)
            random.seed(s)
            random.shuffle(traj_folders_ids)

    if short > 0:
        traj_folders = traj_folders[:short]
        traj_folders_ids = traj_folders_ids[:short]

    # ---- per-trajectory loading with filtering ----
    load_evs = "frames" in events
    metas, ims_list, depths_list, evs_list = [], [], [], []
    desired_vels: List[np.ndarray] = []
    kept_folders, kept_ids = [], []
    num_collision_trajs = 0

    # folder format: one object-array of per-trajectory event-frame stacks at
    # the dataset root, reindexed by the (shuffled, sliced) folder ids
    # (reference dataloading.py:164-166); png vs legacy-npy detection by the
    # first folder's contents (dataloading.py:181)
    is_png = True
    evframes_all = None
    if not found_h5:
        is_png = len(glob.glob(opj(traj_folders[0], "*.png"))) > 0 if traj_folders else True
        logger(f"[DATALOADER] Image files are {'png' if is_png else 'npy'}")
        if load_evs:
            evframes_all = np.load(opj(data_dir, events), allow_pickle=True)
            evframes_all = evframes_all[np.asarray(traj_folders_ids, int)]
            logger(f"[DATALOADER] Loaded event frames of length {len(evframes_all)} from {events}")

    for traj_i, folder in enumerate(traj_folders):
        gname = folder.rstrip("/").split("/")[-1]
        if found_h5:
            meta = np.asarray(f[gname]["data"][()], np.float64)
        else:
            meta = _read_data_csv(opj(folder, "data.csv"), is_png)
        if np.isnan(meta).any():
            logger(f"[DATALOADER] NaN in {gname}, skipping.")
            continue
        if meta[:, -1].sum() > 0:
            num_collision_trajs += 1
            logger(
                f"[DATALOADER] {meta[:, -1].sum()} collisions in {gname}, "
                f"{num_collision_trajs}th so far, "
                f"{'skipping!' if not keep_collisions else 'keeping!'}"
            )
            if not keep_collisions:
                continue

        if found_h5:
            ims = np.asarray(f[gname]["ims"][()], np.float32)
            depths = np.asarray(f[gname]["depths"][()], np.float32)
            if load_evs:
                evs_list.append(np.asarray(f[gname]["evs"][()], np.float32))
        else:
            loaded = _load_folder_traj(folder, np.asarray(meta), is_png, logger)
            if loaded is None:
                continue
            meta, ims, depths = loaded
            if depths is None:
                # datasets recorded without *_depth.png (depth-free
                # deployments): keep the frame axis consistent downstream
                depths = np.zeros_like(ims)
            if load_evs:
                evs_list.append(np.asarray(evframes_all[traj_i], np.float32))

        metas.append(np.asarray(meta, np.float32))
        ims_list.append(ims)
        depths_list.append(depths)
        if is_png or found_h5:
            desired_vels.append(np.asarray(meta[:, 2], np.float32))
        else:
            # legacy npy datasets: approximate desvel from the max x velcmd
            desired_vels.append(np.full(len(meta), meta[:, 12].max(), np.float32))
        kept_folders.append(folder)
        kept_ids.append(traj_folders_ids[traj_i])

    if f is not None and f is not source:
        f.close()
    if not metas:
        raise ValueError(f"No valid trajectories in {h5_filename if found_h5 else data_dir}")

    # ---- optional resize ----
    if resize_input is not None:
        size = tuple(resize_input)
        needs = (
            ims_list[0].shape[-2:] != size
            or depths_list[0].shape[-2:] != size
            or (load_evs and evs_list[0].shape[-2:] != size)
        )
        if needs:
            logger(f"[DATALOADER] Resizing input images to {resize_input}")
            ims_list = [_resize_bilinear_np(x, size) for x in ims_list]
            depths_list = [_resize_bilinear_np(x, size) for x in depths_list]
            if load_evs:
                evs_list = [_resize_bilinear_np(x, size) for x in evs_list]

    traj_lengths = np.array([x.shape[0] for x in ims_list])
    meta_full = np.concatenate(metas, axis=0)
    ims_full = np.concatenate(ims_list, axis=0)
    depths_full = np.concatenate(depths_list, axis=0)
    desvel_full = np.concatenate(desired_vels, axis=0)

    # ---- split ----
    n_traj = len(traj_lengths)
    if split_method == "train-val":
        num_train = int((1.0 - val_split) * n_traj)
        tr_tr = (0, num_train)
        va_tr = (num_train, n_traj)
    elif split_method == "val-train":
        num_val = int(val_split * n_traj)
        va_tr = (0, num_val)
        tr_tr = (num_val, n_traj)
    else:
        raise ValueError(f"split_method={split_method}")

    def frame_range(traj_range):
        lo = int(np.sum(traj_lengths[: traj_range[0]], dtype=np.int64))
        hi = int(np.sum(traj_lengths[: traj_range[1]], dtype=np.int64))
        return lo, hi

    # ---- depth rescale ----
    if rescale_depth > 0.0:
        logger(
            f"[DATALOADER] Rescaling depth by {rescale_depth}\tNOTE max/min of dataset "
            f"depth is {depths_full.max()}/{depths_full.min()}."
        )
        depths_full = np.clip(depths_full / rescale_depth, 0.0, 1.0)

    # ---- event-frame rescale ----
    if load_evs:
        max_evs = max(ev.max() for ev in evs_list)
        min_evs = min(ev.min() for ev in evs_list)
        logger(f"[DATALOADER] Rescaling evs = {rescale_evs}\tNOTE max/min of dataset evs is {max_evs}/{min_evs}.")
        if rescale_evs > 0.0:
            evs_list = [np.clip(ev / rescale_evs, -1.0, 1.0) for ev in evs_list]
        elif rescale_evs == -1.0:
            for i, ev in enumerate(evs_list):
                flat = np.abs(ev).reshape(ev.shape[0], -1)
                # linear-interpolated 97th percentile (== torch.quantile ==
                # np.quantile) via np.partition on the two bracketing order
                # statistics: exact, O(n) instead of the full sort — the
                # per-frame quantile dominated dataset load time at 30k+
                # frames
                n = flat.shape[1]
                h = 0.97 * (n - 1)
                k = int(np.floor(h))
                part = np.partition(flat, (k, min(k + 1, n - 1)), axis=1)
                maxvals = part[:, k] + (h - k) * (part[:, min(k + 1, n - 1)] - part[:, k])
                # all-zero frames (e.g. before first motion) would divide by 0
                maxvals = np.where(maxvals > 0, maxvals, 1.0)
                evs_list[i] = np.clip(ev / maxvals[:, None, None], -1.0, 1.0)
        if evs_min_cutoff is not None:
            for i, ev in enumerate(evs_list):
                ev = ev.copy()
                ev[np.abs(ev) < evs_min_cutoff] = 0.0
                evs_list[i] = ev

    def make_split(traj_range) -> TrajectorySplit:
        lo, hi = frame_range(traj_range)
        t0, t1 = traj_range
        return TrajectorySplit(
            meta=meta_full[lo:hi],
            ims=ims_full[lo:hi],
            depths=depths_full[lo:hi],
            trajlength=traj_lengths[t0:t1],
            desvel=desvel_full[lo:hi],
            evs=evs_list[t0:t1] if load_evs else None,
            dirs=kept_folders[t0:t1],
            dirs_ids=kept_ids[t0:t1],
        )

    out = make_split(tr_tr), make_split(va_tr), is_png or found_h5
    if cache_dir is not None:
        t0 = time.time()
        _cache_save(cache_dir, out[0], out[1], out[2], key_parts=cache_key)
        logger(f"[DATALOADER] Cached preprocessed tensors to {cache_dir} ({time.time()-t0:.0f}s)")
    return out


def cache_dataset(data_dir: str, trajectories: Sequence[dict], logger=None,
                  **kwargs) -> Tuple[TrajectorySplit, TrajectorySplit, bool]:
    """Preprocess ``trajectories`` (``write_h5_dataset``'s dicts) as
    ``dataloader(data_dir, **kwargs)`` reads an h5 file of them, and keep
    the result in its preprocessed-tensor cache under a ``.h5.stat.json``
    stamp, with no h5 file and no h5py: a later ``dataloader(data_dir,
    **kwargs)`` (the Learner's) takes the cache hit.  Returns the splits."""
    if os.environ.get("EVFLY_DATA_CACHE", "1") == "0":
        raise ValueError("cache_dataset needs the dataloader's cache (EVFLY_DATA_CACHE=0)")
    do_transform = kwargs.get("do_transform", False)
    src = data_dir + ("_tf" if (do_transform and "_tf" not in data_dir) else "") + ".h5"
    if os.path.exists(src):
        raise FileExistsError(f"{src} exists: the dataloader would read it, not the cache")
    # f32, as write_h5_dataset stores them; in the h5 file's (sorted) key order
    source = {t["name"]: {k: np.asarray(t[k], np.float32)
                          for k in ("data", "ims", "depths", "desvel", "evs")
                          if t.get(k) is not None}
              for t in sorted(trajectories, key=lambda t: t["name"])}
    size = sum(v.nbytes for t in source.values() for v in t.values())
    os.makedirs(os.path.dirname(os.path.abspath(src)), exist_ok=True)
    with open(src + ".stat.json", "w") as fh:
        json.dump({"mtime_ns": time.time_ns(), "size": int(size)}, fh)
    if not kwargs.pop("use_h5", True):
        raise ValueError("cache_dataset stands in for an h5 file: use_h5 must be True")
    args = inspect.signature(dataloader).bind(data_dir, logger=logger, use_h5=True, **kwargs)
    args.apply_defaults()
    return _dataloader(source=source, **args.arguments)
