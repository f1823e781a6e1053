"""Prophesee EVT3 raw-recording reader (ctypes over the port's native/evt3.cpp).

Port of ``evfly_tpu/data/evt3.py``: a recorded event camera's native
on-disk format (EVT3, .raw) into flat (t_us, x, y, p) arrays, ready for
``data.realdata.package_real_sequence`` (voxelize -> h5 trajectory schema):

    ev = read_evt3("recording.raw")
    traj = package_real_sequence("real_000", ev["t"] * 1e-6, ev["x"], ev["y"],
                                 ev["p"], depth_frames, depth_ts, ...)

The decoder is the port's copy of the JAX package's ``evt3.cpp``, built by
``native._build`` with one ``g++`` into ``build/libevt3_<hash>.so`` at its
first use.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, Optional

import numpy as np

from ..native import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The decoder's library, built at first use, entry points typed."""
    lib = _build.load("evt3")
    lib.evt3_decode_file.restype = ctypes.c_void_p
    lib.evt3_decode_file.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.evt3_decode_buffer.restype = ctypes.c_void_p
    lib.evt3_decode_buffer.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.evt3_count.restype = ctypes.c_longlong
    lib.evt3_count.argtypes = [ctypes.c_void_p]
    lib.evt3_geometry.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.evt3_copy.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int8),
    ]
    lib.evt3_free.argtypes = [ctypes.c_void_p]
    return lib


def _extract(lib, handle) -> Dict[str, np.ndarray]:
    try:
        n = lib.evt3_count(handle)
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        lib.evt3_geometry(handle, ctypes.byref(w), ctypes.byref(h))
        t = np.empty(n, np.int64)
        x = np.empty(n, np.uint16)
        y = np.empty(n, np.uint16)
        p = np.empty(n, np.int8)
        if n:
            lib.evt3_copy(
                handle,
                t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                p.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            )
        return {"t": t, "x": x, "y": y, "p": p,
                "width": int(w.value), "height": int(h.value)}
    finally:
        lib.evt3_free(handle)


def read_evt3(path: str, max_events: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Decode an EVT3 .raw file.  Returns {"t" (us, int64), "x", "y"
    (uint16), "p" (int8 +-1), "width", "height"} (geometry 0 if the header
    carries none)."""
    lib = _lib()
    handle = lib.evt3_decode_file(
        os.fspath(path).encode(), -1 if max_events is None else int(max_events)
    )
    if not handle:
        raise IOError(f"cannot read EVT3 file: {path}")
    return _extract(lib, handle)


def decode_evt3_bytes(buf: bytes, max_events: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Decode EVT3 from an in-memory buffer (header optional)."""
    lib = _lib()
    arr = np.frombuffer(buf, np.uint8)
    handle = lib.evt3_decode_buffer(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(arr),
        -1 if max_events is None else int(max_events),
    )
    if not handle:
        raise IOError("EVT3 buffer decode failed")
    return _extract(lib, handle)
