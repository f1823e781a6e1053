"""Streaming event accumulation — evfly_ros C++ node semantics.

Port of ``evfly_tpu/stream/accumulator.py``.  The reference deployment
accumulates raw events into a uint8 frame (base 128, ±1 per event,
640×480) at 30 Hz and hands it to the model node, which converts
``(uint8 - 128) * 0.2`` and center-crops to 260×346
(evfly_ros/src/node.cpp:24-59, evfly_ros/run.py:334-350; the DVS variant
clamps at the uint8 range, evfly_dv_ros/src/node.cpp:33-41).

Here the accumulator is an in-process stage feeding the streaming step.
The C++ implementation is the port's copy of the accumulator
(``native/evstream.cpp``, built at its first use by ``native._build``);
``native=False`` takes the numpy version, ``native=None`` the C++ one
where it builds.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..native import _build


def _load_native() -> ctypes.CDLL:
    """The port's libevstream, its entry points typed; raises RuntimeError
    when it does not build."""
    lib = _build.load("evstream")
    lib.evstream_create.restype = ctypes.c_void_p
    lib.evstream_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.evstream_destroy.restype = None
    lib.evstream_destroy.argtypes = [ctypes.c_void_p]
    lib.evstream_accumulate.restype = None
    lib.evstream_accumulate.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64,
    ]
    lib.evstream_drain.restype = None
    lib.evstream_drain.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    return lib


class EventAccumulator:
    """±1 uint8 accumulation with base 128 and clamping (node.cpp parity).

    native: True takes the C++ library and raises if it does not build;
    False the numpy version; None the library where it builds, else numpy.
    ``is_native`` says which one runs."""

    def __init__(self, height: int = 480, width: int = 640, base: int = 128,
                 native: Optional[bool] = None):
        self.height = height
        self.width = width
        self.base = base
        lib = None
        if native is True:
            lib = _load_native()
        elif native is None:
            try:
                lib = _load_native()
            except RuntimeError:
                lib = None
        self._lib = lib
        if lib is not None:
            self._handle = lib.evstream_create(height, width, base)
        else:
            self._frame = np.full((height, width), base, np.uint8)

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def accumulate(self, x: np.ndarray, y: np.ndarray, pol: np.ndarray):
        """Add events: pol > 0 increments, pol <= 0 decrements (clamped)."""
        x = np.ascontiguousarray(x, np.int32)
        y = np.ascontiguousarray(y, np.int32)
        p = np.ascontiguousarray(np.where(np.asarray(pol) > 0, 1, -1), np.int8)
        if not (x.shape == y.shape == p.shape and x.ndim == 1):
            raise ValueError(f"x, y, pol must be one (N,) shape, got {x.shape}, {y.shape}, "
                             f"{p.shape}")
        if self._lib is not None:
            self._lib.evstream_accumulate(
                self._handle,
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                p.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                len(x),
            )
            return
        valid = (x >= 0) & (x < self.width) & (y >= 0) & (y < self.height)
        x, y, p = x[valid], y[valid], p[valid]
        acc = self._frame.astype(np.int32)
        np.add.at(acc, (y, x), p.astype(np.int32))
        self._frame = np.clip(acc, 0, 255).astype(np.uint8)

    def drain(self) -> np.ndarray:
        """Return the current uint8 frame and reset to base (30 Hz timer path)."""
        if self._lib is not None:
            out = np.empty((self.height, self.width), np.uint8)
            self._lib.evstream_drain(self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            return out
        out = self._frame
        self._frame = np.full((self.height, self.width), self.base, np.uint8)
        return out

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_handle", None):
            self._lib.evstream_destroy(self._handle)
            self._handle = None


def frame_from_accumulated(
    frame_u8: np.ndarray,
    thresh: float = 0.2,
    base: int = 128,
    crop_hw=(260, 346),
) -> np.ndarray:
    """uint8 accumulator frame -> float event frame, center-cropped.

    (frame - 128) * 0.2 then center-crop to the model input size
    (run.py:334-350).
    """
    ev = (frame_u8.astype(np.float32) - base) * thresh
    H, W = ev.shape
    ch, cw = crop_hw
    if (H, W) != (ch, cw):
        ev = ev[H // 2 - ch // 2 : H // 2 + ch // 2, W // 2 - cw // 2 : W // 2 + cw // 2]
    return ev
