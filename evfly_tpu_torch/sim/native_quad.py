"""ctypes binding for the native flight-stack core (native/flightcore.cpp).

Port of ``evfly_tpu/sim/native_quad.py``, loading the port's copy of the
library (``evfly_tpu_torch/native/flightcore.cpp``, built at its first use
by ``native._build``).

``NativeFlightCore`` is a velocity-commanded vehicle
(set_velocity_command / step / .state / reset) backed by the C++ library
that mirrors the reference's host-side flight stack (dodgelib pilot chain +
flightlib rigid-body dynamics — SURVEY.md §2.4).  The math matches the JAX
package's numpy ``sim/rigid_body.py`` at double precision
(tests/test_torch_hil.py holds the two to tests/test_flightcore.py's
tolerance).

``run_batch`` amortizes the ctypes boundary: one call integrates many
control periods with a command schedule.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..native import _build
from .dynamics import QuadState

_LIB = None
_LIB_LOCK = threading.Lock()


def _load():
    """The port's libflightcore, its entry points typed; raises
    RuntimeError when it does not build."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = _build.load("flightcore")
            lib.flightcore_create.restype = ctypes.c_void_p
            lib.flightcore_create.argtypes = [ctypes.c_double] * 4
            for fn in ("destroy", "reset", "set_velocity_command", "step", "get_state",
                       "run"):
                getattr(lib, f"flightcore_{fn}").restype = None
            lib.flightcore_destroy.argtypes = [ctypes.c_void_p]
            lib.flightcore_reset.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 3
            lib.flightcore_set_velocity_command.argtypes = (
                [ctypes.c_void_p] + [ctypes.c_double] * 3
            )
            lib.flightcore_step.argtypes = [
                ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
            ]
            lib.flightcore_get_state.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
            ]
            lib.flightcore_run.argtypes = [
                ctypes.c_void_p, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_double),
            ]
            _LIB = lib
    return _LIB


class NativeFlightCore:
    """Velocity-commanded quadrotor through the native full stack."""

    def __init__(self, start_pos=(0.0, 0.0, 2.0), cmd_timeout: float = 0.5):
        self._lib = _load()
        self._handle = self._lib.flightcore_create(
            float(start_pos[0]), float(start_pos[1]), float(start_pos[2]),
            float(cmd_timeout),
        )
        self._buf = (ctypes.c_double * 14)()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.flightcore_destroy(handle)
            self._handle = None

    def reset(self, start_pos=(0.0, 0.0, 2.0)):
        self._lib.flightcore_reset(
            self._handle, float(start_pos[0]), float(start_pos[1]), float(start_pos[2])
        )

    def set_velocity_command(self, vel_cmd):
        v = np.asarray(vel_cmd, float)
        self._lib.flightcore_set_velocity_command(self._handle, v[0], v[1], v[2])

    def _to_state(self, arr) -> QuadState:
        s = np.asarray(arr, float)
        return QuadState(t=s[0], pos=s[1:4].copy(), vel=s[4:7].copy(), att=s[7:11].copy())

    @property
    def state(self) -> QuadState:
        self._lib.flightcore_get_state(self._handle, self._buf)
        return self._to_state(self._buf[:])

    def step(self, dt: float) -> QuadState:
        self._lib.flightcore_step(self._handle, float(dt), self._buf)
        return self._to_state(self._buf[:])

    def run_batch(self, dt: float, cmds: np.ndarray, cmd_every: int,
                  n_steps: int) -> np.ndarray:
        """Integrate ``n_steps`` periods of ``dt``, applying ``cmds[i//cmd_every]``
        at every ``cmd_every``-th step (last command held).  Returns the full
        state history, shape (n_steps, 14): [t, p3, v3, q_wxyz, w3]."""
        cmds = np.ascontiguousarray(np.asarray(cmds, np.float64).reshape(-1, 3))
        out = np.empty((int(n_steps), 14), np.float64)
        self._lib.flightcore_run(
            self._handle, float(dt),
            cmds.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(cmds),
            int(cmd_every), int(n_steps),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out
