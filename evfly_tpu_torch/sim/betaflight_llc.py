"""Betaflight low-level controller + filter emulation (SITL fidelity path).

A copy of ``evfly_tpu/sim/betaflight_llc.py`` (numpy only): the JAX package's
``sim`` imports JAX when it is imported, so the port keeps its own.

Behavioral rebuild of flightlib's Betaflight emulation
(flightmare/flightlib/src/controller/lowlevel_controller_betaflight.cpp,
pid_parts.cpp, include/flightlib/controller/filter.hpp) — the
system-identified model of the real FC firmware ("Parameter Estimate from
MATLAB, see BetaflightID.m") used when the sim must reproduce the actual
vehicle's rate response instead of the idealized simple LLC.

Reproduced exactly:

- ``FilterPT1``: the firmware's one-pole lowpass with flightlib's
  discretization b0 = w/(w+1), a1 = b0-1, w = 2*pi*fc/fs (filter.hpp
  "Discrete-time realization" comment; NOTE this uses w rather than the
  exact exp(-w) pole — replicated as-is, it is part of the identified
  model).
- ``FilterBiquad``: the TI SLAA447 biquad lowpass at Q = 1/sqrt(2)
  (filter.hpp:14-46).
- ``PidP/PidI/PidD``: identified gains P = (72.706, 72.892, 49.385),
  I = (1, 1, 1.394) with +-100 anti-windup (integrated at 1e3/fs per
  step), D = (-625.253, -630.742, 0) on the derivative of the
   350 Hz -> 250 Hz cascaded-PT1-filtered gyro, itself PT1-filtered at
  170 Hz, scaled by fs/1e3 (pid_parts.cpp:6-30).
- ``BetaflightLLC.run``: torque = 1e-3 * (P + D) (the I path exists but is
  commented out in the reference run(), :52-55 — replicated), thrust
  force = mass * mass-normalized collective, motors = B_alloc^-1 @
  [force, torque], clamped to [0, thrust_max]
  (lowlevel_controller_betaflight.cpp:46-67).  Commands are clamped at
  setCommand like QuadrotorDynamics::clampCollectiveThrust/clampBodyrates.

Not reproduced: the battery-voltage telemetry model (voltage_* constants)
— the reference header declares it but the shipped run() never updates it.

Default fs = 1000 Hz (the reference's default loop rate).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .rigid_body import QuadrotorParams


class FilterPT1:
    """filter_pt1<T> (filter.hpp:49-75): y = b0*u - a1*y_prev."""

    def __init__(self, fc: float, fs: float, dim: int = 3):
        omega = 2.0 * math.pi * fc / fs
        self.b0 = omega / (omega + 1.0)
        self.a1 = self.b0 - 1.0
        self.y1 = np.zeros(dim)

    def update(self, u: np.ndarray) -> np.ndarray:
        y0 = np.asarray(u, float) * self.b0 - self.y1 * self.a1
        self.y1 = y0
        return y0


class FilterBiquad:
    """filter_biquad<T> (filter.hpp:12-46): TI SLAA447 lowpass, Q=1/sqrt(2)."""

    def __init__(self, fc: float, fs: float, dim: int = 3):
        Q = 1.0 / math.sqrt(2.0)
        omega = 2.0 * math.pi * fc / fs
        cs, sn = math.cos(omega), math.sin(omega)
        alpha = sn / (2.0 * Q)
        a0 = 1.0 + alpha
        self.a1 = (-2.0 * cs) / a0
        self.a2 = (1.0 - alpha) / a0
        self.b0 = ((1.0 - cs) * 0.5) / a0
        self.b1 = (1.0 - cs) / a0
        self.b2 = ((1.0 - cs) * 0.5) / a0
        self.u1 = np.zeros(dim)
        self.u2 = np.zeros(dim)
        self.y1 = np.zeros(dim)
        self.y2 = np.zeros(dim)

    def update(self, u: np.ndarray) -> np.ndarray:
        u0 = np.asarray(u, float)
        y0 = (self.b0 * u0 + self.b1 * self.u1 + self.b2 * self.u2
              - self.a1 * self.y1 - self.a2 * self.y2)
        self.u2, self.u1 = self.u1, u0
        self.y2, self.y1 = self.y1, y0
        return y0


class PidP:
    P_GAIN = np.array([72.706, 72.892, 49.385])

    def update(self, setpoint, body_rate):
        return self.P_GAIN * (np.asarray(setpoint, float) - np.asarray(body_rate, float))


class PidI:
    I_GAIN = np.array([1.0, 1.0, 1.394])
    LIMIT = 100.0

    def __init__(self, fs: float):
        self.fs = fs
        self.i_part = np.zeros(3)

    def update(self, setpoint, body_rate):
        self.i_part += (np.asarray(setpoint, float) - np.asarray(body_rate, float)) * 1e3 / self.fs
        self.i_part = np.clip(self.i_part, -self.LIMIT, self.LIMIT)
        return self.i_part * self.I_GAIN


class PidD:
    D_GAIN = np.array([-625.253, -630.742, 0.0])
    F_GYRO_LPF_1 = 350.0
    F_GYRO_LPF_2 = 250.0
    F_DTERM_LPF = 170.0

    def __init__(self, fs: float):
        self.fs = fs
        self.gyro_lpf_1 = FilterPT1(self.F_GYRO_LPF_1, fs)
        self.gyro_lpf_2 = FilterPT1(self.F_GYRO_LPF_2, fs)
        self.dterm_lpf = FilterPT1(self.F_DTERM_LPF, fs)
        self.last_gyro = np.zeros(3)

    def update(self, body_rate):
        filtered = self.gyro_lpf_2.update(self.gyro_lpf_1.update(body_rate))
        d_part = self.dterm_lpf.update(filtered - self.last_gyro)
        self.last_gyro = filtered
        return d_part * self.D_GAIN * self.fs / 1e3


@dataclass
class BetaflightLLC:
    """(collective mass-normalized thrust, bodyrates) -> motor thrusts."""

    params: QuadrotorParams = field(default_factory=QuadrotorParams)
    fs: float = 1000.0
    PID_SCALE: float = 1e-3  # "betaflight scales everything this way"

    def __post_init__(self):
        self.P = PidP()
        self.I = PidI(self.fs)
        self.D = PidD(self.fs)
        self._alloc_inv = np.linalg.inv(self.params.allocation)
        self._c_thrust = 0.0
        self._omega_des = np.zeros(3)

    def set_command(self, collective_thrust: float, omega: np.ndarray) -> bool:
        """Clamped like QuadrotorDynamics::clampCollectiveThrust/Bodyrates."""
        c_max = 4.0 * self.params.thrust_max / self.params.mass
        self._c_thrust = float(np.clip(collective_thrust, 0.0, c_max))
        self._omega_des = np.clip(
            np.asarray(omega, float), -self.params.omega_max, self.params.omega_max
        )
        return True

    def run(self, omega_meas: np.ndarray) -> np.ndarray:
        """One 1/fs controller tick (lowlevel_controller_betaflight.cpp:46-67).

        The I term is computed but NOT summed into the torque — the
        reference's run() has it commented out; replicated verbatim."""
        force = self.params.mass * self._c_thrust
        p = self.P.update(self._omega_des, omega_meas)
        _i = self.I.update(self._omega_des, omega_meas)  # kept warm, unused
        d = self.D.update(omega_meas)
        torque = self.PID_SCALE * (p + d)
        tlmn = np.array([force, *torque])
        motor_thrusts = self._alloc_inv @ tlmn
        return np.clip(motor_thrusts, 0.0, self.params.thrust_max)
