"""Hardware-in-the-loop deployment bench: native flight stack + runner.

Port of ``run_hil_episode`` and ``HILResult`` of ``evfly_tpu/stream/hil.py``
on the port's accumulator, ``DeploymentRunner`` and flight-stack core.  The
reference validates real deployment by flying the evfly_ros stack on a
vehicle (README "Real-world deployment"): a C++ accumulator node feeds
run.py's 15 Hz guarded loop, whose commands the autopilot's native control
stack executes.  This harness reproduces that architecture in-process so the
whole deployment chain is testable end to end without an aircraft:

    sensor(state) -> events -> [native evstream accumulator]
        -> DeploymentRunner.tick()   (the streaming step + safety guards)
        -> [native flightcore]       (SE(3) controller + rigid body, C++)
        -> new state -> sensor ...

Vehicle and accumulator are the actual native libraries that would run
host-side on an aircraft; the model step is the port's streaming pipeline
(one CUDA graph per step on the card).  The ``sensor`` callback closes the
loop — pass a renderer-backed callable (see tests) or replay recorded
events.

Timing is simulated (the runner gets a virtual clock), so a HIL episode is
deterministic and CI-runnable; command cadence follows the reference's
15 Hz node loop against a 100 Hz vehicle step (run.py:43, sim_dt 0.01).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from ..sim.native_quad import NativeFlightCore
from .deploy import DeploymentRunner, SafetyConfig


@dataclass
class HILResult:
    t: np.ndarray          # (T,) tick times [s]
    pos: np.ndarray        # (T, 3)
    vel: np.ndarray        # (T, 3)
    cmd: np.ndarray        # (T, 3) guarded commands as issued
    guard_stopped: bool    # safety latch fired
    # full 100 Hz vehicle-rate trajectory, shape (T*steps_per_tick, 14):
    # [t, p3, v3, q_wxyz, w3] — the intra-tick dynamics the 15 Hz samples
    # above subsample, so safety and overshoot assertions see between
    # command ticks
    fine: np.ndarray = None
    # pilot-flown episodes (use_pilot=True): mode transitions
    # [(t, from, to)] and phase boundaries {"takeoff"/"run"/"land": (t0, t1)}
    transitions: list = None
    phases: dict = None


def run_hil_episode(
    pipeline,
    sensor: Callable[[np.ndarray, float], tuple],
    duration: float = 5.0,
    tick_hz: float = 15.0,
    sim_dt: float = 0.01,
    des_fwd_vel: float = 4.0,
    safety: Optional[SafetyConfig] = None,
    start_pos=(0.0, 0.0, 2.0),
    trigger: bool = True,
    use_pilot: bool = False,
) -> HILResult:
    """Fly one closed-loop episode on the native stack.

    ``sensor(pos, t) -> (x, y, pol)`` produces the event burst for the
    current vehicle position (arrays in sensor pixel coordinates), exactly
    what a camera's event stream would hand the accumulator between ticks.

    ``use_pilot=True`` flies the episode the way the real system does
    (dodgelib pilot, pilot.cpp:104-168): arm -> min-snap takeoff to
    hover -> policy commands as velocity references -> min-jerk landing ->
    off.  Mode transitions and phase boundaries are returned in the result;
    start the vehicle on the ground (z < takeoff_threshold) to exercise the
    takeoff trajectory rather than the handheld-start branch.
    """
    from ..sim.pilot import MODE_HOVER, MODE_OFF, Pilot

    clock_t = [0.0]
    runner = DeploymentRunner(
        pipeline, des_fwd_vel=des_fwd_vel, safety=safety,
        clock=lambda: clock_t[0],
    )
    quad = NativeFlightCore(start_pos=start_pos)

    steps_per_tick = max(int(round(1.0 / tick_hz / sim_dt)), 1)
    n_ticks = int(duration * tick_hz)

    ts: List[float] = []
    ps: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    cs: List[np.ndarray] = []
    fine: List[np.ndarray] = []
    state = quad.state

    pilot = Pilot(quad=quad) if use_pilot else None
    phases = {}

    def _fly_pilot_phase(until_mode: str, max_s: float):
        """Vehicle-rate pilot tracking (trajectory refs vary within a
        command tick); samples the tick-rate logs on the way."""
        nonlocal state
        t_start = clock_t[0]
        n = 0
        while pilot.mode != until_mode and clock_t[0] - t_start < max_s:
            cmd = pilot.update()
            st = quad.step(sim_dt)
            clock_t[0] += sim_dt
            fine.append(np.concatenate(
                [[clock_t[0]], st.pos, st.vel, st.att, np.zeros(3)]
            )[None, :])
            n += 1
            if n % steps_per_tick == 0:
                ts.append(clock_t[0])
                ps.append(st.pos.copy())
                vs.append(st.vel.copy())
                cs.append(np.asarray(cmd, float))
        state = quad.state
        return t_start, clock_t[0]

    if use_pilot:
        pilot.start()
        phases["takeoff"] = _fly_pilot_phase(
            MODE_HOVER, pilot.params.takeoff_height / pilot.params.start_land_speed + 3.0
        )
        run_t0 = clock_t[0]

    for _ in range(n_ticks):
        x, y, pol = sensor(state.pos, clock_t[0])
        if len(x):
            runner.push_events(x, y, pol)
        runner.push_odometry(state.pos)
        if trigger:
            runner.push_trigger()  # deadman fed every tick, like /trigger
        cmd = runner.tick()

        if use_pilot:
            # the policy command enters as a velocity reference, exactly
            # how the envtest node feeds the reference pilot
            pilot.set_velocity_reference(cmd)
            cmd = pilot.update()
        else:
            quad.set_velocity_command(cmd)
        hist = quad.run_batch(sim_dt, np.asarray(cmd, float)[None, :],
                              cmd_every=0, n_steps=steps_per_tick)
        fine.append(hist)
        state = quad.state
        clock_t[0] += steps_per_tick * sim_dt

        ts.append(clock_t[0])
        ps.append(state.pos.copy())
        vs.append(state.vel.copy())
        cs.append(np.asarray(cmd, float))

    if use_pilot:
        phases["run"] = (run_t0, clock_t[0])
        # land() from velocity mode force-hovers first (reference guard);
        # settle briefly in hover, then a second call flies the descent
        if not pilot.land():
            _fly_pilot_phase(MODE_OFF, 1.0)  # 1 s hover settle (never OFF)
            pilot.land()
        z0 = float(quad.state.pos[2])
        phases["land"] = _fly_pilot_phase(
            MODE_OFF, z0 / pilot.params.start_land_speed + 3.0
        )

    return HILResult(
        t=np.asarray(ts), pos=np.asarray(ps), vel=np.asarray(vs),
        cmd=np.asarray(cs), guard_stopped=runner.safety_guard_triggered,
        fine=np.concatenate(fine, axis=0) if fine else np.zeros((0, 14)),
        transitions=pilot.transitions if use_pilot else None,
        phases=phases if use_pilot else None,
    )
