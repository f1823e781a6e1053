"""Device ms a streaming step in ``evfly.frame``: the histogram of a window
of events (K1, ``step_events``) and the exact percentile's scaling, timed
by the marks the step's CUDA graph replays."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.frame", "device")
