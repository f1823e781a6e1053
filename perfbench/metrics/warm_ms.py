"""Device ms a streaming step in ``evfly.eraft.warm``: E-RAFT's forward
interpolation of its 1/8 flow for the next window (every target against
every source), timed by the marks the step's CUDA graph replays."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.eraft.warm", "device")
