"""Device ms a streaming step in ``evfly.eraft.encode``: E-RAFT's feature
encoder over both windows' grids and its context encoder over the current
one, timed by the marks the step's CUDA graph replays."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.eraft.encode", "device")
