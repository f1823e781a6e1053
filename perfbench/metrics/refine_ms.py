"""Device ms a streaming step in ``evfly.eraft.refine``: E-RAFT's refinement
iterations (lookups, motion encoder, separable ConvGRU, flow head), timed
by the marks the step's CUDA graph replays."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.eraft.refine", "device")
