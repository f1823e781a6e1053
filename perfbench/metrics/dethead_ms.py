"""Device ms a streaming step in ``evfly.rvt.head``: the detector's PAFPN,
its decoupled head and the decode, timed by the marks the step's CUDA
graph replays."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.rvt.head", "device")
