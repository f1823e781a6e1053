"""Device ms a streaming step in ``evfly.rvt.attention``: RVT's window and
grid attention blocks (with their MLPs) of the four stages, timed by the
marks the step's CUDA graph replays."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.rvt.attention", "device")
