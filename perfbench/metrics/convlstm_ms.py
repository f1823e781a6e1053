"""Device ms a streaming step in ``evfly.rvt.lstm``: the per-pixel LSTMs of
RVT's four stages, timed by the marks the step's CUDA graph replays."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.rvt.lstm", "device")
