"""Device ms a streaming step in ``evfly.depth``: D(theta), the UNet with
its ConvLSTM, timed by the marks the step's CUDA graph replays."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.depth", "device")
