"""Device ms a streaming step in ``evfly.head``: V(phi), the ViT encoder
and the LSTM head (K4), timed by the marks the step's CUDA graph
replays."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.head", "device")
