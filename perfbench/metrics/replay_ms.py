"""Host ms a streaming step in ``evfly.stream.replay``: the launch of the
step's CUDA graph."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.stream.replay", "host")
