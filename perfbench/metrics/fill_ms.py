"""Host ms a streaming step in ``evfly.stream.fill``: the copies of the
step's inputs into the graph's buffers (for a window of host events, the
pageable copies and the padding)."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.stream.fill", "host")
