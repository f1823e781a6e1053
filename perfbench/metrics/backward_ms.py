"""Host ms a train step in ``evfly.train.backward``: autograd's backward,
as the thread that calls it waits for it."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.train.backward", "host")
