"""Host ms a train step in ``evfly.train.forward``: the spectral norms'
power iteration and the forward with its loss."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.train.forward", "host")
