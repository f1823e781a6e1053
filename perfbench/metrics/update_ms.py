"""Host ms a train step in ``evfly.train.update``: the zero gradients, the
gradients' all-reduce, their norm, Adam's step and the BatchNorm update."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.train.update", "host")
