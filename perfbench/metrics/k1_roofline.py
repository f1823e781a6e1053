"""K1's (any route's) share of its roofline: the least time of the work each
traced step gave it (``counts.kernels.k1``) over its device time."""

from ._roofline import kernel


def read(ctx):
    return kernel(ctx, "k1")
