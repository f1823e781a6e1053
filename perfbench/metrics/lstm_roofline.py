"""K4's or K5's (the LSTM's, any route's) share of its roofline: the least
time of the work each traced step gave it (``counts.kernels.lstm``) over
its device time."""

from ._roofline import kernel


def read(ctx):
    return kernel(ctx, "lstm")
