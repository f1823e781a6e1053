"""The convolution kernels' share of their roofline: the sum over the
model's convolutions (forward, and backward in training) of each one's
least time, counted over the reference (``counts.model_flops``), times the
traced steps, over the device time of the kernels classed "conv"."""

from ._roofline import share


def read(ctx):
    if ctx.model_flops is None:
        return None
    return share(ctx.summary.steps * ctx.model_flops["conv_least_s"],
                 ctx.summary.class_s.get("conv"))
