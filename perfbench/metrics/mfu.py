"""The whole step's share of the card's f32 peak, in percent: the model's
operations per step (counted over the reference, forward and, in training,
backward) times the window's steps, over the window's seconds and the peak."""


def read(ctx):
    if not ctx.model_flops or not ctx.seconds:
        return None
    rate = ctx.model_flops["flops"] * ctx.steps / ctx.seconds
    return 100.0 * rate / ctx.peaks["f32_flops_per_s"]
