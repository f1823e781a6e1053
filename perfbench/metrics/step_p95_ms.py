"""The 95th percentile of the window's step times on the host clock, in ms:
a step from handing its inputs to the entry point until its velocity is on
the host."""

import statistics


def read(ctx):
    if len(ctx.step_times) < 20:
        return None
    return 1e3 * statistics.quantiles(ctx.step_times, n=20)[18]
