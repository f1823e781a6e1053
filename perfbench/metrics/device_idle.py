"""The device's idle share of a step, in percent: 1 - (the device's busy
seconds a step in the traced stretch, the union of the intervals in which an
operation ran) / (the measured window's seconds a step, on the host clock
with no profiler running).  The profiler lengthens the traced steps on the
host, so the traced stretch's own length would count that overhead as
idle."""


def read(ctx):
    s = ctx.summary
    if s.busy_s <= 0 or not s.steps or not ctx.steps or ctx.seconds <= 0:
        return None
    return 100.0 * (1.0 - (s.busy_s / s.steps) / (ctx.seconds / ctx.steps))
