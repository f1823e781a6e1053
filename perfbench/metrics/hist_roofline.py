"""The stacked histogram's share of its roofline, in percent: its least
time a step (the driver's ``least_s`` of the class ``hist``,
``counts.rvt.hist``) over the device ms a step of ``evfly.frame``, the mark
of the histogram in the step's CUDA graph.  None where the program keeps no
such mark or the driver counts no such work."""

from ._spans import per_step


def read(ctx):
    s = ctx.summary
    least = s.least_s.get("hist")
    frame_ms = per_step("evfly.frame", "device")
    if not least or not frame_ms or not s.steps:
        return None
    return 100.0 * (least / s.steps) / (frame_ms * 1e-3)
