"""A class of work's share of its roofline against the marks that time it:
its least time a step (the driver's ``least_s`` of the class) over the
device ms a step of the program's graph marks of one name."""

from ._spans import per_step


def roofline(ctx, cls: str, mark: str):
    """100 least / device seconds a step, or None where the program keeps no
    such mark or the driver counts no such work."""
    s = ctx.summary
    least = s.least_s.get(cls)
    mark_ms = per_step(mark, "device")
    if not least or not mark_ms or not s.steps:
        return None
    return 100.0 * (least / s.steps) / (mark_ms * 1e-3)
