"""A kernel class's share of its roofline over the traced stretch: the least
time its work needs (``counts``) over the device time its kernels took."""


def share(least_s, device_s):
    """100 least / device seconds, or None where no kernel of the class ran
    or its work is not counted."""
    if not least_s or not device_s:
        return None
    return 100.0 * least_s / device_s


def kernel(ctx, cls: str):
    s = ctx.summary
    return share(s.least_s.get(cls), s.class_s.get(cls))
