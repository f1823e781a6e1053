"""What the readers of the program's spans share: the records the program
kept over the traced stretch (``evfly_tpu_torch.utils.profiling.spans()``:
each with its name, its step's root, its host and device milliseconds and
its counts), and a layer's milliseconds a step.

A program that keeps no records (one without ``profiling.spans``) gives an
empty list, and every reader None."""

import collections


def records():
    from evfly_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else []


def per_step(name: str, clock: str):
    """The mean, over the steps (root spans) that hold a record of ``name``
    timed on ``clock`` ("host" or "device"), of that step's sum of its
    milliseconds; None where no step holds one.  A step whose device
    interval was never read is left out, not counted as 0."""
    by_step = collections.defaultdict(float)
    for r in records():
        ms = r.host_ms if clock == "host" else r.device_ms
        if r.name == name and ms is not None:
            by_step[r.root] += ms
    return sum(by_step.values()) / len(by_step) if by_step else None
