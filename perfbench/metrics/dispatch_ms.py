"""Host ms a served batch in ``evfly.frame`` (K3's entry point) plus
``evfly.head`` (V(phi)'s eager forward): the dispatch of the batch's work,
over the traced batches."""

from ._spans import records


def read(ctx):
    ms = [r.host_ms for r in records()
          if r.name in ("evfly.frame", "evfly.head") and r.host_ms is not None]
    if not ms or not ctx.summary.steps:
        return None
    return sum(ms) / ctx.summary.steps
