"""The share of V(phi)'s traced served batches that replayed a CUDA graph,
in percent: 100 x the ``evfly.head`` host records whose count ``replayed``
is 1, over all ``evfly.head`` host records.  None where no record carries
the count (a program whose serving forward has no graph)."""

from ._spans import records


def read(ctx):
    heads = [r for r in records() if r.name == "evfly.head" and r.host is not None]
    if not any("replayed" in r.counts for r in heads):
        return None
    return 100.0 * sum(r.counts.get("replayed") == 1 for r in heads) / len(heads)
