"""The share of the events a streaming step's kernels took that were
padding, in percent: 100 (sum of buckets - sum of real events) / (sum of
buckets) over the traced steps' ``evfly.stream.fill`` records (counts
``events`` and ``bucket``)."""

from ._spans import records


def read(ctx):
    fills = [r.counts for r in records()
             if r.name == "evfly.stream.fill" and "bucket" in r.counts]
    bucket = sum(c["bucket"] for c in fills)
    if not bucket:
        return None
    return 100.0 * (bucket - sum(c["events"] for c in fills)) / bucket
