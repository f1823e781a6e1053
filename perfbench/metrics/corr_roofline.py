"""E-RAFT's all-pairs correlation's share of its roofline, in percent: its
least time a step (the class ``corr``, ``counts.eraft.corr``: the GEMM's
operations against the pyramid's bytes) over the device ms a step of
``evfly.eraft.corr``, the mark of the GEMM and the pooled levels."""

from ._marked import roofline


def read(ctx):
    return roofline(ctx, "corr", "evfly.eraft.corr")
