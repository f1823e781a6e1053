"""E-RAFT's pyramid lookups' share of their roofline, in percent: their
least time a step (the class ``lookup``, ``counts.eraft.lookup`` times the
iterations) over the device ms a step of the ``evfly.eraft.lookup`` marks,
one an iteration."""

from ._marked import roofline


def read(ctx):
    return roofline(ctx, "lookup", "evfly.eraft.lookup")
