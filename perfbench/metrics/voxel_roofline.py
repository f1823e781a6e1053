"""E-RAFT's voxel grid's share of its roofline, in percent: its least time
a step (the class ``voxel``, ``counts.eraft.voxel``) over the device ms a
step of ``evfly.frame``, the mark of the grid and its normalisation in the
step's CUDA graph."""

from ._marked import roofline


def read(ctx):
    return roofline(ctx, "voxel", "evfly.frame")
