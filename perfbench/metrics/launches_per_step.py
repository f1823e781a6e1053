"""Kernels that ran on the device per traced step (copies and fills left
out), a graph replay's kernels counted one by one."""


def read(ctx):
    s = ctx.summary
    return s.kernels / s.steps if s.steps and s.kernels else None
