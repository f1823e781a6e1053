"""Device ms a closed-loop tick in ``evfly.sim.render``: the render, difflog
and quantization of the G camera views, on the device's clock (timing
events around the span's launches)."""

from ._spans import per_step


def read(ctx):
    return per_step("evfly.sim.render", "device")
