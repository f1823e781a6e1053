"""G streams in lockstep through ``BatchedStreamingPipeline.step_frames``
(closed-loop evaluation's model step: the exact percentile, the joint model
at batch G with each stream's carried state, one CUDA graph replay per
step; K1 is bypassed).

The frames are signed sparse event frames already on the card, as the
simulator's render and difflog hand them over; each stream's state is reset
at seeded steps.  A step ends when the G velocities are on the host.  The
check follows the first ``check_start_steps`` steps from the zero state,
each step of the seeded sample from the state before it (cloned then), and
always the first step with a reset; it compares the velocities, the depths
and the new state.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from .. import generate
from ..counts import kernels
from ..reference import events, models
from ._base import Driver as Base, tf32
from .stream_events import Driver as Single


class Driver(Base):
    program_attrs = ("pipe",)
    compare = staticmethod(Single.compare)

    def setup(self):
        from evfly_tpu_torch.stream.pipeline import BatchedStreamingPipeline

        t, dev = self.traffic, self.dev
        self.G = t["streams"]
        self.H, self.W = self.config["input_hw"]
        self.sd = self.make_weights()
        model = self.joint_program(self.sd).eval()
        frames = generate.sparse_frames(t["pool"] * self.G, self.H, self.W, t["frames"],
                                        generate.generator(self.cell.seed, 2, dev), dev)
        self.frames = frames.reshape(t["pool"], self.G, self.H, self.W)
        resets = generate.reset_steps(self.G, t["reset_every"]["lo"], t["reset_every"]["hi"],
                                      t["reset_horizon"], generate.rng(self.cell.seed, 3))
        self.masks = {}
        for g, steps in enumerate(resets):
            for s in steps:
                self.masks.setdefault(int(s), np.zeros(self.G, bool))[g] = True
        self.desvel = torch.full((self.G,), t["desvel"], device=dev)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.pipe = BatchedStreamingPipeline(model, self.G, desvel=t["desvel"],
                                             input_hw=(self.H, self.W), device=dev)
        for i in range(t["warmup_rounds"]):
            self.pipe.step_frames(self.frames[i % t["pool"]], np.arange(self.G) == i)[0].cpu()
        self.pipe.reset()

    def always_keep(self):
        return (min(self.masks),) if self.masks else ()

    def state(self):
        (h_unet, _), (h, c) = self.pipe.hidden
        (hu, cu), = h_unet
        return tuple(s.clone() for s in (hu, cu, h, c))

    def step(self, k, keep):
        before = self.state() if keep and k >= self.start_steps else None
        vel, depth = self.pipe.step_frames(self.frames[k % len(self.frames)], self.masks.get(k))
        vel = vel.cpu()
        if keep:
            self.kept[k] = {"before": before, "vel": vel, "depth": depth,
                            "after": self.state()}
        self.steps_done = k + 1

    def least_s(self, k):
        return {"lstm": kernels.least_s(*kernels.lstm(self.G, 1, 128, 3))}

    def reference(self, on_tf32: bool):
        out, carried = {}, None
        with torch.no_grad(), tf32(on_tf32):
            for k in sorted(self.kept):
                if k < self.start_steps:
                    s = carried
                else:
                    s = self.kept[k]["before"]
                if s is not None and k in self.masks:
                    keep = torch.as_tensor(~self.masks[k], device=self.dev).to(torch.float32)
                    s = tuple(t * keep.reshape(-1, *(1,) * (t.dim() - 1)) for t in s)
                h_unet, h_vit = (None, None) if s is None else ((s[0], s[1]), (s[2], s[3]))
                frame = events.quantile_scale(self.frames[k % len(self.frames)])
                v, d, hu, hv = models.stream_step(self.sd, frame, self.desvel, h_unet, h_vit)
                if k < self.start_steps:
                    carried = (*hu, *hv)
                out[k] = (v, d, (*hu, *hv))
        return out

    def check(self):
        got = {k: (r["vel"], r["depth"], r["after"]) for k, r in self.kept.items()}
        return self.compare(got, self.reference(False))

    def control(self):
        return self.compare(self.reference(True), self.reference(False))

    def flops_step(self):
        frame = torch.zeros(self.G, self.H, self.W, device=self.dev)
        models.stream_step(self.sd, frame, self.desvel, None, None)
