"""G vision trials in lockstep through ``sim.batched.BatchedTrials`` (the
protocol evaluation's and DAgger's loop): one step is one ``tick()``, the
sim steps up to the next sensor tick, with the render, difflog and
quantization of the G views, one ``BatchedStreamingPipeline.step_frames``
of the joint model (one CUDA graph replay), the commands and the logged
rows.

Set-up draws ``batches`` x G forests (``sim.obstacles.generate_forest``)
from the seed, builds the pipeline and captures its graph in a few ticks of
a throwaway batch; the window starts the first batch from the zero state,
and when all G trials of a batch have ended the next batch starts (the
batches cycle).  The check is ``stream_frames``': for the sampled ticks, the
frames the render handed to the pipeline, the reset mask and the state
before the tick, recomputed by the reference (the first ticks chained from
zero); it compares the velocities, the depths and the new state.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import generate
from .stream_frames import Driver as Frames


class Driver(Frames):
    program_attrs = ("pipe", "trials")

    def setup(self):
        from evfly_tpu_torch.sim.obstacles import generate_forest
        from evfly_tpu_torch.stream.pipeline import BatchedStreamingPipeline

        t, dev = self.traffic, self.dev
        self.G = t["streams"]
        self.H, self.W = self.config["input_hw"]
        self.sd = self.make_weights()
        model = self.joint_program(self.sd).eval()
        r = generate.rng(self.cell.seed, 4)
        self.fields = [generate_forest(r, num_obstacles=t["num_obstacles"], trees=t["trees"])
                       for _ in range(t["batches"] * self.G)]
        self.desvel = torch.full((self.G,), t["desvel"], device=dev)
        self.pipe = BatchedStreamingPipeline(model, self.G, desvel=t["desvel"],
                                             input_hw=(self.H, self.W), device=dev)
        self.batch = -1
        self.trials = None
        self.masks, self.frames_kept = {}, {}
        self._next_batch()
        for _ in range(t["warmup_ticks"]):  # the first captures the pipeline's graph
            self.trials.tick()
        self.batch = -1
        self._next_batch()

    def _next_batch(self):
        from evfly_tpu_torch.sim.batched import BatchedTrials

        t = self.traffic
        self.batch += 1
        b = self.batch % t["batches"]
        self.trials = BatchedTrials(
            self.fields[b * self.G:(b + 1) * self.G], mode="vision", desired_vels=t["desvel"],
            policy=self.pipe, sim_dt=t["sim_dt"], policy_every=t["policy_every"],
            max_steps=t["max_steps"], H=self.H, W=self.W, seed=self.batch,
            log_images=False, obstacle_pad=t["obstacle_pad"], device=self.dev)

    def step(self, k, keep):
        while True:
            # the state before the tick, after a new batch's reset
            before = self.state() if keep and k >= self.start_steps else None
            if self.trials.tick():
                break
            self._next_batch()
        vel, depth = self.trials.last_policy
        if keep:
            reset = np.asarray(self.trials.last_reset, bool)
            if reset.any():
                self.masks[k] = reset
            self.frames_kept[k] = self.trials.last_frames.clone()
            self.kept[k] = {"before": before, "vel": vel.cpu(), "depth": depth,
                            "after": self.state()}
        self.steps_done = k + 1

    def forget(self, k):
        super().forget(k)
        self.masks.pop(k, None)
        self.frames_kept.pop(k, None)

    def _reference_frames(self):
        """stream_frames' check reads frame k as frames[k % len(frames)]: a
        list as long as the steps, the kept ticks' frames in their places."""
        self.frames = [None] * self.steps_done
        for k, f in self.frames_kept.items():
            self.frames[k] = f

    def check(self):
        self._reference_frames()
        return super().check()

    def control(self):
        self._reference_frames()
        return super().control()
