"""Batches of raw event windows through the serving step:
``ops.voxelizer.event_histogram_scaled_resized`` (K3: histogram, the
97th-percentile scale, the resize to 60x90) then ``LSTMNetVIT.forward``
with the batch's windows as the LSTM's time axis (K4), dispatched eagerly.

The batches sit on the card, as an evaluation or data-generation job holds a
cached split; each is padded with pol-0 events to its longest window.  A
step ends when the batch's velocities are on the host.  The check
recomputes the seeded sample of batches with the reference and compares
the K3 frames, the velocities and the LSTM's final (h, c).
"""

from __future__ import annotations

import torch

from .. import generate
from ..counts import kernels
from ..reference import events, models
from ._base import Driver as Base, Errors, tf32


class Driver(Base):
    program_attrs = ("model",)

    def setup(self):
        from evfly_tpu_torch.models.vitfly import LSTMNetVIT

        t, dev = self.traffic, self.dev
        self.H, self.W = self.config["input_hw"]
        self.h, self.w = self.config["model_hw"]
        self.B = t["batch"]
        self.sd = self.make_weights()
        self.model = LSTMNetVIT(device=dev).load_params(
            {k: v.clone() for k, v in self.sd.items()}).eval()
        gen = generate.generator(self.cell.seed, 2, dev)
        self.batches, self.real = [], []
        for b in range(t["pool"]):
            n = generate.sizes(t["events_per_window"], self.B, self.cell.seed, 10 + b)
            self.batches.append(generate.edge_events(n, self.H, self.W, t["edges"], gen, dev))
            self.real.append(int(n.sum()))
        self.desvel = torch.full((self.B, 1), t["desvel"], device=dev)
        for i in range(t["warmup_rounds"]):
            self.run(self.batches[i % len(self.batches)])

    def run(self, batch):
        from evfly_tpu_torch.ops.voxelizer import event_histogram_scaled_resized

        with torch.inference_mode():
            frames = event_histogram_scaled_resized(*batch, self.H, self.W, self.h, self.w,
                                                    device=self.dev)
            vel, (h, c) = self.model(frames[:, None], self.desvel)
            return frames, vel.cpu(), h, c

    def step(self, k, keep):
        out = self.run(self.batches[k % len(self.batches)])
        if keep:
            self.kept[k] = out
        self.steps_done = k + 1

    def least_s(self, k):
        real = self.real[k % len(self.real)]
        return {"k3": kernels.least_s(*kernels.k3(real, self.B, self.H, self.W, self.h, self.w)),
                "lstm": kernels.least_s(*kernels.lstm(1, self.B, 128, 3))}

    def reference(self, on_tf32: bool):
        out = {}
        with torch.no_grad(), tf32(on_tf32):
            for k in sorted(self.kept):
                frames = events.scaled_resized(*self.batches[k % len(self.batches)], self.H,
                                               self.W, self.h, self.w)
                vel, (h, c) = models.vitlstm(self.sd, frames[:, None], self.desvel)
                out[k] = (frames, vel, h, c)
        return out

    @staticmethod
    def compare(got, ref):
        errs = Errors()
        for k, (f, v, h, c) in ref.items():
            gf, gv, gh, gc_ = got[k]
            errs.add("frame", gf, f)
            errs.add("vel", gv, v)
            errs.add("state", gh, h)
            errs.add("state", gc_, c)
        return errs.numbers()

    def check(self):
        return self.compare(self.kept, self.reference(False))

    def control(self):
        return self.compare(self.reference(True), self.reference(False))

    def flops_step(self):
        models.vitlstm(self.sd, torch.zeros(self.B, 1, self.h, self.w, device=self.dev),
                       self.desvel)
