"""One stream of raw event windows through ``StreamingPipeline.step_events``
(the deployment loop's step: K1, the exact percentile, the joint model with
its carried state, one CUDA graph replay per step).

Each window's events are numpy arrays on the host, as a camera driver hands
them over; a step ends when its velocity is on the host.  Set-up captures
the graph of every event bucket the pool's windows fall in, then zeroes the
state.  The check follows the first ``check_start_steps`` steps from the
zero state with the reference, and each step of the seeded sample from the
state the program held before it (cloned then); it compares the velocity,
the depth and the new state.
"""

from __future__ import annotations

import gc

import torch

from .. import generate
from ..counts import kernels
from ..reference import events, models
from ._base import Driver as Base, Errors, tf32


class Driver(Base):
    program_attrs = ("pipe",)

    def setup(self):
        from evfly_tpu_torch.stream.pipeline import StreamingPipeline, event_bucket

        t, dev = self.traffic, self.dev
        self.H, self.W = self.config["input_hw"]
        self.sd = self.make_weights()
        model = self.joint_program(self.sd).eval()
        self.n = generate.sizes(t["events_per_window"], t["pool"], self.cell.seed)
        x, y, p = generate.edge_events(self.n, self.H, self.W, t["edges"],
                                       generate.generator(self.cell.seed, 2, dev), dev)
        x, y, p = (v.cpu().numpy() for v in (x, y, p))
        self.windows = [(x[i, :m].copy(), y[i, :m].copy(), p[i, :m].copy())
                        for i, m in enumerate(self.n)]
        self.desvel = torch.tensor([t["desvel"]], device=dev)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.pipe = StreamingPipeline(model, desvel=t["desvel"], input_hw=(self.H, self.W),
                                      device=dev)
        first = {}
        for i, m in enumerate(self.n):
            first.setdefault(event_bucket(int(m)), i)
        for _ in range(t["warmup_rounds"]):
            for i in first.values():
                self.pipe.step_events(*self.windows[i])[0].cpu()
        self.pipe.reset()

    def state(self):
        """The program's state as the reference holds it, cloned."""
        (h_unet, _), (h, c) = self.pipe.hidden
        (hu, cu), = h_unet
        return tuple(s.clone() for s in (hu, cu, h[None], c[None]))

    def step(self, k, keep):
        before = self.state() if keep and k >= self.start_steps else None
        vel, depth = self.pipe.step_events(*self.windows[k % len(self.windows)])
        vel = vel.cpu()
        if keep:
            self.kept[k] = {"before": before, "vel": vel, "depth": depth,
                            "after": self.state()}
        self.steps_done = k + 1

    def least_s(self, k):
        return {"k1": kernels.least_s(*kernels.k1(int(self.n[k % len(self.n)]),
                                                  self.H, self.W)),
                "lstm": kernels.least_s(*kernels.lstm(1, 1, 128, 3))}

    def _frame(self, k):
        x, y, p = (torch.as_tensor(v, device=self.dev)[None]
                   for v in self.windows[k % len(self.windows)])
        return events.quantile_scale(events.histogram(x, y, p, self.H, self.W))

    def reference(self, on_tf32: bool):
        """k -> (velocity, depth, state after) of each kept step, by the
        reference: the first steps chained from zero, the others from the
        program's state before them."""
        out, carried = {}, (None, None)
        with torch.no_grad(), tf32(on_tf32):
            for k in sorted(self.kept):
                if k < self.start_steps:
                    h_unet, h_vit = carried
                else:
                    s = self.kept[k]["before"]
                    h_unet, h_vit = (s[0], s[1]), (s[2], s[3])
                v, d, hu, hv = models.stream_step(self.sd, self._frame(k), self.desvel,
                                                  h_unet, h_vit)
                if k < self.start_steps:
                    carried = (hu, hv)
                out[k] = (v[0], d[0], (*hu, *hv))
        return out

    @staticmethod
    def compare(got, ref):
        errs = Errors()
        for k, (v, d, s) in ref.items():
            gv, gd, gs = got[k]
            errs.add("vel", gv, v)
            errs.add("depth", gd, d)
            for a, b in zip(gs, s):
                errs.add("state", a, b)
        return errs.numbers()

    def check(self):
        got = {k: (r["vel"], r["depth"], r["after"]) for k, r in self.kept.items()}
        return self.compare(got, self.reference(False))

    def control(self):
        return self.compare(self.reference(True), self.reference(False))

    def flops_step(self):
        frame = torch.zeros(1, self.H, self.W, device=self.dev)
        models.stream_step(self.sd, frame, self.desvel, None, None)
