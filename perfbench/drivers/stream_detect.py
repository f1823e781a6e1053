"""One camera's stream of raw event windows through RVT-B
(``StreamingPipeline.step_events`` with the timestamps: the stacked
histogram, the four stages' attention and LSTMs, the PAFPN and the
detection head, one CUDA graph replay per step).

Each window's events are on the host in a camera's types (16-bit
coordinates on the 720x1280 sensor, 8-bit polarity +-1, 64-bit timestamps
in microseconds, sorted), slices of one buffer per column, page-locked on
a CUDA device, as a camera's driver fills a DMA ring buffer (pageable
copies spread the step between processes more than its bound allows).  A
step ends when its decoded detections are on the host.  Set-up captures
the graph of every event bucket the pool's windows fall in, then zeroes
the state.  The check follows the first ``check_start_steps`` steps from
the zero state with the reference, and each step of the seeded sample
from the state the program held before it (cloned then); it compares the
raw head output (``det``) and the four stages' new (h, c) (``state``).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from .. import generate
from ..counts import kernels, rvt as rvt_counts
from ..reference import rvt
from ._base import Driver as Base, Errors, tf32

# windows' events are made on the card this many windows at a time
CHUNK = 8
# the first window's time: a clock that needs 64 bits
T_BASE_US = 10 ** 12


class Driver(Base):
    program_attrs = ("pipe",)

    def make_weights(self):
        return rvt.init_weights(self.cell.seed, self.dev)

    def windows_from_seed(self):
        """The pool's windows (x, y, p, t), slices of one host buffer per
        column."""
        t, dev = self.traffic, self.dev
        H, W = self.sensor
        gen = generate.generator(self.cell.seed, 2, dev)
        offsets = np.concatenate([[0], np.cumsum(self.n)]).tolist()
        pool = [torch.empty(offsets[-1], dtype=dtype, pin_memory=dev.type == "cuda")
                for dtype in (torch.int16, torch.int16, torch.int8, torch.int64)]
        for lo in range(0, len(self.n), CHUNK):
            n = self.n[lo:lo + CHUNK]
            x, y, p = generate.edge_events(n, H, W, t["edges"], gen, dev)
            real = (torch.arange(x.shape[1], device=dev)[None]
                    < torch.as_tensor(n, device=dev)[:, None])
            # sorted uniform times; the padding's sort past every real one
            u = torch.where(real, torch.rand(x.shape, generator=gen, device=dev), 2.0)
            ts = (u.sort(dim=1).values * t["window_us"]).to(torch.int64)
            start = T_BASE_US + t["window_us"] * (lo + torch.arange(len(n), device=dev))
            ts = ts + start[:, None]
            cols = (x.to(torch.int16), y.to(torch.int16), p.to(torch.int8), ts)
            for i, m in enumerate(n):
                at = offsets[lo + i]
                for buf, c in zip(pool, cols):
                    buf[at:at + m].copy_(c[i, :m])
        return [tuple(buf[a:b] for buf in pool) for a, b in zip(offsets, offsets[1:])]

    def setup(self):
        from evfly_tpu_torch.models.rvt import RVT
        from evfly_tpu_torch.stream.pipeline import StreamingPipeline, event_bucket

        t, c, dev = self.traffic, self.config, self.dev
        self.sensor, self.frame_hw = tuple(c["sensor_hw"]), tuple(c["frame_hw"])
        self.partition = tuple(c["partition"])
        self.sd = self.make_weights()
        model = RVT(device=dev, sensor_hw=self.sensor, frame_hw=self.frame_hw,
                    partition=self.partition).load_params(
            {k: v.clone() for k, v in self.sd.items()}).eval()
        self.n = generate.sizes(t["events_per_window"], t["pool"], self.cell.seed)
        self.windows = self.windows_from_seed()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.pipe = StreamingPipeline(model, device=dev)
        first = {}
        for i, m in enumerate(self.n):
            first.setdefault(event_bucket(int(m)), i)
        for _ in range(t["warmup_rounds"]):
            for i in first.values():
                self.pipe.step_events(*self.windows[i])[0].cpu()
        self.pipe.reset()

    def state(self):
        """The four stages' (h, c), cloned."""
        return tuple(s.clone() for hc in self.pipe.hidden for s in hc)

    def step(self, k, keep):
        before = self.state() if keep and k >= self.start_steps else None
        decoded, raw = self.pipe.step_events(*self.windows[k % len(self.windows)])
        decoded = decoded.cpu()
        if keep:
            self.kept[k] = {"before": before, "det": raw, "after": self.state()}
        self.steps_done = k + 1

    def least_s(self, k):
        n = int(self.n[k % len(self.n)])
        return {"hist": kernels.least_s(*rvt_counts.hist(n, rvt.BINS, *self.frame_hw))}

    def _frame(self, k):
        x, y, p, t = (torch.as_tensor(v, device=self.dev)
                      for v in self.windows[k % len(self.windows)])
        return rvt.histogram(x, y, p, t, frame_hw=self.frame_hw)

    def reference(self, on_tf32: bool):
        """k -> (raw head output, state after) of each kept step, by the
        reference: the first steps chained from zero, the others from the
        program's state before them."""
        out, carried = {}, None
        with torch.no_grad(), tf32(on_tf32):
            for k in sorted(self.kept):
                if k < self.start_steps:
                    hidden = carried
                else:
                    s = self.kept[k]["before"]
                    hidden = [(s[i], s[i + 1]) for i in range(0, len(s), 2)]
                raw, new = rvt.stream_step(self.sd, self._frame(k), hidden, self.partition)
                if k < self.start_steps:
                    carried = new
                out[k] = (raw, rvt.state_leaves(new))
        return out

    @staticmethod
    def compare(got, ref):
        errs = Errors()
        for k, (det, state) in ref.items():
            g_det, g_state = got[k]
            errs.add("det", g_det, det)
            for a, b in zip(g_state, state):
                errs.add("state", a, b)
        return errs.numbers()

    def check(self):
        got = {k: (r["det"], r["after"]) for k, r in self.kept.items()}
        return self.compare(got, self.reference(False))

    def control(self):
        return self.compare(self.reference(True), self.reference(False))

    def flops_step(self):
        frame = torch.zeros(1, 2 * rvt.BINS, *self.frame_hw, device=self.dev)
        rvt.forward(self.sd, frame, None, self.partition)
