"""One camera's stream of raw event windows through E-RAFT
(``StreamingPipeline.step_events`` with the timestamps: the voxel grid, the
encoders, the correlation pyramid, 12 refinement iterations, the convex
upsampling and the warm start, one CUDA graph replay per step).

Each window's events are on the host in a camera's types (16-bit
coordinates on the 480x640 sensor, 8-bit polarity +-1, 64-bit timestamps
in microseconds, sorted), slices of one page-locked buffer per column, as
``stream_detect`` hands them over.  A step ends when its full-resolution
flow is in a page-locked host buffer.  The rectification map is drawn from
the seed (``reference.eraft.rectify_map``) and given to the program and the
reference alike.  Set-up captures the graph of every event bucket the
pool's windows fall in, then zeroes the state.

The check follows the first ``check_start_steps`` steps from the zero state
with the reference (the first window gives no flow, the second starts
cold), and each step of the seeded sample from the state the program held
before it (cloned then).  It compares ``flow`` (the upsampled flow) and
``low`` (the 1/8 flow) of the steps with a flow, each as a share of the
reference's correction in that window: ``low`` against the reference's
flow_low less the init the window started from, ``flow`` against its
upsampled flow less that init upsampled with the same mask.  Both sides
start from one init, which the program carried and which drifts over a run
to pixels, while a window's 12 refinements move the flow by hundredths of a
pixel: the carried part would hide the window's own work in the scale.  It
also compares ``voxel`` (the program's grid, its new state, against the
reference's of the same events) and ``warm`` (the program's carried init
against the reference's forward interpolation of the program's own 1/8
flow: the nearest-neighbour fill is discontinuous, so it meets the check
only there, both sides reading one input).
"""

from __future__ import annotations

import gc
import sys

import torch

from .. import generate
from ..counts import eraft as eraft_counts, kernels
from ..reference import eraft
from ._base import Errors, tf32
from .stream_detect import Driver as Detect


class Driver(Detect):
    program_attrs = ("pipe", "host_flow")

    def make_weights(self):
        return eraft.init_weights(self.cell.seed, self.dev)

    def setup(self):
        from evfly_tpu_torch.models.eraft import ERAFT
        from evfly_tpu_torch.stream.pipeline import StreamingPipeline, event_bucket

        t, c, dev = self.traffic, self.config, self.dev
        self.sensor = tuple(c["sensor_hw"])
        self.sd = self.make_weights()
        self.rect = eraft.rectify_map(self.cell.seed, self.sensor, dev)
        model = ERAFT(device=dev, sensor_hw=self.sensor).load_params(
            {k: v.clone() for k, v in self.sd.items()}).eval().set_rectify_map(self.rect)
        self.n = generate.sizes(t["events_per_window"], t["pool"], self.cell.seed)
        self.windows = self.windows_from_seed()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.pipe = StreamingPipeline(model, device=dev)
        self.host_flow = torch.empty(1, 2, *self.sensor, pin_memory=dev.type == "cuda")
        first = {}
        for i, m in enumerate(self.n):
            first.setdefault(event_bucket(int(m)), i)
        for _ in range(t["warmup_rounds"]):
            for i in first.values():
                self.host_flow.copy_(self.pipe.step_events(*self.windows[i])[0])
        self.pipe.reset()

    def state(self):
        """(previous grid, init, windows seen), cloned."""
        return tuple(s.clone() for s in self.pipe.hidden[:3])

    def step(self, k, keep):
        before = self.state() if keep and k >= self.start_steps else None
        flow, low, valid = self.pipe.step_events(*self.windows[k % len(self.windows)])
        self.host_flow.copy_(flow)
        if keep:
            voxel, init, seen = self.state()
            self.kept[k] = {"before": before, "flow": flow[0], "low": low[0],
                            "valid": bool(valid), "voxel": voxel, "init": init[0]}
        self.steps_done = k + 1

    def least_s(self, k):
        n = int(self.n[k % len(self.n)])
        H, W = self.sensor
        lookup = eraft_counts.lookup(H // 8, W // 8)
        return {"voxel": kernels.least_s(*eraft_counts.voxel(n, eraft.BINS, H, W)),
                "corr": kernels.least_s(*eraft_counts.corr(H // 8, W // 8)),
                "lookup": kernels.least_s(eraft.ITERATIONS * lookup[0],
                                          eraft.ITERATIONS * lookup[1])}

    def _voxel(self, k, voxel_f32: bool):
        x, y, p, t = (torch.as_tensor(v, device=self.dev)
                      for v in self.windows[k % len(self.windows)])
        return eraft.voxel_grid(x, y, p, t, self.rect,
                                accumulate=torch.float32 if voxel_f32 else torch.float64)

    def reference(self, convs_tf32: bool = False, voxel_f32: bool = False):
        """k -> the reference's step k, chained as the module's docstring
        says: ``flow``, ``low`` (None for a stream's first window),
        ``start`` (the init it started from), ``carried`` (that init
        upsampled), ``voxel``, ``warm`` (the forward interpolation of the
        program's flow_low).  ``convs_tf32``: convolutions and matmuls in
        TF32; ``voxel_f32``: the voxel grid summed in f32 (E-RAFT's own),
        where the configuration sums in f64."""
        out = {}
        H, W = self.sensor
        prev = torch.zeros(eraft.BINS, H, W, device=self.dev)
        init = torch.zeros(2, H // 8, W // 8, device=self.dev)
        seen = 0
        track = {"inside": 0, "samples": 0}
        with torch.no_grad(), tf32(convs_tf32):
            for k in sorted(self.kept):
                if k >= self.start_steps:
                    b = self.kept[k]["before"]
                    prev, init, seen = b[0], b[1][0], int(b[2])
                voxel = self._voxel(k, voxel_f32)
                step = eraft.stream_step(self.sd, voxel, prev, init, seen, track)
                flow, low, start, carried = step or (None,) * 4
                if k < self.start_steps:
                    prev, seen = voxel, min(seen + 1, 2)
                    if step:
                        init = eraft.forward_interpolate(low)
                out[k] = {"flow": flow, "low": low, "start": start, "carried": carried,
                          "voxel": voxel, "warm": eraft.forward_interpolate(self.kept[k]["low"])}
        share = track["inside"] / track["samples"] if track["samples"] else None
        print(f"perfbench: eraft level-0 lookup samples inside the map: {share}", file=sys.stderr)
        return out

    def compare(self, got, ref):
        """``got``: k -> flow, low, valid, voxel, init; ``ref``: the f32
        reference's steps."""
        errs = Errors()
        for k, r in ref.items():
            g = got[k]
            if (r["flow"] is not None) != g["valid"]:
                errs.add("flow", torch.full((1,), float("nan")), torch.zeros(1))
            elif r["flow"] is not None:
                errs.add("flow", g["flow"].to(r["flow"]) - r["carried"], r["flow"] - r["carried"])
                errs.add("low", g["low"].to(r["low"]) - r["start"], r["low"] - r["start"])
            errs.add("voxel", g["voxel"], r["voxel"])
            errs.add("warm", g["init"], r["warm"])
        return errs.numbers()

    def check(self):
        return self.compare(self.kept, self.reference())

    def control(self, voxel_f32: bool = True):
        """The reference in the precision below the configuration's against
        the reference: TF32 convolutions and matmuls and, unless
        ``voxel_f32`` is False, the voxel grid summed in f32."""
        below = self.reference(True, voxel_f32)
        got = {k: {"flow": r["flow"], "low": r["low"], "valid": r["flow"] is not None,
                   "voxel": r["voxel"], "init": r["warm"]} for k, r in below.items()}
        return self.compare(got, self.reference())

    def flops_step(self):
        H, W = self.sensor
        frame = torch.zeros(eraft.BINS, H, W, device=self.dev)
        eraft.stream_step(self.sd, frame, frame, torch.zeros(2, H // 8, W // 8, device=self.dev),
                          2)
