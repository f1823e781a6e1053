"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``perfbench/configs/<name>.json``, from
``BENCHMARK.json``) and a traffic mix (``perfbench/traffic/<traffic>.json``).
The mix names its driver (``perfbench/drivers/<driver>.py``), which builds
the program from the seed, drives one step of it, and compares what the
timed steps produced with the plain reference (``perfbench/reference``).
The numbers compared and their limits are ``perfbench/limits/<cell>.json``;
each per-layer metric is read by ``perfbench/metrics/<family>.py``, the
family being the metric's name up to its first dot.

A run: set-up (weights, inputs, program, warm-up), then steps back to back
for ``--seconds``, a reservoir of the steps drawn from the seed kept for the
check; with ``--trace 1`` a profiled stretch of the mix's ``trace_steps``
after the window; the peak memory; the program freed; the check.  The
last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import math
import pathlib
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np

PERFBENCH = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "evfly_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Optional[dict]
    end_to_end: List[dict]
    per_layer: List[dict]
    seed: int
    seconds: float
    trace: bool
    device: object = None


def load_cell(root: pathlib.Path, workload: str, seed: int, seconds: float, trace: bool) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((PERFBENCH / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = PERFBENCH / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else None

    def here(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if here(m) and ("workloads" in m or m["moves"] in reported)]
    return Cell(workload, config, traffic, limits, e2e, per_layer, seed, seconds, trace)


class Reservoir:
    """A uniform sample, drawn from the seed, of the steps of a window of
    unknown length (Algorithm R), beside the steps always kept: the first
    ``first`` and those in ``always``."""

    def __init__(self, seed: int, size: int, first: int, always=()):
        self.rng = np.random.default_rng([seed, 0x5a3])
        self.size, self.first, self.always = size, first, set(always)
        self.kept: List[int] = []
        self.seen = 0

    def offer(self, k: int):
        """(keep step k, the step it evicts or None)."""
        if k < self.first or k in self.always:
            return True, None
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(k)
            return True, None
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            evicted, self.kept[j] = self.kept[j], k
            return True, evicted
        return False, None


def window(driver, seconds: float, max_steps: Optional[int] = None):
    """Steps back to back until ``seconds`` have passed (or ``max_steps``):
    (steps, window seconds, each step's host seconds)."""
    sampler = Reservoir(driver.cell.seed, driver.check_samples, driver.start_steps,
                        driver.always_keep())
    times = []
    t0 = time.perf_counter()
    k = 0
    while (max_steps is None and time.perf_counter() - t0 < seconds) or \
            (max_steps is not None and k < max_steps):
        keep, evicted = sampler.offer(k)
        if evicted is not None:
            driver.forget(evicted)
        t = time.perf_counter()
        driver.step(k, keep)
        times.append(time.perf_counter() - t)
        k += 1
    driver.sync()
    return k, time.perf_counter() - t0, times


def end_to_end(cell: Cell, setup_s: float, steps: int, seconds: float) -> Dict[str, dict]:
    """The cell's end-to-end metrics by the formulas its traffic names."""
    out = {}
    for m in cell.end_to_end:
        if m["name"] == "setup_s":
            value = setup_s
        else:
            kind = cell.traffic["end_to_end"][m["name"]]
            if kind == "rate":
                value = cell.traffic["units_per_step"] * steps / seconds
            elif kind == "mean_ms":
                value = 1e3 * seconds / steps
            else:
                raise ValueError(f"unknown end-to-end formula {kind!r}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Optional[dict]):
    """(correct, checks): each number beside its limit; a number that is
    not finite, or has no limit, fails."""
    checks = {}
    correct = limits is not None
    for name, value in numbers.items():
        limit = None if limits is None else limits.get(name)
        ok = limit is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks


def run_cell(cell: Cell, t0: float, max_steps: Optional[int] = None) -> dict:
    """Set up, measure, trace, check: the result object."""
    import torch

    from . import tracing

    driver = importlib.import_module(f"perfbench.drivers.{cell.traffic['driver']}").Driver(cell)
    driver.setup()
    driver.sync()
    setup_s = time.perf_counter() - t0
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    steps, seconds, times = window(driver, cell.seconds, max_steps)
    result = {"correct": False, "attempted": steps, "failed": 0,
              "metrics": end_to_end(cell, setup_s, steps, seconds)}
    ctx = None
    if cell.trace:
        summary = tracing.profile(driver, cell.traffic["trace_steps"])
        ctx = tracing.Context(summary, steps, seconds, times,
                              json.loads((PERFBENCH / "counts" / "peaks.json").read_text()))
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    driver.free_program()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check()
    if cell.trace:
        ctx.model_flops = driver.model_flops()
        result["metrics"] = read_per_layer(cell, ctx)
    correct, checks = judge(numbers, cell.limits)
    result["correct"] = correct
    result["device"] = device_info(cell.device, peak, ctx)
    if ctx is not None:
        result["breakdown"] = ctx.summary.breakdown
    result["checks"] = checks
    result["_step_times"] = times
    return result


def read_per_layer(cell: Cell, ctx) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        family = m["name"].split(".")[0]
        value = importlib.import_module(f"perfbench.metrics.{family}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(device, peak: int, ctx) -> dict:
    import torch

    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if ctx is not None:
        info["busy_s"] = ctx.summary.busy_s
        info["window_s"] = ctx.summary.window_s
    return info


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = PERFBENCH.parent
    # numpy's and torch's generators take seeds of 0 to 2**63 - 1
    cell = load_cell(root, args.workload, args.seed % 2 ** 63, args.seconds, bool(args.trace))

    importlib.import_module("evfly_tpu_torch")  # the program under test
    import torch

    chips = next(w["chips"] for w in json.loads((root / "BENCHMARK.json").read_text())
                 ["workloads"] if w["name"] == cell.name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell.device = torch.device("cuda", 0)
    result = run_cell(cell, t0)
    times = result.pop("_step_times")
    if times:
        print(f"perfbench: {len(times)} steps in the window; step ms p50 "
              f"{1e3 * statistics.median(times)}, max {1e3 * max(times)}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad}; it may load none of {FORBIDDEN}",
              file=sys.stderr)
        return 3
    print(f"perfbench: correct {result['correct']}; the numbers compared and their limits:",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
