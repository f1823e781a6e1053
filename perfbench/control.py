"""Readings that the limits of ``perfbench/limits/<cell>.json`` are set from.

    python3 perfbench/control.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--seconds 2] [--out file.json]

In one process, for each seed: the cell's set-up, a short window at the
cell's own load (``--seconds``), the program freed and the check: the
program's readings (the lower readings: the largest over the seeds).  For
each control seed, the control: the reference computed in TF32 (the
precision below the configuration's f32 with TF32 off) in the program's
place, against the reference in f32 (the upper readings: the smallest);
for a training cell also a planted fault, half of each chunk left out and
the loss the mean over the rest.  The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:1] = [str(ROOT)]

from perfbench import harness  # noqa: E402


def readings(workload: str, seed: int, seconds: float, control: bool, device) -> dict:
    import torch

    cell = harness.load_cell(ROOT, workload, seed % 2 ** 63, seconds, False)
    cell.device = device
    driver = harness.importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}").Driver(cell)
    t0 = time.perf_counter()
    driver.setup()
    steps, window_s, _ = harness.window(driver, seconds)
    driver.free_program()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seed": seed, "steps": steps, "setup_and_window_s": time.perf_counter() - t0,
           "program": driver.check()}
    if control:
        out["control"] = driver.control()
        if hasattr(driver, "fault_half_batch"):
            out["fault_half_batch"] = driver.fault_half_batch()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    runs = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        runs.append(readings(args.workload, seed, args.seconds, seed in args.control_seeds,
                             device))
        print(json.dumps(runs[-1]), flush=True)
    lower = {k: max(r["program"][k] for r in runs) for k in runs[0]["program"]}
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(device),
               "lower": lower, "runs": runs}
    for kind in ("control", "fault_half_batch"):
        rs = [r[kind] for r in runs if kind in r]
        if rs:
            summary[f"upper_{kind}"] = {k: min(r[k] for r in rs) for k in rs[0]}
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
