"""Cells of BENCHMARK.json cut to CPU test sizes: the same drivers, fewer and
smaller steps, the joint model at 190x190 (the smallest frame its UNet
takes; every width as configured)."""

import copy
import json
import pathlib

import torch

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
SMALL = {
    "joint.stream.g1": {"pool": 6, "events_per_window": {"law": "log_uniform", "lo": 200, "hi": 3000},
                        "check_start_steps": 3, "check_samples": 2, "trace_steps": 2},
    "vitlstm.serve.b256": {"batch": 8, "pool": 2, "units_per_step": 8,
                           "events_per_window": {"law": "log_uniform", "lo": 100, "hi": 1500},
                           "check_samples": 2, "trace_steps": 2},
    "joint.stream.g16": {"streams": 2, "pool": 3, "units_per_step": 2,
                         "reset_every": {"lo": 2, "hi": 3}, "check_start_steps": 2,
                         "check_samples": 2, "trace_steps": 2},
    "joint.train.dp8": {"chunk": 4, "chunks_per_step": 2, "chunks": 7, "units_per_step": 8,
                        "trace_steps": 2, "check_window_steps": 4},
}
STEPS = 6


# traffic files of cells not in BENCHMARK.json, run on a cell of theirs
OTHER = {"train.c16": ("joint.train.dp8", {"chunks_per_step": None, "chunk": 4, "chunks": 3,
                                            "units_per_step": 4, "check_window_steps": 4})}


def cpu_cell(workload: str, seed: int = 11, traffic: str = None) -> harness.Cell:
    cell = harness.load_cell(ROOT, workload, seed, 0.0, False)
    small = SMALL[workload]
    if traffic is not None:
        cell.traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{traffic}.json").read_text())
        small = {**small, **OTHER[traffic][1]}
    cell.traffic = {**copy.deepcopy(cell.traffic), **small}
    if cell.config["model"] == "joint":
        cell.config = {**cell.config, "input_hw": [190, 190]}
    cell.device = torch.device("cpu")
    return cell


def run(cell: harness.Cell) -> dict:
    import time

    return harness.run_cell(cell, time.perf_counter(), max_steps=STEPS)


def readings(cell: harness.Cell):
    """(the program's numbers, the control's) of a run at test sizes."""
    driver = harness.importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}").Driver(cell)
    driver.setup()
    harness.window(driver, 0.0, STEPS)
    driver.free_program()
    return driver.check(), driver.control()
