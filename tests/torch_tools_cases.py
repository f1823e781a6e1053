"""Shared cases of the drivers' tests (tests/test_torch_tools_*.py): the
repo's JAX drivers loaded as modules, and canned closed-loop results.

Importing ``tools/train_policy.py``, ``datagen.py``, ``e2e_demo.py`` or
``hil_real_model.py`` sets JAX's compilation-cache options and reads
``EVFLY_OUT``/``EVFLY_DATASETS``; ``jax_tool`` sets the environment first
and puts JAX's options and the environment back after, so the other test
files of an xdist worker see no change.
"""

import importlib.util
import os
import pathlib
import sys

import numpy as np
import pytest

REPO =pathlib.Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
_JAX_OPTIONS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
_loaded = {}


def jax_tool(name: str, out: str = None):
    """``tools/<name>.py`` as the module ``jax_tools_<name>`` (loaded once
    per process), with ``EVFLY_OUT`` set to ``out`` while it imports."""
    if name in _loaded:
        return _loaded[name]
    import jax

    saved_opts = {k: getattr(jax.config, k) for k in _JAX_OPTIONS}
    saved_env = {k: os.environ.get(k) for k in ("EVFLY_OUT", "EVFLY_DATASETS")}
    saved_path = list(sys.path)
    os.environ["EVFLY_OUT"] = out or str(REPO / ".data" / "evfly_test")
    os.environ.pop("EVFLY_DATASETS", None)
    sys.path.insert(0, str(TOOLS))  # hil_real_model imports train_policy by bare name
    try:
        spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", TOOLS / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for k, v in saved_opts.items():
            jax.config.update(k, v)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        sys.path[:] = saved_path
    _loaded[name] = module
    return module


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """PyTorch held to 2 threads while a module runs (six xdist workers
    share the cores; tests/torch_train_cases.py's rule), put back after.
    Autouse in every module that imports it."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def keep_precision():
    """Both packages' global precision put back after each test: the
    drivers set it ("default" in JAX, "tf32" in the port), as their
    callers' processes keep it, and an xdist worker runs other files after
    this one.  Autouse in every module that imports it."""
    import evfly_tpu.ops.imageops as imageops
    import evfly_tpu_torch.precision as precision

    saved = (imageops.PRECISION, precision.get_precision())
    yield
    imageops.PRECISION = saved[0]
    precision.set_precision(saved[1])


def canned_results(seed: int, G: int, T: int = 40, H: int = 24, W: int = 32, x0: float = 0.0):
    """G run_trials_batched-style results of T logged frames at H x W: a
    21-column log (positions along x from ``x0`` at 2 m, 4 m/s), quantized
    depth, intensity and event frames, and a summary (every third trial
    crashes, one falls short of 30 frames)."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(G):
        n = T if g != 1 else 20
        log = rng.normal(size=(n, 21)).astype(np.float64)
        log[:, 0] = np.arange(n)
        log[:, 1] = np.arange(n) / 15.0
        log[:, 2] = 4.0
        log[:, 7] = x0 + 0.27 * np.arange(n)
        log[:, 8] = rng.uniform(-0.5, 0.5)
        log[:, 9] = 2.0
        log[:, 10:13] = [4.0, 0.1, 0.0]
        log[:, 20] = (np.arange(n) > n // 2) & (g % 3 == 0)
        depths = [np.round(rng.uniform(size=(H, W)) * 255) / 255 for _ in range(n)]
        intens = [np.round(rng.uniform(size=(H, W)) * 255) / 255 for _ in range(n)]
        events = [np.round(rng.normal(size=(H, W))) * 0.2 for _ in range(n)]
        summary = {"Success": g % 3 != 0, "number_crashes": int(g % 3 == 0)}
        if g % 3 != 0:
            summary["time_to_finish"] = float(15 + rng.uniform())
        out.append({"summary": summary, "log": log, "depths": depths,
                    "intensities": intens, "events": events})
    return out


class Recorder:
    """A stand-in for run_trials_batched: records each call's arguments
    and returns canned results."""

    def __init__(self, H: int = 24, W: int = 32):
        self.calls = []
        self.H, self.W = H, W

    def __call__(self, fields, **kwargs):
        self.calls.append(dict(fields=fields, **kwargs))
        return canned_results(len(self.calls), len(fields), H=self.H, W=self.W)
