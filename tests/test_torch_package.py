"""Package rules of the port: no JAX, nothing of evfly_tpu, CUDA by default."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import evfly_tpu_torch
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.ops import voxelizer

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "evfly_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
) + ["chip_smoke"]


def test_imports_load_no_jax_and_nothing_of_evfly_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'evfly_tpu' or m.startswith('evfly_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_EVFLY = re.compile(r"^\s*(import\s+evfly_tpu\b(?!_torch)|from\s+evfly_tpu\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax_and_nothing_of_evfly_tpu(path):
    text = path.read_text()
    assert not _JAX.search(text), f"{path} imports jax"
    assert not _EVFLY.search(text), f"{path} imports evfly_tpu"


def test_scan_patterns_are_word_bounded():
    assert _EVFLY.search("from evfly_tpu.ops import voxelizer")
    assert _EVFLY.search("import evfly_tpu")
    assert not _EVFLY.search("from evfly_tpu_torch.ops import voxelizer")
    assert _JAX.search("import jax.numpy as jnp")
    assert not _JAX.search("import jaxtyping")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evfly_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        LSTMNetVIT()
    with pytest.raises(RuntimeError, match="CUDA"):
        voxelizer.event_histogram_scaled_resized([[1.0]], [[1.0]], [[1]], 4, 4, 2, 2)
    assert evfly_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_exits_nonzero_without_cuda():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
