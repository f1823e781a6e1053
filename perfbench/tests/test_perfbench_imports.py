"""The harness loads neither JAX nor the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and exits
without a result where it cannot measure."""

import os
import pathlib
import shutil
import subprocess
import sys
import types

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "evfly_tpu_torch_like", types.ModuleType("x"))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "evfly_tpu", raising=False)
    assert "evfly_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "evfly_tpu.ops", types.ModuleType("evfly_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["evfly_tpu", "jax"]


def test_a_cpu_run_of_every_driver_loads_no_jax():
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        f"sys.path[:1] = [{str(ROOT)!r}]\n"
        "from perfbench.tests import cells\n"
        "from perfbench import harness\n"
        "for w in cells.SMALL:\n"
        "    cell = cells.cpu_cell(w); cell.trace = True\n"
        "    r = cells.run(cell)\n"
        "    assert r['attempted'] == cells.STEPS, r\n"
        "print(sorted(n.split('.')[0] for n in sys.modules if n.split('.')[0] in harness.FORBIDDEN))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "joint.stream.g1",
                           "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, timeout=300,
                          env={**os.environ, **(env or {})})


def test_no_card_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
