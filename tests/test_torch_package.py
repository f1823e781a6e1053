"""Package rules of the port: no JAX, nothing of evfly_tpu, CUDA by default."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import evfly_tpu_torch
from evfly_tpu_torch.configs import EvflyConfig
from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.origunet import OrigUNet
from evfly_tpu_torch.models.registry import build_model
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.ops import voxelizer
from evfly_tpu_torch.stream import BatchedStreamingPipeline, StreamingPipeline
from evfly_tpu_torch.train import Learner

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "evfly_tpu_torch"
# the port's package, its smoke run and its probes under tools/
TOOLS = ["k1_phases", "k2_phase_stamps", "torch_driver_runs"]
SCRIPTS = [REPO / "chip_smoke.py"] + [REPO / "tools" / f"{t}.py" for t in TOOLS]
PORT_FILES = sorted(PORT.rglob("*.py")) + SCRIPTS
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
) + ["chip_smoke"] + [f"tools.{t}" for t in TOOLS]


def test_import_check_covers_every_module():
    for module in ("evfly_tpu_torch.stream", "evfly_tpu_torch.stream.pipeline",
                   "evfly_tpu_torch.graphs",
                   "evfly_tpu_torch.models.origunet", "evfly_tpu_torch.models.composites",
                   "evfly_tpu_torch.models.layers", "evfly_tpu_torch.models.common",
                   "evfly_tpu_torch.models.recurrent", "evfly_tpu_torch.ops.lstm_fused",
                   "evfly_tpu_torch.ops.voxelizer", "evfly_tpu_torch.precision",
                   "evfly_tpu_torch.stream.accumulator", "evfly_tpu_torch.stream.deploy",
                   "evfly_tpu_torch.stream.hil", "evfly_tpu_torch.native._build",
                   "evfly_tpu_torch.sim.dynamics", "evfly_tpu_torch.sim.native_quad",
                   "evfly_tpu_torch.sim.pilot", "evfly_tpu_torch.configs",
                   "evfly_tpu_torch.configs.config", "evfly_tpu_torch.models.port",
                   "evfly_tpu_torch.models.registry", "evfly_tpu_torch.models.rvt",
                   "evfly_tpu_torch.models.eraft",
                   "evfly_tpu_torch.data",
                   "evfly_tpu_torch.data.augment", "evfly_tpu_torch.data.dataloading",
                   "evfly_tpu_torch.train", "evfly_tpu_torch.train.__main__",
                   "evfly_tpu_torch.train.losses", "evfly_tpu_torch.train.stepfn",
                   "evfly_tpu_torch.train.learner", "evfly_tpu_torch.train.evaluation_tools",
                   "evfly_tpu_torch.utils", "evfly_tpu_torch.utils.ev_vis",
                   "evfly_tpu_torch.models.legacy_vit", "evfly_tpu_torch.ops.esim",
                   "evfly_tpu_torch.ops.upsample", "evfly_tpu_torch.data.to_events",
                   "evfly_tpu_torch.data.package_h5", "evfly_tpu_torch.data.evt3",
                   "evfly_tpu_torch.data.realdata", "evfly_tpu_torch.utils.calibration",
                   "evfly_tpu_torch.sim", "evfly_tpu_torch.sim.obstacles",
                   "evfly_tpu_torch.sim.expert", "evfly_tpu_torch.sim.evaluator",
                   "evfly_tpu_torch.sim.rigid_body", "evfly_tpu_torch.sim.planner",
                   "evfly_tpu_torch.sim.betaflight_llc", "evfly_tpu_torch.sim.render",
                   "evfly_tpu_torch.sim.closed_loop", "evfly_tpu_torch.sim.batched",
                   "evfly_tpu_torch.sim.launch_evaluation", "evfly_tpu_torch.sim.vision_env",
                   "evfly_tpu_torch.sim.quadrotor_env", "evfly_tpu_torch.sim.ppo",
                   "evfly_tpu_torch.tools", "evfly_tpu_torch.tools.train_policy",
                   "evfly_tpu_torch.tools.datagen", "evfly_tpu_torch.tools.e2e_demo",
                   "evfly_tpu_torch.tools.train_rl", "evfly_tpu_torch.tools.hil_real_model",
                   "evfly_tpu_torch.tools.esim_divergence_report",
                   "evfly_tpu_torch.tools.upsample_report",
                   "evfly_tpu_torch.tools.extract_combine", "evfly_tpu_torch.utils.profiling",
                   "evfly_tpu_torch.utils.checkpoint_surgery",
                   "evfly_tpu_torch.utils.search_logs", "evfly_tpu_torch.utils.recording_to_gif",
                   "evfly_tpu_torch.parallel", "evfly_tpu_torch.parallel.mesh",
                   "evfly_tpu_torch.parallel.data_parallel", "evfly_tpu_torch.tools.dp_quality",
                   "evfly_tpu_torch.tools.overfit_probe", "evfly_tpu_torch.tools.openloop_probe",
                   "evfly_tpu_torch.tools.bf16_accept",
                   "chip_smoke",
                   "tools.k2_phase_stamps"):
        assert module in MODULES


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


def test_models_load_no_stream_module():
    """Every module of evfly_tpu_torch.models imports without loading
    evfly_tpu_torch.stream: the captured step lives below both
    (evfly_tpu_torch.graphs), and the models reach the pipeline only
    inside a call."""
    models = [m for m in MODULES if m.startswith("evfly_tpu_torch.models")]
    code = (
        "import importlib, sys\n"
        f"for m in {models!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.startswith('evfly_tpu_torch.stream')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


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


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evfly_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        LSTMNetVIT()
    with pytest.raises(RuntimeError, match="CUDA"):
        voxelizer.event_histogram_scaled_resized([[1.0]], [[1.0]], [[1]], 4, 4, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        voxelizer.event_histogram([1.0], [1.0], [1], 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        voxelizer.event_histogram_scaled([1.0], [1.0], [1], 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        OrigUNet()
    with pytest.raises(RuntimeError, match="CUDA"):
        OrigUNet_w_VITFLY_ViTLSTM(input_shape=(1, 1, 196, 196), form_BEV=2)
    for device in ("tpu", "gpu", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Learner(EvflyConfig(device=device, dataset=None, basedir=str(tmp_path)))
    for mt in (["OrigUNet", "VITFLY_ViTLSTM"], ["OrigUNet", "ConvNet_w_VelPred"],
               ["ConvNet_w_VelPred"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(EvflyConfig(model_type=mt, bev=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(EvflyConfig(model_type=["OrigUNet"], velpred=11, bev=2))
    model = OrigUNet_w_VITFLY_ViTLSTM(input_shape=(1, 1, 196, 196), form_BEV=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingPipeline(model, input_hw=(196, 196))
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedStreamingPipeline(model, 2, input_hw=(196, 196))
    assert evfly_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_exits_nonzero_without_cuda():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# the port's drivers that run a model, the simulator or the envs, each
# with the arguments it needs to start
DRIVERS = {
    "train_policy": ["eval", "--ckpt", "artifacts/policy_best.pth", "--trials", "1"],
    "datagen": ["--trials", "1"],
    "e2e_demo": ["--trials", "1"],
    "train_rl": ["--iters", "1"],
    "hil_real_model": ["--ckpt", "artifacts/policy_best.pth"],
    "esim_divergence_report": ["--frames", "2"],
    "upsample_report": ["--frames", "2"],
    "dp_quality": ["--trajs", "1", "--epochs", "1"],
}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_drivers_need_a_card_by_default(driver, monkeypatch, tmp_path):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(REPO)
    argv = DRIVERS[driver] + (["--out", str(tmp_path)] if driver in ("datagen", "e2e_demo")
                              else [])
    main = importlib.import_module(f"evfly_tpu_torch.tools.{driver}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_exit_nonzero_without_cuda(tool):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, f"tools/{tool}.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 1 and "no CUDA device" in proc.stderr
