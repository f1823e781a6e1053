"""The port's open-loop probe (evfly_tpu_torch/tools/openloop_probe.py)
against the repo's JAX tool (tools/openloop_probe.py), on the CPU: the JAX
tool's ``build``, ``run_traj`` and ``stats`` called directly on the same
frames and the same checkpoints.

- ``vit_depth`` with ``artifacts/pretrain_v_final.pth`` on small depth
  frames (LSTMNetVIT resizes them to 60x90), carried and reset every 2;
- ``joint`` with ``artifacts/policy_best.pth`` on 260x346 event frames,
  carried and reset every 2 (the deployment input: exact 97th-percentile
  scaling, then the composite).

Velocities (the model's normalized output) within 1e-4, depth within 1e-4,
and each leaf of the carried state after the last frame within
1e-4 x max(1, max|leaf|): the joint model's cell state c is unbounded
(ROADMAP §3).  ``stats`` equal to 1e-9 on the same arrays.  The ``main``
of either package writes the same report keys.  On a card (``gpu``): the
probe's velocities and depths against the CPU's.
"""

import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

import jax

from evfly_tpu_torch.tools import openloop_probe

from torch_tools_cases import jax_tool
from torch_tools_cases import few_torch_threads, keep_precision  # noqa: F401  (fixtures)
from torch_helpers import cuda_device  # noqa: F401  (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
V_CKPT = str(REPO / "artifacts" / "pretrain_v_final.pth")
JOINT_CKPT = str(REPO / "artifacts" / "policy_best.pth")
CPU = torch.device("cpu")
ATOL = 1e-4


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return [np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)]


def _recorded(fn, box):
    """``fn`` with its last result's hidden state (third item) kept in box."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        box["hidden"] = out[2]
        return out
    return wrapped


def _jax_run(tool, monkeypatch, model, params, frames, dv, kind, reset_every=None):
    """The JAX tool's run_traj, its jitted step's last hidden state kept."""
    box = {}
    jit = lambda f: _recorded(jax.jit(f), box)
    monkeypatch.setattr(tool, "jax", types.SimpleNamespace(jit=jit, random=jax.random))
    vel, depth = tool.run_traj(model, params, frames, dv, reset_every=reset_every, kind=kind)
    monkeypatch.undo()
    return vel, depth, _leaves(box["hidden"])


def _port_run(model, frames, dv, kind, reset_every=None, monkeypatch=None):
    box = {}
    monkeypatch.setattr(openloop_probe, "_step", _recorded(openloop_probe._step, box))
    vel, depth = openloop_probe.run_traj(model, frames, dv, reset_every=reset_every, kind=kind)
    monkeypatch.undo()
    return vel, depth, _leaves(box["hidden"])


def _held(got, ref):
    (gv, gd, gh), (rv, rd, rh) = got, ref
    assert gv.shape == rv.shape and gd.shape == rd.shape
    assert np.abs(gv - rv).max() <= ATOL
    assert np.abs(gd - rd).max() <= ATOL
    assert len(gh) == len(rh)
    for g, r in zip(gh, rh):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= ATOL * max(1.0, float(np.abs(r).max()))


def _depth_frames(seed, n, h=24, w=32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (n, h, w)).astype(np.float32),
            rng.uniform(3.0, 5.0, n).astype(np.float32))


def _event_frames(seed, n, h=260, w=346):
    """Signed count frames as difflog quantization gives them: mostly 0,
    some +-1, +-2 (x 0.2)."""
    rng = np.random.default_rng(seed)
    ev = np.round(rng.normal(size=(n, h, w)) * 0.7) * (rng.uniform(size=(n, h, w)) < 0.3)
    return ev.astype(np.float32), rng.uniform(3.0, 5.0, n).astype(np.float32)


@pytest.mark.parametrize("reset_every", [None, 2])
def test_vit_depth_probe_matches_jax(monkeypatch, reset_every):
    tool = jax_tool("openloop_probe")
    frames, dv = _depth_frames(3, 6)
    model, params = tool.build(V_CKPT, "vit_depth")
    ref = _jax_run(tool, monkeypatch, model, params, frames, dv, "vit_depth", reset_every)
    port = openloop_probe.build(V_CKPT, "vit_depth", CPU)
    got = _port_run(port, frames, dv, "vit_depth", reset_every, monkeypatch)
    _held(got, ref)
    assert (got[1] == 0).all() and got[0].shape == (6, 3)


@pytest.mark.parametrize("reset_every", [None, 2])
def test_joint_probe_matches_jax(monkeypatch, reset_every):
    tool = jax_tool("openloop_probe")
    frames, dv = _event_frames(4, 3)
    model, params = tool.build(JOINT_CKPT, "joint")
    ref = _jax_run(tool, monkeypatch, model, params, frames, dv, "joint", reset_every)
    port = openloop_probe.build(JOINT_CKPT, "joint", CPU)
    got = _port_run(port, frames, dv, "joint", reset_every, monkeypatch)
    _held(got, ref)
    assert got[1].shape == (3, 260, 346)


def test_stats_match_jax():
    tool = jax_tool("openloop_probe")
    rng = np.random.default_rng(9)
    for n, active in ((40, True), (12, False)):
        pred = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
        dv = rng.uniform(3.0, 5.0, n).astype(np.float32)
        gt = rng.normal(size=(n, 3)).astype(np.float32) * (1.0 if active else 0.01)
        ref, got = tool.stats(pred, gt, dv), openloop_probe.stats(pred, gt, dv)
        assert list(got) == list(ref)
        for k, r in ref.items():
            if r is None:
                assert got[k] is None, k
            else:
                assert abs(got[k] - r) <= 1e-9, k
    flat = np.zeros((5, 3), np.float32)
    assert openloop_probe.stats(flat, gt[:5], dv[:5])["corr_vy"] == 0.0


def _write_h5(path, T=7, h=24, w=32):
    """Three trajectories in the h5 schema with depth and event frames."""
    import h5py

    rng = np.random.default_rng(12)
    with h5py.File(path, "w") as f:
        for i in range(3):
            data = rng.normal(size=(T, 21))
            desvel = rng.uniform(3.0, 5.0, T)
            g = f.create_group(f"traj_{i:03d}")
            g["data"] = data
            g["depths"] = rng.uniform(0.0, 1.0, (T, h, w)).astype(np.float32)
            g["desvel"] = desvel
            g["evs"] = (np.round(rng.normal(size=(T - 1, h, w))) * 0.2).astype(np.float32)
    return str(path)


def test_main_writes_the_tools_report(tmp_path, monkeypatch, capsys):
    """Both mains on one h5 (vit_depth, the last 2 trajectories, chunk 2):
    the same report keys, trajectories and statistics."""
    h5 = _write_h5(tmp_path / "probe.h5")
    args = ["--ckpt", V_CKPT, "--h5", h5, "--trajs", "2", "--max-frames", "5", "--chunk", "2",
            "--kind", "vit_depth"]
    tool = jax_tool("openloop_probe")
    monkeypatch.setattr(sys, "argv", ["openloop_probe.py", *args,
                                      "--out-json", str(tmp_path / "jax.json")])
    tool.main()
    monkeypatch.undo()
    got = openloop_probe.main([*args, "--out-json", str(tmp_path / "port.json"),
                               "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert port.keys() == ref.keys() and port["trajs"] == got
    assert [r["traj"] for r in port["trajs"]] == ["traj_001", "traj_002"]
    for p, r in zip(port["trajs"], ref["trajs"]):
        assert p.keys() == r.keys()
        for part in ("carried", "chunk_reset"):
            assert p[part].keys() == r[part].keys()
            for k, v in r[part].items():
                assert (p[part][k] is None) == (v is None), k
                if v is not None:
                    assert abs(p[part][k] - v) <= ATOL * max(1.0, abs(v)), (part, k)
        assert p["depth_mae"] is None and r["depth_mae"] is None  # (T,) zeros vs (T, h, w)
        assert p["gt_depth_mean"] == pytest.approx(r["gt_depth_mean"], rel=1e-6)


def test_main_without_h5py_raises_before_building(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    built = []
    monkeypatch.setattr(openloop_probe, "build", lambda *a: built.append(a))
    with pytest.raises(ImportError, match="h5py"):
        openloop_probe.main(["--ckpt", V_CKPT, "--h5", "x.h5", "--device", "cpu"])
    assert not built


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["joint", "vit_depth"])
def test_probe_on_card_matches_cpu(cuda_device, kind):
    """The card's probe (K4 at T = 1 each frame) against the CPU's, carried
    and reset every 2, at full f32 within 1e-4."""
    from evfly_tpu_torch.ops import lstm_fused
    from evfly_tpu_torch.precision import set_precision

    frames, dv = _event_frames(4, 4) if kind == "joint" else _depth_frames(3, 6)
    ckpt = JOINT_CKPT if kind == "joint" else V_CKPT
    card = openloop_probe.build(ckpt, kind, cuda_device)
    cpu = openloop_probe.build(ckpt, kind, CPU)
    set_precision("highest")
    for reset_every in (None, 2):
        lstm_fused.lstm_stacked_cluster.launches = 0
        gv, gd = openloop_probe.run_traj(card, frames, dv, reset_every, kind)
        assert lstm_fused.lstm_stacked_cluster.launches == len(frames)
        rv, rd = openloop_probe.run_traj(cpu, frames, dv, reset_every, kind)
        assert np.abs(gv - rv).max() <= ATOL and np.abs(gd - rd).max() <= ATOL
