"""The port's utilities and file tools against the JAX package's and the
repo's, on the CPU: checkpoint_surgery and tools/extract_combine.py give
equal state dicts; search_logs and recording_to_gif are copies (the same
code under their docstrings, and the same output); StageTimer's summary
equal for the same samples; and the HIL driver (tools/hil_real_model.py):
its render sensor's events against the JAX driver's under the render's
margin rule, one short episode of policy_best.pth with the JAX report's
keys.
"""

import ast
import functools
import json
import re
import sys

import h5py
import numpy as np
import pytest
import torch

import evfly_tpu.sim.render as j_render
from evfly_tpu.utils import checkpoint_surgery as j_surgery
from evfly_tpu.utils import profiling as j_profiling
from evfly_tpu.utils import recording_to_gif as j_gif
from evfly_tpu.utils import search_logs as j_search
import evfly_tpu_torch.sim.render as t_render
from evfly_tpu_torch.ops.voxelizer import difflog_margins
from evfly_tpu_torch.tools import extract_combine, hil_real_model
from evfly_tpu_torch.utils import checkpoint_surgery, profiling, recording_to_gif, search_logs

from torch_tools_cases import REPO, jax_tool
from torch_tools_cases import few_torch_threads, keep_precision  # noqa: F401  (fixtures)

CPU = torch.device("cpu")


def _code(path):
    """The module's code without its docstring, as an AST dump."""
    tree = ast.parse(path.read_text())
    return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))


@pytest.mark.parametrize("name", ["search_logs", "recording_to_gif"])
def test_copy_keeps_the_code(name):
    port = REPO / "evfly_tpu_torch" / "utils" / f"{name}.py"
    assert _code(port) == _code(REPO / "evfly_tpu" / "utils" / f"{name}.py")
    assert f"A copy of ``evfly_tpu/utils/{name}.py``" in ast.get_docstring(
        ast.parse(port.read_text()))


def _joint_pth(path):
    g = torch.Generator().manual_seed(0)
    sd = {f"origunet.{k}": torch.randn(3, 2, generator=g) for k in ("a.weight", "b.bias")}
    sd.update({f"vitfly_vitlstm.{k}": torch.randn(4, generator=g) for k in ("c.weight", "d")})
    sd["origunet.bn.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, path)
    return sd


def _same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_extract_combine_match_jax(tmp_path, monkeypatch):
    jtool = jax_tool("extract_combine")
    sd = _joint_pth(tmp_path / "joint.pth")
    for side, run in (("j", lambda argv: (monkeypatch.setattr(sys, "argv", ["x"] + argv),
                                          jtool.main())),
                      ("t", extract_combine.main)):
        joint, d, v, c = (str(tmp_path / f) for f in ("joint.pth", f"d_{side}.pth",
                                                      f"v_{side}.pth", f"c_{side}.pth"))
        run(["extract", "--joint", joint, "--out", d])
        run(["extract", "--joint", joint, "--prefix", "vitfly_vitlstm.", "--out", v])
        run(["combine", "--d", d, "--v", v, "--out", c])
    for name in ("d", "v", "c"):
        _same(torch.load(tmp_path / f"{name}_t.pth"), torch.load(tmp_path / f"{name}_j.pth"))
    combined = torch.load(tmp_path / "c_t.pth")
    _same(combined, {k: sd[k] for k in combined})  # D's keys first, then V's
    assert combined.keys() == sd.keys()
    with pytest.raises(AssertionError, match="no keys"):
        extract_combine.main(["extract", "--joint", str(tmp_path / "joint.pth"), "--prefix",
                              "nope.", "--out", str(tmp_path / "x.pth")])


@pytest.mark.parametrize("argv", [
    ["--old_key", "origunet.a.weight", "--new_key", "origunet.z.weight"],
    ["--old_prefix", "origunet.", "--new_prefix", ""],
    ["--old_key", "missing", "--new_key", "x", "--old_prefix", "vitfly_vitlstm.",
     "--new_prefix", "head."],
    [],
], ids=["key", "prefix", "missing_key_and_prefix", "inspect"])
def test_checkpoint_surgery_matches_jax(tmp_path, monkeypatch, capsys, argv):
    _joint_pth(tmp_path / "m.pth")
    base = ["--pth_file", str(tmp_path / "m.pth")]
    monkeypatch.setattr(sys, "argv", ["x", *base, *argv, "--save", str(tmp_path / "j.pth")])
    j_surgery.main()
    out_j = capsys.readouterr().out
    sd = checkpoint_surgery.main([*base, *argv, "--save", str(tmp_path / "t.pth")])
    out_t = capsys.readouterr().out
    # the JAX package loads arrays, the port tensors: the same keys and shapes
    norm = lambda out: re.sub(r": \w+ - (torch\.Size\(\[[\d, ]*\]\)|\([\d, ]*\))",
                              lambda m: f": {tuple(map(int, re.findall(r'\d+', m[1])))}", out)
    assert norm(out_t.replace("t.pth", "j.pth")) == norm(out_j)
    _same(torch.load(tmp_path / "t.pth"), torch.load(tmp_path / "j.pth"))
    _same(sd, torch.load(tmp_path / "j.pth"))


def test_search_logs_same_hits(tmp_path):
    for i, text in enumerate(["lr = 0.001\nmodel = A", "lr = 0.01\nmodel = A", "model = B"]):
        d = tmp_path / f"d{i}"
        d.mkdir()
        (d / ("config.txt" if i != 1 else "args.txt")).write_text(text)
    (tmp_path / "stray.txt").write_text("model = A")
    for strings in (["model = A"], ["lr", "A"], ["model"], ["nothing"]):
        assert (search_logs.search_log_dirs(str(tmp_path), strings)
                == j_search.search_log_dirs(str(tmp_path), strings))
    assert search_logs.search_log_dirs(str(tmp_path), ["model = A"]) == ["d0", "d1"]


def test_recording_to_gif_same_frames(tmp_path):
    imageio = pytest.importorskip("imageio")
    rng = np.random.default_rng(0)
    with h5py.File(tmp_path / "rec.h5", "w") as f:
        g = f.create_group("rollout_0000")
        g.create_dataset("evs", data=rng.normal(size=(4, 12, 16)).astype(np.float32))
        g.create_dataset("ims", data=rng.uniform(size=(4, 12, 16)).astype(np.float32))
        data = np.zeros((4, 21), np.float32)
        data[:, 1] = np.arange(4) / 10.0
        g.create_dataset("data", data=data)
    for channel in ("evs", "ims"):
        outs = []
        for mod, side in ((j_gif, "j"), (recording_to_gif, "t")):
            out = mod.recording_to_gif(str(tmp_path / "rec.h5"), str(tmp_path / f"{side}.gif"),
                                       channel=channel, save_ims=str(tmp_path / f"{side}_ims"))
            outs.append(np.stack(imageio.mimread(out)))
        np.testing.assert_array_equal(outs[0], outs[1])
        assert outs[0].shape[0] == 4
        for i in range(4):
            assert ((tmp_path / f"t_ims/{i:06d}.png").read_bytes()
                    == (tmp_path / f"j_ims/{i:06d}.png").read_bytes())


def test_stage_timer_summary_equal():
    rng = np.random.default_rng(1)
    jt, tt = j_profiling.StageTimer(), profiling.StageTimer()
    for name in ("render", "policy", "dynamics"):
        for v in rng.uniform(1e-4, 2e-2, size=7):
            jt.record(name, float(v))
            tt.record(name, float(v))
    assert tt.summary() == jt.summary()
    assert tt.report() == jt.report()
    with tt.stage("block", sync_value=torch.zeros(2)):
        pass
    with tt.stage("block", sync_value=[torch.zeros(1), torch.device("cpu")]):
        pass
    assert tt.summary()["block"]["count"] == 2


def test_profiling_on_cpu(tmp_path, monkeypatch):
    x = torch.randn(64, 64)
    assert profiling.timed_device_fn(torch.mm, x, x, n_iters=3, device="cpu") > 0
    with profiling.profiler_trace(str(tmp_path / "trace"), device="cpu"):
        torch.mm(x, x)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.timed_device_fn(torch.mm, x, x)


HIL_H, HIL_W = 40, 52


def test_hil_sensor_matches_jax(monkeypatch):
    """Both drivers' render sensors at 40x52 over six positions: the event
    bursts as signed count frames, equal wherever neither render is
    within RENDER_MARGIN of an edge and the difflog quotient lies farther
    than 1e-5 from a crossing."""
    jhil = jax_tool("hil_real_model")
    monkeypatch.setattr(j_render, "render_depth_intensity",
                        functools.partial(j_render.render_depth_intensity, H=HIL_H, W=HIL_W))
    monkeypatch.setattr(t_render, "render_depth_intensity",
                        functools.partial(t_render.render_depth_intensity, H=HIL_H, W=HIL_W))
    from evfly_tpu_torch.sim import generate_forest

    field = generate_forest(np.random.default_rng(77), num_obstacles=30, trees=True)
    centers = np.full((48, 3), 1e6, np.float32)
    radii = np.zeros(48, np.float32)
    centers[: len(field)], radii[: len(field)] = field.positions, field.radii
    js, ts = jhil.make_render_sensor(centers, radii), hil_real_model.make_render_sensor(
        centers, radii, device=CPU)
    prev, n_events = None, 0
    for k in range(6):
        pos = np.array([3.0 + 0.27 * k, 0.05 * k, 2.0], np.float32)
        frames = []
        for sensor in (js, ts):
            x, y, p = sensor(pos, k / 15.0)
            f = np.zeros((HIL_H, HIL_W), np.int64)
            np.add.at(f, (y, x), p)
            frames.append(f)
        ok = (t_render.render_margins(pos, centers, radii, H=HIL_H, W=HIL_W, is_trees=True,
                                      device=CPU) >= t_render.RENDER_MARGIN).numpy()
        _, inten = t_render.render_depth_intensity(pos, centers, radii, is_trees=True, device=CPU)
        if prev is not None:
            pos0, ok0, inten0 = prev
            keep = ok & ok0 & (difflog_margins(inten, inten0, device=CPU).numpy() >= 1e-5)
            np.testing.assert_array_equal(frames[1][keep], frames[0][keep])
            n_events += int(np.abs(frames[1]).sum())
        prev = (pos, ok, inten)
    assert n_events > 0


def test_hil_episode_on_cpu():
    """A 0.4 s episode (6 ticks) of policy_best.pth on the CPU at
    260x346: the JAX report's keys, finite numbers, forward motion."""
    report = hil_real_model.main(["--ckpt", str(REPO / "artifacts" / "policy_best.pth"),
                                  "--duration", "0.4", "--device", "cpu"])
    ref = json.loads((REPO / "artifacts" / "hil_real.json").read_text())
    assert list(report) == list(ref)
    assert report["ticks"] == 6 and report["final_x_m"] > 0.0
    assert all(np.isfinite(v) for v in report.values() if isinstance(v, float))
