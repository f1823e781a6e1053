"""The port's overfit probe (evfly_tpu_torch/tools/overfit_probe.py) against
the repo's JAX tool (tools/overfit_probe.py), on the CPU on a tiny h5
dataset.

At lr 0, Adam leaves the weights where they start, so the JAX tool's
``main`` ends with the parameters of ``LSTMNetVIT().init(PRNGKey(0))``
after one spectral-norm power iteration, which the port's step takes too;
the port's probe starts from those initial parameters (carried across with
``models.port.from_jax_params``).  Then:
- ``floor_mse`` (the data alone) equals JAX's to 1e-6 relative;
- ``pred_vy_std`` and ``corr_vy`` (the final open-loop check, eval mode)
  agree within 1e-4;
- ``final_vel_mse`` is the loss of the training forward, whose LSTM
  dropout JAX draws from ``PRNGKey(1)`` and the port from a
  ``torch.Generator``: other draws, so it is only held finite.
A padded last chunk (6 frames in chunks of 4) gives the same batches and
frame masks as the JAX tool builds (its step recorded, unjitted).
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

import jax

from evfly_tpu_torch.models.port import from_jax_params
from evfly_tpu_torch.tools import overfit_probe

from torch_tools_cases import jax_tool
from torch_tools_cases import few_torch_threads, keep_precision  # noqa: F401  (fixtures)

CPU = torch.device("cpu")
H, W = 24, 32  # resized to 60x90 inside LSTMNetVIT
KEYS = ["floor_mse", "final_vel_mse", "pred_vy_std", "corr_vy", "overfit_ok"]


def _write_h5(path, T=9):
    """Two trajectories of T frames in the h5 schema: an expert dodging
    left and right (vy a sine), desvel 3-5 m/s, depths in [0, 1]."""
    import h5py

    rng = np.random.default_rng(5)
    with h5py.File(path, "w") as f:
        for i in range(2):
            data = rng.normal(size=(T, 21))
            desvel = rng.uniform(3.0, 5.0, T)
            data[:, 13] = desvel * rng.uniform(0.8, 1.0, T)
            data[:, 14] = np.sin(np.arange(T) * 0.9 + i) * 1.5
            data[:, 15] = rng.uniform(-0.2, 0.2, T)
            g = f.create_group(f"traj_{i:03d}")
            g["data"] = data
            g["depths"] = rng.uniform(0.0, 1.0, (T, H, W)).astype(np.float32)
            g["desvel"] = desvel
    return str(path)


def _printed_json(text: str) -> dict:
    """The indented JSON object the tools print last."""
    return json.loads(text[text.rindex("\n{") + 1:])


def _jax_init_params():
    from evfly_tpu.models.vitfly import LSTMNetVIT

    params = LSTMNetVIT().init(jax.random.PRNGKey(0))
    return from_jax_params({k: np.asarray(v) for k, v in params.items()}, CPU)


def test_overfit_probe_matches_jax_at_lr0(tmp_path, monkeypatch, capsys):
    h5 = _write_h5(tmp_path / "one.h5")
    args = ["--h5", h5, "--steps", "1", "--frames", "8", "--chunk", "8", "--lr", "0"]
    tool = jax_tool("overfit_probe")
    monkeypatch.setattr(sys, "argv", ["overfit_probe.py", *args])
    tool.main()
    ref = _printed_json(capsys.readouterr().out)

    traj = overfit_probe.read_trajectory(h5, -1)
    got = overfit_probe.overfit(traj, steps=1, frames=8, chunk=8, lr=0.0, device=CPU,
                                params=_jax_init_params(), log=lambda m: None)
    assert list(overfit_probe.report(got)) == list(ref) == KEYS
    assert got["floor_mse"] == pytest.approx(ref["floor_mse"], rel=1e-6)
    assert abs(got["pred_vy_std"] - ref["pred_vy_std"]) <= 1e-4
    assert abs(got["corr_vy"] - ref["corr_vy"]) <= 1e-4
    assert ref["pred_vy_std"] > 1e-6  # the correlation is computed, not the 0 fallback
    assert np.isfinite(got["final_vel_mse"]) and isinstance(got["overfit_ok"], bool)
    assert got["vel"].shape == (8, 3) and (got["vel"][:, 2] == 0).all()


def test_overfit_probe_cli_prints_the_tools_keys(tmp_path, capsys):
    h5 = _write_h5(tmp_path / "one.h5")
    out = overfit_probe.main(["--h5", h5, "--steps", "2", "--frames", "8", "--chunk", "4",
                              "--traj-idx", "0", "--device", "cpu"])
    printed = _printed_json(capsys.readouterr().out)
    assert printed == out and list(printed) == KEYS
    assert all(np.isfinite(printed[k]) for k in KEYS[:4])


@pytest.mark.parametrize("frames,chunk,steps", [(6, 4, 3), (8, 8, 2)])
def test_overfit_batches_match_jax(tmp_path, monkeypatch, capsys, frames, chunk, steps):
    """The chunks the JAX tool feeds its step, cycled by s % len(chunks),
    the last zero-padded with desvel 1.0 and the frame mask, against the
    port's ``chunk_batches``; and the floor of the same frames."""
    import evfly_tpu.train.stepfn as j_stepfn

    h5 = _write_h5(tmp_path / "one.h5")
    seen = []

    def fake_make_train_step(*args, **kwargs):
        def step(params, opt_state, batch, key):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            return params, opt_state, 0.0, np.zeros(2, np.float32), 0.0
        return step

    def fake_apply_for_loss(model, kind, params, inp, dv, train, rng):
        return np.zeros((inp.shape[0], 3), np.float32), None, None

    tool = jax_tool("overfit_probe")
    monkeypatch.setattr(j_stepfn, "make_train_step", fake_make_train_step)
    monkeypatch.setattr(j_stepfn, "apply_for_loss", fake_apply_for_loss)
    monkeypatch.setattr(tool, "jax", types.SimpleNamespace(jit=lambda f: f, random=jax.random))
    monkeypatch.setattr(sys, "argv", ["overfit_probe.py", "--h5", h5, "--steps", str(steps),
                                      "--frames", str(frames), "--chunk", str(chunk)])
    tool.main()
    ref = _printed_json(capsys.readouterr().out)

    x, gt_vel, dv, _nvy, floor = overfit_probe.probe_frames(
        overfit_probe.read_trajectory(h5, -1), frames)
    assert floor == pytest.approx(ref["floor_mse"], rel=1e-6)
    batches = overfit_probe.chunk_batches(x, dv, gt_vel, chunk, CPU)
    assert len(seen) == steps
    for s, want in enumerate(seen):
        got = batches[s % len(batches)]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    if frames % chunk:
        assert batches[-1]["mask"].sum() == frames % chunk
        assert (batches[-1]["desvel"][frames % chunk:] == 1.0).all()
