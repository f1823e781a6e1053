"""The port's bf16 serving A/B (evfly_tpu_torch/tools/bf16_accept.py)
against the repo's JAX tool (tools/bf16_accept.py), on the CPU.

The JAX tool's two arms are rebuilt with the JAX package at N = 16 (the
tool's ``bf16enc`` cast of ``LSTMNetVIT().init(PRNGKey(0))``, jitted as the
tool jits them) and the port's run on the same weights
(``models.port.from_jax_params``) and inputs.

- The f32 arm within 1e-4.
- The bf16 arm, held where rounding does not decide: bf16 has a unit
  roundoff of 2^-8, and two bf16 codes that round at different places
  differ by about as much as either differs from f32.  XLA's jitted
  encoder and the same encoder run by JAX op by op already differ by
  0.047 at the first block's output (|x| <= 3.2), as much as the port
  does from either, so the end-to-end velocities of two correct bf16 arms
  are not close.  What the JAX package fixes is where each op's dtype
  changes (the promotion points), and that is held exactly:
  * the dtypes at the points, against ``jax.eval_shape`` of the JAX
    model's pieces: the encoder's output bf16; the LSTM's input (the
    encoder's output concatenated with desvel / 10 and the f32 identity
    quaternion) f32; the LSTM's output f32; the velocity f32;
  * the tail from the same bf16 encoder features (JAX's, fed to both):
    concatenation, f32 LSTM and ``nn_fc2`` (an f32 input times its
    bf16-rounded weights, computed in f32) within 1e-5.  This run gives
    7.7e-7; with ``nn_fc2`` computed in bf16 it gives 5.2e-3;
  * the arms' own gap at the same scale as JAX's: the port's mean |dvel|
    within [0.5, 2] x JAX's (0.0077 against 0.0101 here), and the port's
    max |dvel| against JAX's bf16 arm within 2 x JAX's own max |dvel|
    (the triangle bound were the port's noise no larger than JAX's:
    0.033 against 2 x 0.030).
- The printed keys equal the JAX tool's; on JAX's weights at N = 256 the
  port's numbers are within [0.5, 2] x the tool's.
On a card (``gpu``): both arms against the CPU's.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evfly_tpu_torch.graphs import WARMUP_STEPS
from evfly_tpu_torch.models.port import from_jax_params
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.tools import bf16_accept

from torch_tools_cases import jax_tool
from torch_tools_cases import few_torch_threads, keep_precision  # noqa: F401  (fixtures)
from torch_helpers import cuda_device  # noqa: F401  (fixture)

CPU = torch.device("cpu")
N = 16
KEYS = ["windows", "max_abs_dvel_normalized", "mean_abs_dvel_normalized",
        "max_abs_dvel_mps_at_desvel4", "tolerance_normalized", "accept"]


def _jax_bf16enc(params):
    """tools/bf16_accept.py's cast (:38-45)."""
    return {
        k: (v.astype(jnp.bfloat16) if v.dtype == jnp.float32 and not k.startswith("lstm.") else v)
        for k, v in params.items()
    }


@pytest.fixture(scope="module")
def jax_case():
    """The JAX model, its initial params, and its two arms at N = 16."""
    from evfly_tpu.models.vitfly import LSTMNetVIT as JaxLSTMNetVIT
    from evfly_tpu.ops import imageops

    saved = imageops.PRECISION
    imageops.set_precision("default")
    try:
        model = JaxLSTMNetVIT()
        params = model.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        small = jnp.asarray(rng.uniform(0, 1, (N, 1, 60, 90)), jnp.float32)
        desvel = jnp.full((N, 1), 4.0, jnp.float32)
        f32 = jax.jit(lambda p, s, d: model.apply(p, [s, d, None, None])[0])
        b16 = jax.jit(lambda p, s, d: model.apply(
            _jax_bf16enc(p), [s.astype(jnp.bfloat16), d, None, None])[0])
        vf = np.asarray(f32(params, small, desvel))
        vb = np.asarray(b16(params, small, desvel))
        enc = jax.jit(model._encode)(_jax_bf16enc(params), small.astype(jnp.bfloat16))
    finally:
        imageops.PRECISION = saved
    return dict(model=model, params=params, vf=vf, vb=vb, enc=enc, small=small, desvel=desvel)


def _port_model(params, device=CPU):
    weights = from_jax_params({k: np.asarray(v) for k, v in params.items()}, device)
    return LSTMNetVIT(device=device).load_params(weights).eval()


def test_inputs_match_the_tool(jax_case):
    small, desvel = bf16_accept.inputs(N, CPU)
    np.testing.assert_array_equal(small.numpy(), np.asarray(jax_case["small"]))
    np.testing.assert_array_equal(desvel.numpy(), np.asarray(jax_case["desvel"]))


def test_f32_arm_matches_jax(jax_case):
    vf, _ = bf16_accept.arms(_port_model(jax_case["params"]), *bf16_accept.inputs(N, CPU))
    assert vf.dtype == torch.float32
    assert np.abs(vf.numpy() - jax_case["vf"]).max() <= 1e-4


def test_bf16enc_casts_what_the_tool_casts(jax_case):
    model = _port_model(jax_case["params"])
    cast = bf16_accept.bf16enc(model)
    want = _jax_bf16enc(jax_case["params"])
    state = cast.state_dict()
    assert state.keys() == want.keys()
    for k, v in want.items():
        assert str(state[k].dtype).removeprefix("torch.") == str(v.dtype), k
        np.testing.assert_array_equal(state[k].float().numpy(), np.asarray(v, np.float32),
                                      err_msg=k)
    assert all(p.dtype == torch.float32 for p in model.parameters())  # the source stays f32


def test_bf16_arm_promotion_points_match_jax(jax_case):
    """The dtypes where JAX's promotion changes them, port against
    jax.eval_shape of the JAX model's pieces."""
    from evfly_tpu.models.common import sub
    from evfly_tpu.models.recurrent import lstm_apply
    from evfly_tpu.models.vitfly import _speclin

    jm, bp = jax_case["model"], _jax_bf16enc(jax_case["params"])
    small = jax_case["small"].astype(jnp.bfloat16)
    enc = jax.eval_shape(jm._encode, bp, small)
    quat = jnp.zeros((N, 4), jnp.float32)
    lstm_in = jax.eval_shape(lambda e, d: jnp.concatenate([e, d / 10.0, quat], 1), enc,
                             jax_case["desvel"])
    lstm_out = jax.eval_shape(lambda p, x: lstm_apply(sub(p, "lstm"), x, None, 3, 128)[0],
                              bp, lstm_in)
    vel = jax.eval_shape(lambda p, x: _speclin(p, "nn_fc2", x), bp, lstm_out)
    want = [str(t.dtype) for t in (enc, lstm_in, lstm_out, vel)]
    assert want == ["bfloat16", "float32", "float32", "float32"]

    model = bf16_accept.bf16enc(_port_model(jax_case["params"]))
    seen = {}
    hooks = [model.decoder.register_forward_hook(
                 lambda m, a, out: seen.__setitem__("enc", out.dtype)),
             model.lstm.register_forward_hook(
                 lambda m, a, out: seen.update(lstm_in=a[0].dtype, lstm_out=out[0].dtype))]
    small_t, desvel_t = bf16_accept.inputs(N, CPU)
    with torch.inference_mode():
        out = model(small_t.to(torch.bfloat16), desvel_t)[0]
    for h in hooks:
        h.remove()
    got = [str(seen[k]).removeprefix("torch.") for k in ("enc", "lstm_in", "lstm_out")]
    assert got + [str(out.dtype).removeprefix("torch.")] == want


def test_bf16_arm_tail_matches_jax(jax_case, monkeypatch):
    """From the same bf16 encoder features (JAX's), the rest of the bf16
    arm within 1e-5."""
    from evfly_tpu.models.common import sub
    from evfly_tpu.models.recurrent import lstm_apply
    from evfly_tpu.models.vitfly import _speclin, refine_inputs

    bp = _jax_bf16enc(jax_case["params"])

    def tail(p, enc, d):
        X = refine_inputs([jnp.zeros((N, 1, 60, 90), jnp.bfloat16), d, None, None])
        out = jnp.concatenate([enc, X[1] / 10.0, X[2]], axis=1)
        out, _ = lstm_apply(sub(p, "lstm"), out, None, num_layers=3, hidden_size=128)
        return _speclin(p, "nn_fc2", out)

    ref = np.asarray(jax.jit(tail)(bp, jax_case["enc"], jax_case["desvel"]))
    model = bf16_accept.bf16enc(_port_model(jax_case["params"]))
    enc = torch.from_numpy(np.array(jax_case["enc"].astype(jnp.float32))).to(torch.bfloat16)
    monkeypatch.setattr(model, "_encode", lambda x: enc)
    small, desvel = bf16_accept.inputs(N, CPU)
    with torch.inference_mode():
        got = model(small.to(torch.bfloat16), desvel)[0]
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5


def test_bf16_arms_gap_at_jax_scale(jax_case):
    vf, vb = bf16_accept.arms(_port_model(jax_case["params"]), *bf16_accept.inputs(N, CPU))
    vf, vb = vf.numpy(), vb.numpy()
    jax_gap = np.abs(jax_case["vf"] - jax_case["vb"])
    port_gap = np.abs(vf - vb)
    assert 0.5 <= port_gap.mean() / jax_gap.mean() <= 2.0
    assert np.abs(vb - jax_case["vb"]).max() <= 2.0 * jax_gap.max()


def test_report_matches_jax_tool(jax_case, capsys):
    """The JAX tool's main (N = 256, its weights) against the port's arms on
    the same weights: the same keys, windows and tolerance; the deltas at
    the same scale."""
    import evfly_tpu.ops.imageops as imageops

    tool = jax_tool("bf16_accept")
    saved = (jax.config.jax_compilation_cache_dir, imageops.PRECISION)
    try:
        tool.main()  # sets jax_compilation_cache_dir and the JAX precision itself
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        imageops.PRECISION = saved[1]
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bf16_accept.accept_report(*bf16_accept.arms(
        _port_model(jax_case["params"]), *bf16_accept.inputs(bf16_accept.WINDOWS, CPU)))
    assert list(got) == list(ref) == KEYS
    assert got["windows"] == ref["windows"] == 256
    assert got["tolerance_normalized"] == ref["tolerance_normalized"]
    for k in KEYS[1:4]:
        assert 0.5 <= got[k] / ref[k] <= 2.0, k
    assert got["accept"] == (got["max_abs_dvel_normalized"] <= got["tolerance_normalized"])


def test_linear_promotes_mixed_dtypes():
    """ops.imageops.linear computes in the promoted dtype, as jnp.matmul
    promotes: an f32 input times bf16 weights in f32; bf16 alone stays bf16."""
    import torch.nn.functional as F
    from evfly_tpu_torch.ops.imageops import linear

    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 7, generator=g)
    w = torch.randn(3, 7, generator=g).to(torch.bfloat16)
    b = torch.randn(3, generator=g).to(torch.bfloat16)
    out = linear(x, w, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, F.linear(x, w.float(), b.float()))
    assert linear(x.to(torch.bfloat16), w, b).dtype == torch.bfloat16
    assert torch.equal(linear(x, w.float()), F.linear(x, w.float()))


def test_cli_prints_one_json_line(capsys):
    out = bf16_accept.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out and list(out) == KEYS
    assert out["windows"] == 256 and np.isfinite(out["max_abs_dvel_normalized"])


@pytest.mark.gpu
def test_arms_on_card_match_cpu(cuda_device):
    """Both arms on the card (the LSTM through K4 at T = 256) against the
    CPU's, at full f32: the f32 arm within 1e-4; the bf16 arm within 2 x
    the CPU arms' own max |dvel| (cuDNN's and the CPU's bf16 kernels round
    apart, as XLA's and torch's do)."""
    from evfly_tpu_torch.ops import lstm_fused
    from evfly_tpu_torch.precision import set_precision

    set_precision("highest")
    cpu = LSTMNetVIT(device=CPU)
    card = LSTMNetVIT(device=cuda_device).load_params(cpu.state_dict())
    rf, rb = bf16_accept.arms(cpu, *bf16_accept.inputs(bf16_accept.WINDOWS, CPU))
    lstm_fused.lstm_stacked_cluster.launches = 0
    gf, gb = bf16_accept.arms(card, *bf16_accept.inputs(bf16_accept.WINDOWS, cuda_device))
    # each arm served by its own CUDA graph: K4 at two warm-up calls and the capture
    assert lstm_fused.lstm_stacked_cluster.launches == 2 * (WARMUP_STEPS + 1)
    assert sum(card.serve_stats.captures.values()) == 1
    assert (gf.cpu() - rf).abs().max().item() <= 1e-4
    assert (gb.cpu() - rb).abs().max().item() <= 2.0 * (rf - rb).abs().max().item()
