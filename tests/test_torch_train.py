"""The port's training pieces against the JAX package, on the CPU.

``evfly_tpu_torch.train.losses``, the batch slicer of
``evfly_tpu_torch.train.stepfn``, ``evfly_tpu_torch.data.augment``, the
spectral-norm power iteration, the config copy and the model registry, each
held against its counterpart in ``evfly_tpu`` on the same seeded numpy
inputs and params.  The train and eval steps per model kind are in
tests/test_torch_train_step.py and tests/test_torch_train_joint.py.

Tolerances, stated per check:
- losses and masked means: rtol 1e-6 (the same f32 sums);
- the power iteration: 1e-6 (two small matvecs and norms);
- the warp alone: 1e-5; the gated transforms: 3e-5 (the warp's f32
  rounding, then a scale of up to 3);
- the batch slicer: exact (the same casts and divisions).

One ``gpu`` test (``tests/run_gpu_tests.py`` runs it on the card): V(phi)'s
train step on the card against the CPU, with chip_smoke.py's bounds for the
joint model's: the loss, terms and gradient norm within 1e-4 relative, each
gradient within 1e-4 x the largest |gradient| of its leaf, Adam's update
p_after - p_before of each element within 1e-6 plus one f32 ulp of p (2 lr
where |g| is at most 100 x its leaf's largest gradient disagreement and
either gradient is nonzero) and u, v within 1e-5; then its eval step
launching K4 once.
"""

import pathlib
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evfly_tpu.configs import EvflyConfig as JaxEvflyConfig
from evfly_tpu.configs import parse_config_file as jax_parse_config_file
from evfly_tpu.data import augment as jaug
from evfly_tpu.models import registry as jax_registry
from evfly_tpu.models.common import param_count as jax_param_count
from evfly_tpu.models.vitfly import LSTMNetVIT as JaxLSTMNetVIT
from evfly_tpu.ops import imageops as jimageops
from evfly_tpu.train import losses as jlosses
from evfly_tpu.train import stepfn as jstepfn
from evfly_tpu_torch.configs import EvflyConfig, config_device, parse_config_file
from evfly_tpu_torch.data import augment
from evfly_tpu_torch.models import registry
from evfly_tpu_torch.models.common import param_count
from evfly_tpu_torch.models.port import from_jax_params
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.ops import imageops
from evfly_tpu_torch.train import losses, stepfn
from evfly_tpu_torch.ops.lstm_fused import lstm_stacked_cluster
from evfly_tpu_torch.stream.pipeline import WARMUP_STEPS
from torch_helpers import cuda_device  # noqa: F401 (fixture)

UNET_HW = (190, 190)  # the smallest frame the 5-level valid-padding UNet takes

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG_FILES = sorted((REPO / "evfly_tpu" / "configs" / "files").glob("*.txt"))



# ----------------------------------------------------------------- losses

def _loss_inputs(seed, n=6, n_valid=4, hw=(5, 7)):
    rng = np.random.default_rng(seed)
    gt_vel = rng.normal(size=(n, 3)).astype(np.float32)
    gt_vel[0, 1:] = 0.0  # a frame with zero y and z commands
    pred_vel = rng.normal(size=(n, 3)).astype(np.float32)
    gt_d = rng.random((n, 1, *hw)).astype(np.float32)
    gt_d[1, 0, :2] = 1.0  # pixels at or above 0.99
    pred_d = rng.random((n, 1, *hw)).astype(np.float32)
    mask = (np.arange(n) < n_valid).astype(np.float32)
    return gt_vel, pred_vel, gt_d, pred_d, mask


@pytest.mark.parametrize("olp", [[0.0, 0.0], [5.0, 0.0], [0.0, -1.0], [5.0, -1.0],
                                 [5.0, -2.0], [3.0, 2.0], None])
@pytest.mark.parametrize("weights", [[10.0, 1.0], None])
def test_combined_loss_matches_jax_with_padded_frames(olp, weights):
    gv, pv, gd, pd, mask = _loss_inputs(1)
    ref_total, ref_values = jlosses.combined_loss(
        [jnp.asarray(gv), jnp.asarray(gd)], [jnp.asarray(pv), jnp.asarray(pd)],
        jnp.asarray(mask), weights, olp)
    t = torch.from_numpy
    total, values = losses.combined_loss([t(gv), t(gd)], [t(pv), t(pd)], t(mask), weights, olp)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-6)
    for got, ref in zip(values, ref_values):
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("fn", ["velocity_loss", "vision_loss"])
@pytest.mark.parametrize("param", [0.0, 5.0, -1.0, -2.0, 0.5])
def test_loss_term_and_logged_value_match_jax(fn, param):
    """The backprop term and the logged value, each as JAX's; they differ
    whenever the param is nonzero and a frame or pixel is weighted."""
    gv, pv, gd, pd, mask = _loss_inputs(2)
    gt, pred = (gv, pv) if fn == "velocity_loss" else (gd, pd)
    ref_term, ref_value = getattr(jlosses, fn)(jnp.asarray(gt), jnp.asarray(pred),
                                               jnp.asarray(mask), param)
    term, value = getattr(losses, fn)(torch.from_numpy(gt), torch.from_numpy(pred),
                                      torch.from_numpy(mask), param)
    np.testing.assert_allclose(term.item(), float(ref_term), rtol=1e-6)
    np.testing.assert_allclose(value.item(), float(ref_value), rtol=1e-6)
    if param != 0.0 and fn == "velocity_loss":
        assert term.item() != value.item()


def test_masked_mean_is_exact_over_valid_frames():
    gv, pv, gd, pd, mask = _loss_inputs(3)
    err = (gd - pd) ** 2
    got = losses._masked_mean(torch.from_numpy(err), torch.from_numpy(mask)).item()
    np.testing.assert_allclose(got, err[mask > 0].mean(), rtol=1e-6)
    ref = float(jlosses._masked_mean(jnp.asarray(err), jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # all frames padded: 0, not a division by zero
    zero = losses._masked_mean(torch.from_numpy(err), torch.zeros(len(mask)))
    assert zero.item() == 0.0


# ------------------------------------------------------- spectral update

@pytest.mark.parametrize("shape,n_iters", [((512, 4608), 1), ((3, 128), 1), ((12, 48, 3, 3), 2)])
def test_spectral_power_iteration_matches_jax(shape, n_iters):
    rng = np.random.default_rng(4)
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    u = rng.normal(size=shape[0]).astype(np.float32)
    v = rng.normal(size=int(np.prod(shape[1:]))).astype(np.float32)
    u, v = u / np.linalg.norm(u), v / np.linalg.norm(v)
    ju, jv = jimageops.spectral_norm_power_iteration(jnp.asarray(w), jnp.asarray(u),
                                                     jnp.asarray(v), n_iters)
    tu, tv = imageops.spectral_norm_power_iteration(torch.from_numpy(w), torch.from_numpy(u),
                                                    torch.from_numpy(v), n_iters)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def test_spectral_updates_match_jax_and_write_the_buffers():
    jm = JaxLSTMNetVIT()
    jparams = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(3)).items()}
    ref = jstepfn.spectral_updates({k: jnp.asarray(v) for k, v in jparams.items()})
    model = LSTMNetVIT(device="cpu").load_params(from_jax_params(jparams, "cpu"))
    got = stepfn.spectral_updates(model.state_dict())
    assert sorted(got) == sorted(ref) == sorted(
        ["decoder.weight_u", "decoder.weight_v", "nn_fc2.weight_u", "nn_fc2.weight_v"])
    stepfn.spectral_update_(model)
    state = model.state_dict()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-6)
        np.testing.assert_array_equal(state[k].numpy(), got[k].numpy())
    assert not any(name.endswith(("weight_u", "weight_v")) for name, _ in model.named_parameters())


# ----------------------------------------------------------- augmentation

def _aug_inputs(seed, n=3, hw=(26, 34)):
    rng = np.random.default_rng(seed)
    inp = np.clip(rng.normal(size=(n, 1, *hw)) * 0.5, -1, 1).astype(np.float32)
    gts = rng.random((n, 1, *hw)).astype(np.float32)
    vels = rng.normal(size=(n, 3)).astype(np.float32)
    return inp, vels, gts


@pytest.mark.parametrize("angle_deg,zoom", [(12.5, 0.8), (-19.0, 0.7), (0.0, 1.0), (7.0, 1.0)])
def test_affine_warp_matches_jax(angle_deg, zoom):
    inp, _, _ = _aug_inputs(5)
    a = np.float32(angle_deg * np.pi / 180.0)
    ref = jaug._affine_rotate_zoom(jnp.asarray(inp), jnp.asarray(a), jnp.asarray(np.float32(zoom)))
    got = augment._affine_rotate_zoom(torch.from_numpy(inp), torch.tensor(a),
                                      torch.tensor(np.float32(zoom)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("angle_deg", [-20.0, -5.0, 0.0, 3.3, 20.0])
def test_valid_zoom_matches_jax(angle_deg):
    a = np.float32(angle_deg * 3.14 / 180.0)
    for hw in [(260, 346), (60, 90)]:
        ref = jaug._valid_zoom(jnp.asarray(a), *hw)
        got = augment._valid_zoom(torch.tensor(a), *hw)
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


class _FixedDraws:
    """A stand-in for ``jax.random`` inside ``evfly_tpu.data.augment``: each
    key names one draw, so JAX's ``augment_chunk`` runs with the port's
    draws ``p`` (uniform gates, angle, scale, noise, polarity signs)."""

    def __init__(self, p):
        self.p = p

    def split(self, key, n):
        return ["rot_gate", "rot", "flip", "scale_gate", "scale", "noise_gate", "noise",
                "pol_gate", "pol"]

    def uniform(self, key, shape=(), minval=0.0, maxval=1.0):
        name = {"rot_gate": "rot_u", "rot": "angle_deg", "flip": "flip_u",
                "scale_gate": "scale_u", "scale": "scale", "noise_gate": "noise_u",
                "pol_gate": "pol_u"}[key]
        return jnp.asarray(self.p[name].numpy())

    def normal(self, key, shape):
        return jnp.asarray(self.p["noise"].numpy()) / augment.NOISE_STD

    def choice(self, key, a, shape):
        return jnp.asarray(self.p["signs"].numpy())


@pytest.mark.parametrize("num_out_channels", [1, 2])
@pytest.mark.parametrize("fire", [
    (), ("rot_u",), ("flip_u",), ("scale_u",), ("noise_u",), ("pol_u",),
    ("rot_u", "flip_u", "scale_u", "noise_u", "pol_u"),
])
def test_each_transform_at_fixed_draws_matches_jax(monkeypatch, fire, num_out_channels):
    """Rotation and zoom, flip with y negation, scale with its clip, noise,
    polarity (and their reach into event ground truth), each gate fired
    alone and all together."""
    inp, vels, gts = _aug_inputs(6)
    if num_out_channels == 2:
        gts = np.clip(gts * 2 - 1, -1, 1).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    p = augment.draw_params(gen, inp.shape[0], inp.shape[1:], "cpu")
    for gate in ("rot_u", "flip_u", "scale_u", "noise_u", "pol_u"):
        p[gate] = torch.tensor(0.01 if gate in fire else 0.99)
    p["angle_deg"], p["scale"] = torch.tensor(-13.0), torch.tensor(3.0)
    p["signs"] = torch.tensor([-1.0, 1.0, -1.0]).reshape(3, 1, 1, 1)
    monkeypatch.setattr(jaug, "jax", types.SimpleNamespace(random=_FixedDraws(p)))
    ref = jaug.augment_chunk(None, jnp.asarray(inp), jnp.asarray(vels), jnp.asarray(gts),
                             num_out_channels)
    got = augment.apply_params(p, torch.from_numpy(inp), torch.from_numpy(vels),
                               torch.from_numpy(gts), num_out_channels)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5)
    changed = [not np.array_equal(g.numpy(), x) for g, x in zip(got, (inp, vels, gts))]
    assert changed[0] == bool(fire)
    assert changed[1] == ("flip_u" in fire)


def test_gate_constants_equal_jax():
    """The probabilities and ranges, as literals of the JAX package's
    ``augment_chunk``."""
    src = pathlib.Path(jaug.__file__).read_text()
    lit = lambda pattern: float(re.search(pattern, src).group(1))
    assert augment.ROT_P == lit(r"uniform\(k_rot_gate\) < ([\d.]+)")
    assert augment.ROT_DEG == lit(r"maxval=([\d.]+)\)\n\s+# reference converts")
    assert -augment.ROT_DEG == lit(r"minval=(-[\d.]+), maxval=20")
    assert augment.FLIP_P == lit(r"uniform\(k_flip\) < ([\d.]+)")
    assert augment.SCALE_P == lit(r"uniform\(k_scale_gate\) < ([\d.]+)")
    assert augment.SCALE_MIN == lit(r"k_scale, \(\), minval=([\d.]+)")
    assert augment.SCALE_MAX == lit(r"k_scale, \(\), minval=[\d.]+, maxval=([\d.]+)")
    assert augment.NOISE_P == lit(r"uniform\(k_noise_gate\) < ([\d.]+)")
    assert augment.NOISE_STD == lit(r"inputs.shape\) \* ([\de.-]+)")
    assert augment.POL_P == lit(r"uniform\(k_pol_gate\) < ([\d.]+)")


def test_augment_draws_are_reproducible_and_in_range():
    inp, vels, gts = _aug_inputs(7)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        outs.append(augment.augment_chunk(gen, torch.from_numpy(inp), torch.from_numpy(vels),
                                          torch.from_numpy(gts)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(12)
    fired = {k: 0 for k in ("rot_u", "flip_u", "scale_u", "noise_u", "pol_u")}
    for _ in range(2000):
        p = augment.draw_params(gen, 2, (1, 2, 2), "cpu")
        assert -20.0 <= p["angle_deg"].item() <= 20.0 and 0.25 <= p["scale"].item() <= 4.0
        assert set(p["signs"].flatten().tolist()) <= {-1.0, 1.0}
        for k in fired:
            fired[k] += p[k].item() < {"scale_u": 0.2}.get(k, 0.1)
    rates = {k: v / 2000 for k, v in fired.items()}
    assert all(abs(rates[k] - {"scale_u": 0.2}.get(k, 0.1)) < 0.03 for k in rates), rates


# ---------------------------------------------------------- batch slicer

@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("channels", [(2, 1), (1, 1), (2, 2)])
def test_batch_slicer_matches_jax(quantized, channels):
    """The chunk gathered from the resident arrays, dequantized (int8 / 127,
    uint8 / 255) or cast from bf16, padded frames at desvel 1 and mask 0."""
    import ml_dtypes

    rng = np.random.default_rng(8)
    B, N, M, hw = 4, 9, 7, (5, 6)
    depths = rng.random((N + B, *hw)).astype(np.float32)
    evs = np.clip(rng.normal(size=(M + B, *hw)), -1, 1).astype(np.float32)
    if quantized:
        d_np = np.clip(np.round(depths * 255), 0, 255).astype(np.uint8)
        e_np = np.clip(np.round(evs * 127), -127, 127).astype(np.int8)
        d_t, e_t = torch.from_numpy(d_np), torch.from_numpy(e_np)
    else:
        d_np, e_np = depths.astype(ml_dtypes.bfloat16), evs.astype(ml_dtypes.bfloat16)
        d_t, e_t = torch.from_numpy(depths).bfloat16(), torch.from_numpy(evs).bfloat16()
        np.testing.assert_array_equal(d_t.float().numpy(), d_np.astype(np.float32))
    desvel = rng.random(N + B).astype(np.float32) + 1
    velcmd = rng.normal(size=(N + B, 3)).astype(np.float32)
    jdata = {"depths": jnp.asarray(d_np), "evs": jnp.asarray(e_np),
             "desvel": jnp.asarray(desvel), "velcmd": jnp.asarray(velcmd)}
    tdata = {"depths": d_t, "evs": e_t, "desvel": torch.from_numpy(desvel),
             "velcmd": torch.from_numpy(velcmd)}
    jget = jstepfn.make_batch_slicer(B, *channels)
    tget = stepfn.make_batch_slicer(B, *channels)
    for start, ev_start, n_valid in [(0, 0, 4), (5, 3, 2), (8, 6, 1)]:
        ref = jget(jdata, {"start": jnp.int32(start), "ev_start": jnp.int32(ev_start),
                           "n_valid": jnp.int32(n_valid)})
        got = tget(tdata, {"start": start, "ev_start": ev_start, "n_valid": n_valid})
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


# ----------------------------------------------------- config and registry

@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.name)
def test_config_files_parse_as_jax(path):
    ref = jax_parse_config_file(str(path)).to_dict()
    got = parse_config_file(str(path)).to_dict()
    assert got == ref
    assert config_device(got["device"]) == "cuda"


def test_config_device_reading():
    for name in ("tpu", "gpu", "cuda", "TPU", None):
        assert config_device(name) == "cuda"
    assert config_device("cpu") == "cpu"
    with pytest.raises(ValueError, match="device"):
        config_device("metal")
    assert EvflyConfig().device == "tpu"


@pytest.mark.parametrize("model_type", [
    ["VITFLY_ViT"], ["ViT"], ["LSTMNet"], ["VITFLY_LSTMNet"], ["ConvNet"],
    ["VITFLY_UNetConvLSTMNet"], ["VITFLY_ConvNet"], ["UNetConvLSTMNet"],
])
def test_registry_builds_the_zoo_with_jax_param_counts(model_type):
    """Every vitfly family the JAX registry builds, with its parameter count
    and state_dict keys."""
    model = registry.build_model(EvflyConfig(model_type=model_type), device="cpu")
    jmodel = jax_registry.build_model(JaxEvflyConfig(model_type=model_type))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    assert type(model).__name__ == type(jmodel).__name__
    assert param_count(model.state_dict()) == jax_param_count(jparams)
    assert set(model.state_dict()) == set(jparams)


# the enc and fc params of evfly_tpu/configs/files/eval_sim_Dtheta_vitlstm.txt
HEAD_KEYS = dict(
    enc_num_layers=2, enc_kernel_sizes=[5, 3], enc_kernel_strides=[2, 2],
    enc_out_channels=[8, 32], enc_activations=["relu", "relu"], enc_pool_type="max",
    enc_invert_pool_inputs=True, enc_pool_kernels=[2, 2], enc_pool_strides=[2, 2],
    fc_num_layers=4, fc_layer_sizes=[1024, 128, 16, 1],
    fc_activations=["leaky_relu", "leaky_relu", "leaky_relu", "tanh"], fc_dropout_p=0.1,
)


def test_registry_builds_the_ported_families_with_jax_keys():
    """Every family the port builds, keys and shapes against the JAX
    package's init: the joint model's family at 190x190, the velocity heads
    at 260x346 with the shipped enc and fc params (the composite's head
    reads the 68x148 decoder output, which the JAX composite fixes)."""
    from evfly_tpu.models.registry import build_model as jax_build_model

    cfg = dict(num_recurrent=[1, 0], bev=2, skip_type="interp", resize_input=list(UNET_HW),
               evs_min_cutoff=0.0)
    heads = dict(cfg, resize_input=[260, 346], num_outputs=1, **HEAD_KEYS)
    cases = [(mt, {}, cfg) for mt in (["OrigUNet"], ["VITFLY_ViTLSTM"], ["LSTMNetVIT"],
                                      ["OrigUNet", "VITFLY_ViTLSTM"])]
    cases += [(["OrigUNet"], dict(velpred=v, num_recurrent=[1, 1]), heads) for v in (1, 11)]
    cases += [(["OrigUNet"], dict(velpred=2, enc_kernel_sizes=[2, 2], enc_kernel_strides=[1, 1],
                                  enc_pool_strides=[1, 1]), heads),
              (["ConvNet_w_VelPred"], dict(num_recurrent=[0, 0]), heads),
              (["OrigUNet", "ConvNet_w_VelPred"], dict(num_recurrent=[1, 1]), heads)]
    for mt, extra, base in cases:
        c = EvflyConfig(model_type=mt, **{**base, **extra})
        model = registry.build_model(c, device="cpu")
        ref = jax.eval_shape(jax_build_model(jax_parse_config_from(c)).init,
                             jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
            k: tuple(v.shape) for k, v in ref.items()}, (mt, extra)
        assert all(v.dtype == torch.int64 for k, v in model.state_dict().items()
                   if k.endswith("num_batches_tracked"))
    deploy = registry.build_model(EvflyConfig(model_type=["OrigUNet"], **cfg),
                                  is_deployment=True, device="cpu")
    assert deploy.is_deployment


def jax_parse_config_from(cfg):
    from evfly_tpu.configs import EvflyConfig as JaxConfig

    return JaxConfig(**cfg.to_dict())


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """V(phi)'s train step (depth in, input_frame_scale 2) on the card
    against the CPU from one init, no augmentation or dropout; then an eval
    step, served by V(phi)'s CUDA graph: K4 launched at its two warm-up
    calls and its capture, once each, and no gradient."""
    rng = np.random.default_rng(40)
    n, lr = 8, 1e-4
    mask = (np.arange(n) < 7).astype(np.float32)
    nb = {"input": rng.random((n, 1, 60, 90)).astype(np.float32),
          "desvel": np.where(mask[:, None] > 0, 4.0, 1.0).astype(np.float32),
          "gt_vel": np.stack([np.full(n, 4.0), rng.normal(size=n), np.zeros(n)], 1
                             ).astype(np.float32),
          "gt_frames": rng.random((n, 1, 60, 90)).astype(np.float32), "mask": mask}
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = LSTMNetVIT(generator=torch.Generator().manual_seed(3), device=dev)
        before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        step = stepfn.make_train_step(model, "vitfly", opt, [1.0, 0.0], [5.0, 0.0],
                                      input_frame_scale=2.0)
        loss, values, gn = step({k: torch.from_numpy(v).to(dev) for k, v in nb.items()}, None)
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        out[dev.type] = (loss.item(), values.cpu(), gn.item(), grads,
                         {k: v.cpu() for k, v in model.state_dict().items()}, model)
    (lg, vg, gg, gradg, pg, model), (lc, vc, gc, gradc, pc, _) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    np.testing.assert_allclose(vg.numpy(), vc.numpy(), rtol=1e-4)
    np.testing.assert_allclose(gg, gc, rtol=1e-4)
    for k, g in gradc.items():
        gap = (gradg[k] - g).abs().max().item()
        assert gap <= 1e-4 * g.abs().max().item(), (k, gap)
        tiny = (g.abs() <= 100 * gap) & ((g != 0) | (gradg[k] != 0))
        bound = torch.where(tiny, 2 * lr, 1e-6) + torch.finfo(torch.float32).eps * before[k].abs()
        diff = ((pg[k] - before[k]) - (pc[k] - before[k])).abs()
        assert bool((diff <= bound).all()), (k, (diff / bound).max().item())
    for k, v in pc.items():
        if k not in gradc:
            np.testing.assert_allclose(pg[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    before = lstm_stacked_cluster.launches
    evaluate = stepfn.make_eval_step(model, "vitfly", [1.0, 0.0], [5.0, 0.0],
                                     input_frame_scale=2.0)
    loss, values, pv, _ = evaluate({k: torch.from_numpy(v).to(cuda_device) for k, v in nb.items()})
    torch.cuda.synchronize()
    assert lstm_stacked_cluster.launches == before + WARMUP_STEPS + 1
    assert sum(model.serve_stats.captures.values()) == 1
    assert not loss.requires_grad and bool(torch.isfinite(pv).all())
