"""The port's chunk-level data parallelism (evfly_tpu_torch/parallel/) against
the JAX package's (evfly_tpu/parallel/), on the CPU.

- BatchNorm over G chunks (a (G, N) mask): each chunk normalized with its
  own statistics, the running stats the mean of the valid chunks' updates,
  the counter + 1 once; against G single-chunk calls and JAX's vmap.
- The mesh helpers: a world of 1, the launch hint, the shards of a leading
  axis (JAX's test reads (2, 1) shards of 16 rows on 8 devices).
- The G-chunk train step against JAX's jitted ``make_dp_chunked_train_step``
  on its virtual 1- and 8-device meshes (``VITFLY_ConvNet``, which has a
  BatchNorm; the joint model is tests/test_torch_dp_joint.py), ``rngs=None``
  and ``generator=None``: no dropout on either side.
- Two gloo processes against one (spawned; they import no JAX).
- The demos and the dry run.

Tolerances as tests/torch_train_cases.py's: loss and terms rtol 1e-5, the
gradient norm rtol 1e-4, BatchNorm running stats 1e-6 + 1e-5 relative and
their counters exactly; each trained tensor's change from the start,
||Delta_port - Delta_jax|| <= 1e-3 ||Delta_jax|| (tests/test_torch_learner.py's
rule).  Two processes against one: the same bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evfly_tpu.models.common import is_trainable_key
from evfly_tpu.models.vitfly import ConvNet as JaxConvNet
from evfly_tpu.ops import imageops as jimageops
from evfly_tpu.parallel.data_parallel import make_dp_chunked_train_step as jax_dp_step
from evfly_tpu.parallel.mesh import make_mesh as jax_mesh
from evfly_tpu_torch.models.common import BatchNorm2d
from evfly_tpu_torch.models.port import from_jax_params
from evfly_tpu_torch.models.vitfly import ConvNet
from evfly_tpu_torch.ops import imageops
from evfly_tpu_torch.parallel import (
    dp_chunked_demo_step,
    dp_train_demo_step,
    dryrun_chunked,
    make_dp_chunked_train_step,
    make_dp_train_step,
)
from evfly_tpu_torch.parallel.mesh import Mesh, batch_sharding, make_mesh, replicate_params, \
    shard_batch, spawn_ranks
from evfly_tpu_torch.train import stepfn
from torch_dp_cases import (
    CONVNET_B,
    CONVNET_HW,
    CONVNET_LOSS,
    LR,
    chunk_idxs,
    convnet_steps,
    resident_split,
    torch_split,
)
from torch_helpers import cuda_device  # noqa: F401  (fixture)
from torch_train_cases import few_torch_threads, jax_optimizer  # noqa: F401

CPU = Mesh(1, 0, torch.device("cpu"))


def _bn_case(seed, G=3, N=4, C=5, hw=(6, 7)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G * N, C, *hw)) * 2.0 + 0.5
    mask = np.ones((G, N))
    mask[1, 2:] = 0.0   # a partial chunk
    mask[2] = 0.0       # an empty one
    return x.astype(np.float32), mask.astype(np.float32)


def _seeded_bn(C, rng):
    bn = BatchNorm2d(C, "cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.standard_normal(C).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(C).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(C).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.random(C).astype(np.float32) + 0.5))
        bn.num_batches_tracked.fill_(7)
    return bn.train()


def _assert_bn_state(got, ref_mean, ref_var, ref_count):
    np.testing.assert_allclose(got.running_mean.numpy(), ref_mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.running_var.numpy(), ref_var, rtol=1e-5, atol=1e-6)
    assert int(got.num_batches_tracked) == ref_count
    assert got.num_batches_tracked.dtype == torch.int64


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_batchnorm_matches_single_chunks_and_jax(seed):
    """Outputs and running stats of one (G, N)-masked call against G
    single-chunk calls from the same old stats (the valid chunks' updates
    averaged) and against JAX's batch_norm2d vmapped over the chunks with
    the padded chunk's update left out, as make_dp_chunked_train_step."""
    x, mask = _bn_case(seed)
    G, N = mask.shape
    bn = _seeded_bn(x.shape[1], np.random.default_rng(seed + 10))
    old = {k: v.clone() for k, v in bn.state_dict().items()}
    out = bn(torch.from_numpy(x), torch.from_numpy(mask))
    bn.apply_chunk_update(*bn.chunk_update)

    outs, means, vars_ = [], [], []
    for g in range(G):
        o, m, v = imageops.batch_norm2d(torch.from_numpy(x[g * N:(g + 1) * N]), old["weight"],
                                        old["bias"], old["running_mean"], old["running_var"],
                                        True, mask=torch.from_numpy(mask[g]))
        outs.append(o.detach().numpy())
        if mask[g].sum() > 0:
            means.append(m.numpy())
            vars_.append(v.numpy())
    valid = mask.reshape(-1) > 0
    np.testing.assert_allclose(out.detach().numpy()[valid], np.concatenate(outs)[valid],
                               rtol=1e-5, atol=1e-6)
    _assert_bn_state(bn, np.mean(means, 0), np.mean(vars_, 0), 8)

    def one(xg, mg):
        return jimageops.batch_norm2d(xg, *(jnp.asarray(old[k].numpy()) for k in
                                            ("weight", "bias", "running_mean", "running_var")),
                                      training=True, mask=mg)

    jout, jm, jv = jax.vmap(one)(jnp.asarray(x.reshape(G, N, *x.shape[1:])), jnp.asarray(mask))
    real = (mask.sum(1) > 0)[:, None]
    np.testing.assert_allclose(out.detach().numpy()[valid],
                               np.asarray(jout).reshape(x.shape)[valid], rtol=1e-5, atol=1e-5)
    _assert_bn_state(bn, (np.asarray(jm) * real).sum(0) / real.sum(),
                     (np.asarray(jv) * real).sum(0) / real.sum(), 8)


def test_grouped_batchnorm_defers_and_keeps_the_frame_mask_path():
    """A (G, N)-masked forward leaves the buffers and its sums on
    chunk_update; apply_chunk_update with no valid chunk changes nothing,
    with the count sets the mean of the valid chunks' updates (as G
    single-chunk calls); a (N,) mask and no mask update as before (the
    counter + 1 each)."""
    x, mask = _bn_case(3)
    G, N = mask.shape
    bn = _seeded_bn(x.shape[1], np.random.default_rng(4))
    old = {k: v.clone() for k, v in bn.state_dict().items()}
    bn(torch.from_numpy(x), torch.from_numpy(mask))
    assert all(torch.equal(v, old[k]) for k, v in bn.state_dict().items())
    mean_sum, var_sum, n_real = bn.chunk_update
    assert float(n_real) == 2.0
    bn.apply_chunk_update(mean_sum, var_sum, torch.tensor(0.0))
    assert all(torch.equal(v, old[k]) for k, v in bn.state_dict().items())
    bn.apply_chunk_update(mean_sum, var_sum, n_real)
    singles = [imageops.batch_norm2d(torch.from_numpy(x[g * N:(g + 1) * N]), old["weight"],
                                     old["bias"], old["running_mean"], old["running_var"], True,
                                     mask=torch.from_numpy(mask[g]))[1:]
               for g in range(G) if mask[g].sum() > 0]
    _assert_bn_state(bn, np.mean([m.numpy() for m, _ in singles], 0),
                     np.mean([v.numpy() for _, v in singles], 0), 8)

    flat = torch.from_numpy(x[:4])
    for m in (torch.tensor([1.0, 1.0, 1.0, 0.0]), None):
        bn = _seeded_bn(x.shape[1], np.random.default_rng(5))
        old = {k: v.clone() for k, v in bn.state_dict().items()}
        out = bn(flat, m)
        o, rm, rv = imageops.batch_norm2d(flat, old["weight"], old["bias"], old["running_mean"],
                                          old["running_var"], True, mask=m)
        assert torch.equal(out, o)
        assert torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var, rv)
        assert int(bn.num_batches_tracked) == 8


def test_padded_chunks_are_not_run():
    """A padded chunk adds 0 to every sum, so the step leaves it out of the
    forward (the JAX step computes it and zeroes it): run, its degenerate
    BatchNorm statistics can saturate the velocity head's tanh into
    sqrt(1 - y^2), whose infinite derivative times its 0 loss gives NaN
    gradients (configuration A on the card).  Here the padded chunk points
    at NaN frames: the step is finite and equals the step of the real
    chunks alone."""
    B = CONVNET_B
    split = resident_split(80, 24, 24, CONVNET_HW, B, depth_input=True)
    split["depths"][20:24] = np.nan
    idxs = chunk_idxs(81, 3, B, 20, 20, partial=1, padded=1)
    idxs["start"][2] = 20
    results = []
    for chunks in (idxs, {k: v[:2] for k, v in idxs.items()}):
        model = ConvNet(generator=torch.Generator().manual_seed(3), device="cpu")
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        step = make_dp_chunked_train_step(model, "vitfly", opt, CPU, B, 1, 1, **CONVNET_LOSS)
        out = step(torch_split(split), chunks, None)
        results.append((out, model.state_dict()))
    (got, state), (want, want_state) = results
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and float(got[3]) == 2.0
    assert all(torch.equal(v, want_state[k]) and torch.isfinite(v.float()).all()
               for k, v in state.items())


def test_mesh_helpers(monkeypatch):
    for n in (None, 0, 1):
        mesh = make_mesh(n, "cpu")
        assert (mesh.world_size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=8"):
        make_mesh(8, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1)
    batch = {"x": np.arange(16, dtype=np.float32).reshape(16, 1)}
    shards = [shard_batch(batch, Mesh(8, r, torch.device("cpu")))["x"] for r in range(8)]
    assert all(s.shape == (2, 1) for s in shards)
    np.testing.assert_array_equal(np.concatenate(shards), batch["x"])
    assert batch_sharding(Mesh(4, 3, torch.device("cpu")), 8) == slice(6, 8)
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(Mesh(3, 0, torch.device("cpu")), 8)
    t = torch.arange(3.0)
    assert replicate_params({"t": t}, CPU)["t"] is t and CPU.all_reduce_sum_(t) is t


@pytest.mark.parametrize("channels", [(2, 1), (1, 1), (2, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_chunk_gather_is_the_batch_slicer_per_chunk(channels, dtype):
    """make_chunk_gather's (G, B) gather equals make_batch_slicer's chunk
    for each of the G index triples, in f32 and in the quantized layout
    (uint8 depths, int8 events), padded frames with desvel 1."""
    B, n_frames = 4, 12
    split = torch_split(resident_split(70, n_frames, n_frames - 1, (6, 9), B))
    if dtype == torch.uint8:
        split["depths"] = (split["depths"] * 255).round().to(torch.uint8)
        split["evs"] = (split["evs"] * 127).round().to(torch.int8)
    idxs = chunk_idxs(71, 5, B, n_frames, n_frames - 1, partial=1, padded=1)
    got = stepfn.make_chunk_gather(B, *channels)(split, {k: torch.as_tensor(v)
                                                         for k, v in idxs.items()})
    slicer = stepfn.make_batch_slicer(B, *channels)
    for g in range(5):
        want = slicer(split, {k: int(v[g]) for k, v in idxs.items()})
        for k, v in want.items():
            assert torch.equal(got[k][g], v), (k, g)
    assert float(got["desvel"][4].max()) == float(got["desvel"][4].min()) == 1.0


def test_chunked_forward_loss_is_each_chunks_loss():
    """The chunked forward's loss and terms of each chunk equal
    make_forward_loss on that chunk alone (a BatchNorm model in training:
    each chunk its own statistics); a padded chunk's are 0."""
    B, G = 4, 3
    split = torch_split(resident_split(72, 16, 16, CONVNET_HW, B))
    idxs = chunk_idxs(73, G, B, 16, 16, partial=0, padded=1)
    model = ConvNet(generator=torch.Generator().manual_seed(9), device="cpu").train()
    chunked = stepfn.make_chunked_forward_loss(model, "vitfly", **CONVNET_LOSS)
    losses, values = chunked(stepfn.make_chunk_gather(B, 1, 1)(
        split, {k: torch.as_tensor(v) for k, v in idxs.items()}), None)
    single = stepfn.make_forward_loss(model, "vitfly", **CONVNET_LOSS)
    slicer = stepfn.make_batch_slicer(B, 1, 1)
    for g in range(G):
        loss, vals, _, _ = single(slicer(split, {k: int(v[g]) for k, v in idxs.items()}), None)
        np.testing.assert_allclose(losses[g].item(), loss.item(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(values[g].detach().numpy(), vals.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert losses[G - 1].item() == 0.0


def _jax_split(split):
    return {k: jnp.asarray(v) for k, v in split.items()}


@pytest.mark.parametrize("n_devices", [1, 8])
def test_chunked_step_matches_jax(n_devices):
    """Two G = 8 chunk-DP steps of ConvNet (chunks of 4 at 60x90, depth
    input): a partial chunk and padded ones, then three padded chunks, on
    JAX's mesh of n_devices against the port's step in one process."""
    G, B, n_frames = 8, CONVNET_B, 40
    jm = JaxConvNet()
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(6)).items()}
    model = ConvNet(device="cpu")
    model.load_state_dict(from_jax_params(params, "cpu"))
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_dp_chunked_train_step(model, "vitfly", opt, CPU, B, 1, 1, **CONVNET_LOSS)
    jopt = jax_optimizer(params)
    jstep = jax_dp_step(jm, "vitfly", jopt, jax_mesh(n_devices), B, num_in_channels=1,
                        num_out_channels=1, **CONVNET_LOSS)
    split = resident_split(40, n_frames, n_frames, CONVNET_HW, B, depth_input=True)
    data, jdata = torch_split(split), _jax_split(split)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    for s, (seed, partial, padded) in enumerate(((41, 2, 2), (42, 0, 3))):
        idxs = chunk_idxs(seed, G, B, n_frames, n_frames, partial, padded)
        jidxs = {k: jnp.asarray(v, jnp.int32) for k, v in idxs.items()}
        jparams, jstate, jloss, jvalues, jgn, jn = jstep(jparams, jstate, jdata, jidxs, None)
        loss, values, gn, n_real = step(data, idxs, None)
        assert float(n_real) == float(jn) == G - padded
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=1e-5)
        np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-4)
        _assert_state_close(model.state_dict(), jparams, params, s + 1)


def _assert_state_close(state, jparams, start, steps, loose=None):
    """The port's state against JAX's params after ``steps`` steps; with
    ``loose`` (key -> elements whose gradient came near 0) each trained
    element by torch_train_cases.py's Adam rule instead of the norm rule."""
    for k, v in jparams.items():
        got, ref = state[k].numpy(), np.asarray(v)
        if k.endswith("num_batches_tracked"):
            assert int(got) == int(ref) == steps, k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=k)
        elif not is_trainable_key(k):
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=k)
        elif loose is not None:
            err = np.abs((got - start[k]) - (ref - start[k]))
            bound = np.where(loose[k], 2 * LR * steps + 1e-5, 0.05 * LR * steps)
            assert (err <= bound).all(), (k, float((err / bound).max()))
        else:
            d, dref = got - start[k], ref - start[k]
            assert np.linalg.norm(d - dref) <= 1e-3 * np.linalg.norm(dref), k


def test_two_gloo_processes_equal_one(tmp_path):
    """ConvNet's two steps (G = 4: rank 1 holds a padded chunk in the first,
    only padded chunks in the second) in two spawned gloo processes against
    the same steps in this one."""
    out = tmp_path / "rank0.pt"
    spawn_ranks(convnet_steps, 2, str(out), device="cpu", init_dir=str(tmp_path / "init"))
    got = torch.load(out, weights_only=False)
    assert got["jax_modules"] == []
    results, state = convnet_steps(CPU)
    for (l2, v2, g2, n2), (l1, v1, g1, n1) in zip(got["results"], results):
        assert n2 == n1
        np.testing.assert_allclose(l2, l1, rtol=1e-5)
        np.testing.assert_allclose(v2, v1, rtol=1e-5)
        np.testing.assert_allclose(g2, g1, rtol=1e-4)
    assert [r[3] for r in results] == [3.0, 2.0]
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            assert int(got["state"][k]) == int(v) == 2
        else:
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_frame_level_step_is_the_train_step():
    """make_dp_train_step computes the whole batch in every process: the
    1-device train step; dp_train_demo_step gives one finite step."""
    model = ConvNet(generator=torch.Generator().manual_seed(8), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = make_dp_train_step(model, "vitfly", opt, CPU, **CONVNET_LOSS)
    ref_model = ConvNet(generator=torch.Generator().manual_seed(8), device="cpu")
    ref = stepfn.make_train_step(ref_model, "vitfly", torch.optim.Adam(ref_model.parameters(),
                                                                       lr=LR),
                                 CONVNET_LOSS["loss_weights"], CONVNET_LOSS["optional_loss_param"])
    split = torch_split(resident_split(50, 8, 8, CONVNET_HW, 4, depth_input=True))
    batch = stepfn.make_batch_slicer(4, 1, 1)(split, {"start": 1, "ev_start": 1, "n_valid": 3})
    got, want = step(batch, None), ref(batch, None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    loss, values, gn = dp_train_demo_step(1, input_hw=(188, 188), batch=2, device="cpu")
    assert np.isfinite(loss) and np.isfinite(gn) and len(values) == 2


def test_chunked_demo_and_dry_run(capsys):
    """dryrun_chunked(1) at the JAX dry run's shapes (188x196, G = 8 of 4
    frames, one partial, one padded): its checks pass and it says so;
    dp_chunked_demo_step takes the caller's weights."""
    out = dryrun_chunked(1, device="cpu")
    assert out["n_real"] == 7 and np.isfinite(out["loss_sum"]) and out["gradnorm"] > 0
    assert "dryrun_chunked(1): PASS" in capsys.readouterr().out
    from evfly_tpu_torch.parallel.data_parallel import _flagship_model

    sd = {k: v * 0.5 if v.is_floating_point() else v
          for k, v in _flagship_model((188, 196), "cpu").state_dict().items()}
    loss, _, gn, n_real = dp_chunked_demo_step(1, G=2, chunks_per_device=2, device="cpu",
                                               state_dict=sd)
    assert n_real == 1 and np.isfinite(loss) and np.isfinite(gn)
    assert loss != out["loss_sum"]


@pytest.mark.gpu
def test_chunked_step_on_the_card_matches_the_cpu(cuda_device):
    """ConvNet's two chunk-DP steps on the card against the CPU: loss,
    terms and gradient norm rtol 1e-4, BatchNorm state 1e-6 + 1e-5
    relative, the counter exactly, each trained tensor's change from the
    seeded start within 1e-2 of the CPU's in norm (cuDNN's convolutions
    sum in another order; Adam at 1e-5 turns that into a sign at tiny
    gradients)."""
    start = ConvNet(generator=torch.Generator().manual_seed(3), device="cpu").state_dict()
    got, got_state = convnet_steps(Mesh(1, 0, cuda_device))
    want, want_state = convnet_steps(CPU)
    for (l2, v2, g2, n2), (l1, v1, g1, n1) in zip(got, want):
        assert n2 == n1
        np.testing.assert_allclose(l2, l1, rtol=1e-4)
        np.testing.assert_allclose(v2, v1, rtol=1e-4)
        np.testing.assert_allclose(g2, g1, rtol=1e-4)
    for k, v in want_state.items():
        g = got_state[k]
        if k.endswith("num_batches_tracked"):
            assert int(g) == int(v) == 2
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            d, dref = g - start[k], v - start[k]
            assert torch.linalg.vector_norm(d - dref) <= 1e-2 * torch.linalg.vector_norm(dref), k
