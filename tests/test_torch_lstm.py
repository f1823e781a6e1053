"""The port's LSTM (ops.lstm_fused, models.recurrent) against the JAX package.

The same numpy weights and sequences go through the JAX
``lstm_apply_fused(mode="stacked"|"wavefront")`` (its Pallas kernels in
interpret mode on the CPU) and ``lstm_apply`` (lax.scan), and through the
port, whose K4 and K5 wrappers take their plain PyTorch versions on CPU
tensors.  The port's stream axis (G sequences in one call) is held against
G separate JAX calls.  atol 2e-5, and
3e-5 with a carried hidden state, are the JAX package's own bounds for the
fused kernel (tests/test_lstm_pallas.py:53,79): sums run in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evfly_tpu.models.recurrent import lstm_apply as jax_lstm_apply
from evfly_tpu.ops.lstm_pallas import lstm_apply_fused as jax_lstm_apply_fused
from evfly_tpu_torch.models import recurrent
from evfly_tpu_torch.ops import lstm_fused
from torch_helpers import cuda_device  # noqa: F401  (fixture)

ATOL, ATOL_CARRIED = 2e-5, 3e-5


def _params(rng, input_size, hidden, layers, bias=True):
    p = {}
    for l in range(layers):
        in_l = input_size if l == 0 else hidden
        p[f"weight_ih_l{l}"] = (rng.normal(size=(4 * hidden, in_l)) * 0.2).astype(np.float32)
        p[f"weight_hh_l{l}"] = (rng.normal(size=(4 * hidden, hidden)) * 0.2).astype(np.float32)
        if bias:
            p[f"bias_ih_l{l}"] = (rng.normal(size=(4 * hidden,)) * 0.1).astype(np.float32)
            p[f"bias_hh_l{l}"] = (rng.normal(size=(4 * hidden,)) * 0.1).astype(np.float32)
    return p


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _close(got, ref, atol):
    out, (h, c) = got
    rout, (rh, rc) = ref
    for a, b in ((out, rout), (h, rh), (c, rc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("bias", [True, False])
def test_plain_k4_matches_jax(layers, bias):
    rng = np.random.default_rng(layers * 10 + bias)
    T, input_size, hidden = 17, 37, 128
    p = _params(rng, input_size, hidden, layers, bias)
    x = rng.normal(size=(T, input_size)).astype(np.float32)

    got = lstm_fused.lstm_apply_fused(_torch(p), torch.from_numpy(x), None, layers, hidden)
    ref_fused = jax_lstm_apply_fused(_jax(p), jnp.asarray(x), None, layers, hidden, mode="stacked")
    ref_scan = jax_lstm_apply(_jax(p), jnp.asarray(x), None, layers, hidden)
    _close(got, ref_fused, ATOL)
    _close(got, ref_scan, ATOL)


@pytest.mark.parametrize("layers", [1, 3])
def test_plain_lstm_apply_matches_jax(layers):
    """The port's plain per-layer loop (what CPU and training take)."""
    rng = np.random.default_rng(40 + layers)
    T, input_size, hidden = 13, 21, 64
    p = _params(rng, input_size, hidden, layers)
    x = rng.normal(size=(T, input_size)).astype(np.float32)
    got = recurrent.lstm_apply(_torch(p), torch.from_numpy(x), None, layers, hidden)
    ref = jax_lstm_apply(_jax(p), jnp.asarray(x), None, layers, hidden)
    _close(got, ref, ATOL)


def test_carried_hidden_matches_jax():
    """Two T/2 segments with the state carried == one pass over T."""
    rng = np.random.default_rng(7)
    T, input_size, hidden, layers = 16, 24, 128, 3
    p = _params(rng, input_size, hidden, layers)
    x = rng.normal(size=(T, input_size)).astype(np.float32)
    tp, xt = _torch(p), torch.from_numpy(x)

    out_a, hid = lstm_fused.lstm_apply_fused(tp, xt[: T // 2], None, layers, hidden)
    out_b, hid = lstm_fused.lstm_apply_fused(tp, xt[T // 2:], hid, layers, hidden)
    ref = jax_lstm_apply(_jax(p), jnp.asarray(x), None, layers, hidden)
    _close((torch.cat([out_a, out_b]), hid), ref, ATOL_CARRIED)

    h0 = (rng.normal(size=(layers, hidden)) * 0.5).astype(np.float32)
    c0 = (rng.normal(size=(layers, hidden)) * 0.5).astype(np.float32)
    got = lstm_fused.lstm_apply_fused(
        tp, xt, (torch.from_numpy(h0), torch.from_numpy(c0)), layers, hidden)
    ref = jax_lstm_apply_fused(_jax(p), jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
                               layers, hidden, mode="stacked")
    _close(got, ref, ATOL_CARRIED)


def test_k4_wrapper_on_cpu_takes_plain_version():
    rng = np.random.default_rng(3)
    p = _torch(_params(rng, 9, 128, 2))
    before = lstm_fused.lstm_stacked.launches
    recurrent.lstm_apply(p, torch.from_numpy(rng.normal(size=(5, 9)).astype(np.float32)),
                         None, 2, 128)
    lstm_fused.lstm_apply_fused(p, torch.zeros(5, 9), None, 2, 128)
    assert lstm_fused.lstm_stacked.launches == before


def test_pack_stacked_layouts():
    rng = np.random.default_rng(5)
    p = _torch(_params(rng, 9, 128, 3))
    whh_t, wih_t, bias = lstm_fused.pack_stacked(p, 3, 128)
    assert whh_t.shape == (128, 3 * 512) and wih_t.shape == (128, 2 * 512)
    assert torch.equal(whh_t[:, 512:1024], p["weight_hh_l1"].T)
    assert torch.equal(wih_t[:, 512:], p["weight_ih_l2"].T)
    assert torch.equal(bias[:512], p["bias_ih_l1"] + p["bias_hh_l1"])


@pytest.mark.parametrize("T", [1, 2, 17])
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("bias", [True, False])
def test_plain_k5_matches_jax_wavefront(T, layers, bias):
    """T < L runs the ramp-up and drain corners of the (layer, time) grid
    (tests/test_lstm_pallas.py:85-98)."""
    rng = np.random.default_rng(100 + 10 * T + 2 * layers + bias)
    input_size, hidden = 37, 128
    p = _params(rng, input_size, hidden, layers, bias)
    x = rng.normal(size=(T, input_size)).astype(np.float32)
    got = lstm_fused.lstm_apply_fused(_torch(p), torch.from_numpy(x), None, layers, hidden,
                                      mode="wavefront")
    ref = jax_lstm_apply_fused(_jax(p), jnp.asarray(x), None, layers, hidden, mode="wavefront")
    _close(got, ref, ATOL)
    _close(got, jax_lstm_apply(_jax(p), jnp.asarray(x), None, layers, hidden), ATOL)


def test_plain_k5_carried_hidden_matches_jax():
    rng = np.random.default_rng(8)
    T, input_size, hidden, layers = 16, 24, 128, 3
    p = _params(rng, input_size, hidden, layers)
    x = rng.normal(size=(T, input_size)).astype(np.float32)
    tp, xt = _torch(p), torch.from_numpy(x)
    out_a, hid = lstm_fused.lstm_apply_fused(tp, xt[: T // 2], None, layers, hidden, "wavefront")
    out_b, hid = lstm_fused.lstm_apply_fused(tp, xt[T // 2:], hid, layers, hidden, "wavefront")
    ref = jax_lstm_apply(_jax(p), jnp.asarray(x), None, layers, hidden)
    _close((torch.cat([out_a, out_b]), hid), ref, ATOL_CARRIED)

    h0 = (rng.normal(size=(layers, hidden)) * 0.5).astype(np.float32)
    c0 = (rng.normal(size=(layers, hidden)) * 0.5).astype(np.float32)
    got = lstm_fused.lstm_apply_fused(
        tp, xt, (torch.from_numpy(h0), torch.from_numpy(c0)), layers, hidden, "wavefront")
    ref = jax_lstm_apply_fused(_jax(p), jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
                               layers, hidden, mode="wavefront")
    _close(got, ref, ATOL_CARRIED)


@pytest.mark.parametrize("mode", ["stacked", "wavefront"])
@pytest.mark.parametrize("T", [1, 5])
def test_stream_axis_matches_separate_jax_calls(mode, T):
    """(G, T, in) with (G, L, H) state == G separate JAX calls, what the
    JAX package's vmap over the kernel computes."""
    rng = np.random.default_rng(60 + T)
    G, input_size, hidden, layers = 4, 19, 128, 3
    p = _params(rng, input_size, hidden, layers)
    x = rng.normal(size=(G, T, input_size)).astype(np.float32)
    h0 = (rng.normal(size=(G, layers, hidden)) * 0.5).astype(np.float32)
    c0 = (rng.normal(size=(G, layers, hidden)) * 0.5).astype(np.float32)
    out, (h, c) = lstm_fused.lstm_apply_fused(
        _torch(p), torch.from_numpy(x), (torch.from_numpy(h0), torch.from_numpy(c0)),
        layers, hidden, mode)
    assert out.shape == (G, T, hidden) and h.shape == c.shape == (G, layers, hidden)
    plain = recurrent.lstm_apply(
        _torch(p), torch.from_numpy(x), (torch.from_numpy(h0), torch.from_numpy(c0)),
        layers, hidden)
    for g in range(G):
        ref = jax_lstm_apply_fused(_jax(p), jnp.asarray(x[g]),
                                   (jnp.asarray(h0[g]), jnp.asarray(c0[g])),
                                   layers, hidden, mode=mode)
        _close((out[g], (h[g], c[g])), ref, ATOL_CARRIED)
        _close((plain[0][g], (plain[1][0][g], plain[1][1][g])), ref, ATOL_CARRIED)


def test_mode_default_and_unknown_mode():
    assert lstm_fused.FUSED_LSTM_MODE in ("stacked", "wavefront")
    with pytest.raises(ValueError, match="mode"):
        lstm_fused.lstm_apply_fused({}, torch.zeros(2, 3), None, 1, 128, mode="diagonal")


def test_k5_wrapper_on_cpu_takes_plain_version():
    rng = np.random.default_rng(4)
    p = _torch(_params(rng, 9, 128, 2))
    before = lstm_fused.lstm_wavefront.launches
    lstm_fused.lstm_apply_fused(p, torch.zeros(3, 5, 9), None, 2, 128, mode="wavefront")
    assert lstm_fused.lstm_wavefront.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("carried", [False, True])
def test_k4_kernel_matches_plain_on_gpu(cuda_device, carried):
    rng = np.random.default_rng(11)
    T, hidden, layers = 64, 128, 3
    p = {k: v.to(cuda_device) for k, v in _torch(_params(rng, 517, hidden, layers)).items()}
    x = torch.from_numpy(rng.normal(size=(T, 517)).astype(np.float32)).to(cuda_device)
    zeros = torch.zeros(layers, hidden, device=cuda_device)
    h0 = torch.randn(layers, hidden, device=cuda_device) * 0.5 if carried else zeros
    c0 = torch.randn(layers, hidden, device=cuda_device) * 0.5 if carried else zeros
    xp0 = x @ p["weight_ih_l0"].T + p["bias_ih_l0"] + p["bias_hh_l0"]
    packed = lstm_fused.pack_stacked(p, layers, hidden)
    got = lstm_fused.lstm_stacked(xp0, *packed, h0, c0)
    ref = lstm_fused.lstm_stacked_plain(xp0, *packed, h0, c0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=ATOL_CARRIED if carried else ATOL, rtol=0)


@pytest.mark.gpu
def test_k4_rejects_hidden_not_multiple_of_128(cuda_device):
    z = torch.zeros(4, 4 * 64, device=cuda_device)
    with pytest.raises(ValueError, match="% 128"):
        lstm_fused.lstm_stacked(z, torch.zeros(64, 256, device=cuda_device),
                                torch.zeros(64, 0, device=cuda_device),
                                torch.zeros(0, device=cuda_device),
                                torch.zeros(1, 64, device=cuda_device),
                                torch.zeros(1, 64, device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["stacked", "wavefront"])
@pytest.mark.parametrize("G,T", [(1, 64), (16, 1), (3, 2)])
def test_stream_kernels_match_plain_on_gpu(cuda_device, kernel, G, T):
    rng = np.random.default_rng(12)
    hidden, layers = 128, 3
    p = {k: v.to(cuda_device) for k, v in _torch(_params(rng, 517, hidden, layers)).items()}
    xp0 = torch.randn(G, T, 4 * hidden, device=cuda_device)
    h0 = torch.randn(G, layers, hidden, device=cuda_device) * 0.5
    c0 = torch.randn(G, layers, hidden, device=cuda_device) * 0.5
    packed = lstm_fused.pack_stacked(p, layers, hidden)
    fn = {"stacked": lstm_fused.lstm_stacked, "wavefront": lstm_fused.lstm_wavefront}[kernel]
    plain = {"stacked": lstm_fused.lstm_stacked_plain,
             "wavefront": lstm_fused.lstm_wavefront_plain}[kernel]
    for a, b in zip(fn(xp0, *packed, h0, c0), plain(xp0, *packed, h0, c0)):
        torch.testing.assert_close(a, b, atol=ATOL_CARRIED, rtol=0)


# ------------------------------------------------- cluster route (K4, K5)


@pytest.mark.parametrize("hidden,layers", [(128, 1), (128, 3)])
def test_cluster_pack_unpacks_to_pack_stacked(hidden, layers):
    rng = np.random.default_rng(200 + layers)
    p = _torch(_params(rng, 37, hidden, layers))
    whh_t, wih_t, bias = lstm_fused.pack_stacked(p, layers, hidden)
    wcl = lstm_fused.pack_cluster(whh_t, wih_t, hidden, layers)
    assert wcl.shape == (8, 2 * layers - 1, hidden * hidden // 2) and wcl.is_contiguous()
    got_hh, got_ih = lstm_fused.unpack_cluster(wcl, hidden, layers)
    assert torch.equal(got_hh, whh_t) and torch.equal(got_ih, wih_t)


@pytest.mark.parametrize("hidden,layers", [(128, 3), (256, 1)])
def test_cluster_pack_follows_the_kernel_indexing(hidden, layers):
    """Element ((warp*4 + gate)*H/64 + i/4)*128 + lane*4 + i%4 of rank r's
    slice of block m is W_m[gate*H + r*H/8 + u][i*16 + q] with q = lane % 16,
    u = 2*warp + lane // 16 (csrc/lstm.cu, ClusterShape), for the blocks
    W_hh0, W_ih1, W_hh1, W_ih2, W_hh2 in torch's (4H, H) layout."""
    rng = np.random.default_rng(210 + layers)
    p = _torch(_params(rng, 37, hidden, layers))
    wcl = lstm_fused.pack_cluster(*lstm_fused.pack_stacked(p, layers, hidden)[:2], hidden,
                                  layers)
    blocks = [p["weight_hh_l0"]]
    for l in range(1, layers):
        blocks += [p[f"weight_ih_l{l}"], p[f"weight_hh_l{l}"]]
    kk = hidden // 16
    for _ in range(300):
        r, m = rng.integers(8), rng.integers(len(blocks))
        warp, gate, i, lane = (rng.integers(n) for n in (hidden // 16, 4, kk, 32))
        q, u = lane % 16, 2 * warp + lane // 16
        idx = (((warp * 4 + gate) * (kk // 4) + i // 4) * 32 + lane) * 4 + i % 4
        assert wcl[r, m, idx] == blocks[m][gate * hidden + r * hidden // 8 + u, i * 16 + q]


def test_route_by_shape():
    assert lstm_fused.choose_route(128, 3) == "cluster"
    assert lstm_fused.choose_route(128, 1) == "cluster"
    assert lstm_fused.choose_route(256, 1) == "cluster"
    # past a cluster's shared memory (224 KiB of weights per CTA at H = 128,
    # L = 4), within 132 SMs' (ops/lstm_fused.grid_fits)
    assert lstm_fused.choose_route(256, 3) == "grid"
    assert lstm_fused.choose_route(128, 4) == "grid"
    assert lstm_fused.choose_route(384, 1) == "grid"
    assert lstm_fused.choose_route(768, 2) == "l2"  # 288 KiB of weights per grid CTA
    # one CTA's share at the repo's LSTM (H = 128, L = 3): 160 KiB of
    # weights and 3,776 bytes of state
    assert lstm_fused.cluster_smem_bytes(128, 3) == 5 * 32768 + 3776


@pytest.mark.parametrize("route", ["cluster", "l2", "grid"])
@pytest.mark.parametrize("mode", ["stacked", "wavefront"])
def test_both_routes_match_jax(mode, route):
    """Each route's plain version (the cluster and grid ones unpack their
    layouts) against the JAX kernel of the same order, with a carried state
    and two streams."""
    rng = np.random.default_rng(220)
    G, T, input_size, hidden, layers = 2, 6, 19, 128, 3
    p = _params(rng, input_size, hidden, layers)
    x = rng.normal(size=(G, T, input_size)).astype(np.float32)
    h0 = (rng.normal(size=(G, layers, hidden)) * 0.5).astype(np.float32)
    c0 = (rng.normal(size=(G, layers, hidden)) * 0.5).astype(np.float32)
    tp = _torch(p)
    packed = lstm_fused.pack(tp, layers, hidden)
    xp0 = torch.from_numpy(x) @ tp["weight_ih_l0"].T + tp["bias_ih_l0"] + tp["bias_hh_l0"]
    kernel = {("stacked", "cluster"): lstm_fused.lstm_stacked_cluster,
              ("wavefront", "cluster"): lstm_fused.lstm_wavefront_cluster,
              ("stacked", "l2"): lstm_fused.lstm_stacked,
              ("wavefront", "l2"): lstm_fused.lstm_wavefront,
              ("stacked", "grid"): lstm_fused.lstm_stacked_grid,
              ("wavefront", "grid"): lstm_fused.lstm_wavefront_grid}[(mode, route)]
    # (128, 3) takes the cluster route, so pack carries no grid layout there
    wgr = lstm_fused.pack_grid(packed.whh_t, packed.wih_t, hidden, layers)
    weights = {"cluster": (packed.cluster, packed.bias), "grid": (wgr, packed.bias),
               "l2": (packed.whh_t, packed.wih_t, packed.bias)}[route]
    out, h, c = kernel(xp0, *weights, torch.from_numpy(h0), torch.from_numpy(c0))
    for g in range(G):
        ref = jax_lstm_apply_fused(_jax(p), jnp.asarray(x[g]),
                                   (jnp.asarray(h0[g]), jnp.asarray(c0[g])),
                                   layers, hidden, mode=mode)
        _close((out[g], (h[g], c[g])), ref, ATOL_CARRIED)


def test_cluster_wrappers_on_cpu_take_plain_versions():
    rng = np.random.default_rng(6)
    p = _torch(_params(rng, 9, 128, 3))
    packed = lstm_fused.pack(p, 3, 128)
    xp0 = torch.randn(2, 4, 512)
    h0 = c0 = torch.zeros(2, 3, 128)
    before = (lstm_fused.lstm_stacked_cluster.launches,
              lstm_fused.lstm_wavefront_cluster.launches)
    a = lstm_fused.lstm_stacked_cluster(xp0, packed.cluster, packed.bias, h0, c0)
    b = lstm_fused.lstm_wavefront_cluster(xp0, packed.cluster, packed.bias, h0, c0)
    ref = lstm_fused.lstm_stacked_plain(xp0, packed.whh_t, packed.wih_t, packed.bias, h0, c0)
    assert (lstm_fused.lstm_stacked_cluster.launches,
            lstm_fused.lstm_wavefront_cluster.launches) == before
    for got in (a, b):
        for u, v in zip(got, ref):
            torch.testing.assert_close(u, v, atol=ATOL, rtol=0)


def test_packed_weights_are_cached_until_a_parameter_changes():
    gen = torch.Generator().manual_seed(0)
    lstm = recurrent.LSTM(17, 128, 3, gen, torch.device("cpu"))
    first = lstm.packed()
    assert lstm.packed() is first  # reused across calls
    ref = lstm_fused.pack({k: v.detach() for k, v in lstm.named_parameters()}, 3, 128)
    for a, b in zip(first, ref):  # the layouts of the other routes are None
        assert (a is None and b is None) or torch.equal(a, b)

    # load_state_dict copies into the parameters in place: a new pack
    state = {k: torch.randn_like(v) for k, v in lstm.state_dict().items()}
    lstm.load_state_dict(state)
    second = lstm.packed()
    assert second is not first
    assert torch.equal(second.whh_t[:, :512], state["weight_hh_l0"].T)

    # an in-place edit of one parameter: a new pack
    with torch.no_grad():
        lstm.weight_ih_l2.add_(1.0)
    third = lstm.packed()
    assert third is not second
    assert torch.equal(third.wih_t[:, 512:], lstm.weight_ih_l2.detach().T)
    assert lstm.packed() is third

    # a replaced parameter tensor (a new data_ptr): a new pack
    lstm.weight_hh_l1.data = lstm.weight_hh_l1.detach().clone() * 2
    assert lstm.packed() is not third


def test_packed_weights_are_rebuilt_after_load_params():
    from evfly_tpu_torch.models.vitfly import LSTMNetVIT

    model = LSTMNetVIT(device="cpu").eval()
    first = model.lstm.packed()
    assert model.lstm.packed() is first
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["lstm.weight_hh_l2"] = torch.randn_like(state["lstm.weight_hh_l2"])
    model.load_params(state)
    second = model.lstm.packed()
    assert second is not first
    assert torch.equal(second.whh_t[:, 1024:], state["lstm.weight_hh_l2"].T)
    whh_t, wih_t = lstm_fused.unpack_cluster(second.cluster, 128, 3)
    assert torch.equal(whh_t, second.whh_t) and torch.equal(wih_t, second.wih_t)


def test_packed_cache_made_under_inference_mode_is_an_ordinary_tensor():
    gen = torch.Generator().manual_seed(1)
    lstm = recurrent.LSTM(17, 128, 3, gen, torch.device("cpu"))
    with torch.inference_mode():
        packed = lstm.packed()
    assert not any(t.is_inference() for t in packed if t is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["stacked", "wavefront"])
@pytest.mark.parametrize("G,T", [(1, 256), (1, 2), (1, 1), (16, 1), (16, 256)])
def test_cluster_kernels_match_plain_on_gpu(cuda_device, mode, G, T):
    rng = np.random.default_rng(13)
    hidden, layers = 128, 3
    p = {k: v.to(cuda_device) for k, v in _torch(_params(rng, 517, hidden, layers)).items()}
    packed = lstm_fused.pack(p, layers, hidden)
    xp0 = torch.randn(G, T, 4 * hidden, device=cuda_device)
    h0 = torch.randn(G, layers, hidden, device=cuda_device) * 0.5
    c0 = torch.randn(G, layers, hidden, device=cuda_device) * 0.5
    fn = {"stacked": lstm_fused.lstm_stacked_cluster,
          "wavefront": lstm_fused.lstm_wavefront_cluster}[mode]
    plain = {"stacked": lstm_fused.lstm_stacked_plain,
             "wavefront": lstm_fused.lstm_wavefront_plain}[mode]
    got = fn(xp0, packed.cluster, packed.bias, h0, c0)
    ref = plain(xp0, packed.whh_t, packed.wih_t, packed.bias, h0, c0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=ATOL_CARRIED, rtol=0)
