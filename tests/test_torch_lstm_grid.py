"""K4 and K5 on the grid route (ops.lstm_fused, csrc/lstm.cu lstm_grid_kernel)
against the JAX package.

The grid route holds each CTA's 8 hidden units' gate columns in its shared
memory (``pack_grid``), exchanges h through global memory and runs one
cooperative grid for all streams.  On the CPU the wrappers take their plain
versions, which unpack the grid layout, so these tests hold the layout and
the plain versions against the JAX ``lstm_apply_fused(mode=...)`` (Pallas in
interpret mode) and ``lstm_apply`` (lax.scan), and a numpy mirror of the
kernel's bookkeeping (staging, the warp reduction, time parities, links)
against the plain version.  atol 2e-5, and 3e-5 with a carried state, are
the JAX package's bounds for the fused kernel (tests/test_lstm_pallas.py:53,
79).  The ``gpu`` tests hold each kernel against its plain version on the
card, inside a CUDA graph too, and check that a stalled barrier traps.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evfly_tpu.models.recurrent import lstm_apply as jax_lstm_apply
from evfly_tpu.ops.lstm_pallas import lstm_apply_fused as jax_lstm_apply_fused
from evfly_tpu_torch.models import recurrent
from evfly_tpu_torch.ops import _build, lstm_fused
from torch_helpers import cuda_device  # noqa: F401  (fixture)

ATOL, ATOL_CARRIED = 2e-5, 3e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {"stacked": (lstm_fused.lstm_stacked_grid, lstm_fused.lstm_stacked_plain),
           "wavefront": (lstm_fused.lstm_wavefront_grid, lstm_fused.lstm_wavefront_plain)}


def _params(rng, input_size, hidden, layers):
    p = {}
    for l in range(layers):
        in_l = input_size if l == 0 else hidden
        p[f"weight_ih_l{l}"] = (rng.normal(size=(4 * hidden, in_l)) * 0.2).astype(np.float32)
        p[f"weight_hh_l{l}"] = (rng.normal(size=(4 * hidden, hidden)) * 0.2).astype(np.float32)
        p[f"bias_ih_l{l}"] = (rng.normal(size=(4 * hidden,)) * 0.1).astype(np.float32)
        p[f"bias_hh_l{l}"] = (rng.normal(size=(4 * hidden,)) * 0.1).astype(np.float32)
    return p


def _torch(p, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in p.items()}


def _blocks(p, layers):
    blocks = [p["weight_hh_l0"]]
    for l in range(1, layers):
        blocks += [p[f"weight_ih_l{l}"], p[f"weight_hh_l{l}"]]
    return blocks


def _close(got, ref, atol):
    out, (h, c) = got
    rout, (rh, rc) = ref
    for a, b in ((out, rout), (h, rh), (c, rc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


# ------------------------------------------------------------------ routes


def test_grid_route_by_shape():
    route = lstm_fused.choose_route
    assert route(768, 1) == "grid"    # the velocity head's LSTM
    assert route(256, 3) == "grid" and route(128, 4) == "grid" and route(384, 1) == "grid"
    assert route(128, 3) == "cluster" and route(256, 1) == "cluster"
    assert route(768, 2) == "l2"      # 28 MB of weights: past 132 SMs' shared memory
    assert route(1152, 1) == "l2"     # 144 CTAs: past 132 SMs
    # one CTA's share at H = 768, L = 1: 96 KiB of W_hh columns and 48 KiB
    # of staged h (2 inputs x 8 streams)
    assert lstm_fused.grid_smem_bytes(768, 1) == 96 * 1024 + 48 * 1024
    assert not lstm_fused.grid_fits(192, 1)  # H % 128 != 0


@pytest.mark.parametrize("hidden,most_layers", [
    (128, 7), (256, 3), (384, 2), (512, 2), (768, 1), (1024, 1), (1152, 0)])
def test_grid_fits_up_to_the_shared_memory(hidden, most_layers):
    """grid_fits takes L up to the most whose CTA share fits 227 KB, and the
    cluster route keeps every shape it had (H = 128 with L <= 3, H = 256
    with L = 1)."""
    for layers in range(1, 9):
        assert lstm_fused.grid_fits(hidden, layers) == (layers <= most_layers)
        had_cluster = (hidden, layers) in {(128, 1), (128, 2), (128, 3), (256, 1)}
        assert (lstm_fused.choose_route(hidden, layers) == "cluster") == had_cluster


# ------------------------------------------------------------------ layout


@pytest.mark.parametrize("hidden,layers", [(128, 4), (256, 3), (768, 1)])
def test_grid_pack_unpacks_to_pack_stacked(hidden, layers):
    rng = np.random.default_rng(300 + layers)
    p = _torch(_params(rng, 11, hidden, layers))
    whh_t, wih_t, _ = lstm_fused.pack_stacked(p, layers, hidden)
    wgr = lstm_fused.pack_grid(whh_t, wih_t, hidden, layers)
    assert wgr.shape == (hidden // 8, 2 * layers - 1, 32 * hidden) and wgr.is_contiguous()
    got_hh, got_ih = lstm_fused.unpack_grid(wgr, hidden, layers)
    assert torch.equal(got_hh, whh_t) and torch.equal(got_ih, wih_t)


@pytest.mark.parametrize("hidden,layers", [(256, 3), (768, 1)])
def test_grid_pack_follows_the_kernel_indexing(hidden, layers):
    """Element ((u*H/32 + i)*32 + lane)*4 + gate of CTA b's slice of block m
    is W_m[gate*H + 8b + u][i*32 + lane] (csrc/lstm.cu, grid_advance: warp u,
    lane q reads k = i*32 + q as one float4 of the four gates), for the
    blocks W_hh0, W_ih1, W_hh1, W_ih2, W_hh2 in torch's (4H, H) layout."""
    rng = np.random.default_rng(310 + layers)
    p = _torch(_params(rng, 13, hidden, layers))
    wgr = lstm_fused.pack_grid(*lstm_fused.pack_stacked(p, layers, hidden)[:2], hidden, layers)
    blocks = _blocks(p, layers)
    kk = hidden // 32
    for _ in range(300):
        b, m = rng.integers(hidden // 8), rng.integers(len(blocks))
        u, i, lane, gate = (rng.integers(n) for n in (8, kk, 32, 4))
        idx = ((u * kk + i) * 32 + lane) * 4 + gate
        assert wgr[b, m, idx] == blocks[m][gate * hidden + 8 * b + u, i * 32 + lane]


def test_pack_fills_the_grid_layout_only_where_the_shape_takes_it():
    rng = np.random.default_rng(320)
    for hidden, layers, route in ((128, 3, "cluster"), (256, 3, "grid"), (256, 4, "l2")):
        packed = lstm_fused.pack(_torch(_params(rng, 7, hidden, layers)), layers, hidden)
        assert (packed.cluster is not None) == (route == "cluster")
        assert (packed.grid is not None) == (route == "grid")
    lstm = recurrent.LSTM(768, 768, 1, torch.Generator().manual_seed(2), torch.device("cpu"))
    packed = lstm.packed()
    assert lstm.packed() is packed and packed.cluster is None
    assert packed.grid.shape == (96, 1, 32 * 768)


# --------------------------------------------------- the kernel's bookkeeping


def _warp_reduce(v):
    """The warp reduction of grid_advance on (32 lanes, 4 NG values): sum
    over the lane bits that index no value, then halve the values at each
    remaining bit; lane j ends with value j % (4 NG) in column 0."""
    lanes = np.arange(32)
    nvals = v.shape[1]
    o = 16
    while o >= nvals:
        v = v + v[lanes ^ o]
        o //= 2
    while o >= 1:
        upper = (lanes & o) != 0
        partner = lanes ^ o
        keep = np.where(upper[:, None], v[:, o:2 * o], v[:, :o])
        send = np.where(upper[partner][:, None], v[partner, :o], v[partner, o:2 * o])
        v = keep + send
        o //= 2
    return v[:, 0]


def _mirror_grid(xp0, wgr, bias, h0, c0, wave):
    """numpy mirror of lstm_grid_kernel (f64): per link, each CTA's warps
    stage their streams' h in chunks of 8, sum their lanes' gate columns,
    reduce across the warp, gather each stream's gates and write h into the
    exchange by time parity.  Every link's writes land after the link (the
    grid barrier); a link that reads an exchange slot another CTA writes in
    the same link fails the assert."""
    G, T, _ = xp0.shape
    L, H = h0.shape[1:]
    kk, ctas = H // 32, H // 8
    hx = np.full((2, G, L, H), np.nan)
    out, hn, cn = np.full((G, T, H), np.nan), np.full((G, L, H), np.nan), c0.astype(np.float64)
    lanes = np.arange(32)

    def advance(l, t, writes, reads):
        nin = 1 if l == 0 else 2
        reads.add(((t + 1) % 2, l) if t else ("h0", l))
        if l:
            reads.add((t % 2, l - 1))
        for g0 in range(0, G, 8):
            gc = min(8, G - g0)
            ng = 8 if gc > 4 else 4 if gc > 2 else 2 if gc > 1 else 1
            hs = np.full((2, 8, H), np.nan)  # stale beyond the chunk's streams
            for s in range(gc):
                hs[0, s] = h0[g0 + s, l] if t == 0 else hx[(t + 1) % 2, g0 + s, l]
                if l:
                    hs[1, s] = hx[t % 2, g0 + s, l - 1]
            own = (lanes >> 2) & (ng - 1)
            gate = lanes & 3
            owner = (lanes < 4 * ng) & (own < gc)
            for b in range(ctas):
                for u in range(8):
                    col = 8 * b + u
                    v = np.zeros((32, ng, 4))
                    for k in range(nin):
                        w = wgr[b, 2 * l - k].reshape(8, kk, 32, 4)[u]  # (i, lane, gate)
                        x = hs[k, :ng].reshape(ng, kk, 32)              # (s, i, lane)
                        v += np.einsum("ilg,sil->lsg", w, x)
                    red = _warp_reduce(v.reshape(32, 4 * ng))
                    g = np.minimum(g0 + own, G - 1)
                    xin = (xp0[g, t, gate * H + col] if l == 0
                           else bias[(l - 1) * 4 * H + gate * H + col])
                    pre = red + np.where(owner, xin, 0.0)
                    base = lanes & ~3
                    i_, f_, g_, o_ = (pre[base + j] for j in range(4))
                    sig = lambda z: 1.0 / (1.0 + np.exp(-z))
                    with np.errstate(invalid="ignore", over="ignore"):
                        cv = sig(f_) * cn[g, l, col] + sig(i_) * np.tanh(g_)
                        hv = sig(o_) * np.tanh(cv)
                    for lane in np.flatnonzero(owner):
                        gg = g0 + own[lane]
                        if gate[lane] == 0:
                            writes.append(((t % 2, gg, l, col), hv[lane]))
                        elif gate[lane] == 1:
                            cn[gg, l, col] = cv[lane]
                        elif gate[lane] == 2:
                            hn[gg, l, col] = hv[lane]
                        elif l == L - 1:
                            out[gg, t, col] = hv[lane]

    links = ([[(l, w - l) for l in range(max(0, w - T + 1), min(L - 1, w) + 1)]
              for w in range(T + L - 1)] if wave and T else
             [[(l, t)] for t in range(T) for l in range(L)])
    for link in links:
        writes, reads = [], set()
        for l, t in link:
            advance(l, t, writes, reads)
        assert not reads & {(idx[0], idx[2]) for idx, _ in writes}, "a link reads what it writes"
        for idx, val in writes:
            hx[idx] = val
    if T == 0:
        hn, cn = h0, c0
    return out, hn, cn


@pytest.mark.parametrize("mode", ["stacked", "wavefront"])
@pytest.mark.parametrize("G,T,layers", [(1, 3, 2), (3, 2, 3), (9, 2, 1), (2, 1, 4), (2, 0, 2)])
def test_kernel_bookkeeping_mirror_matches_plain(mode, G, T, layers):
    """The numpy mirror of the kernel (chunks of 8 streams and their partial
    last chunk, the warp reduction, the exchange's parities, K5's
    wavefronts, T = 0) against the plain version."""
    rng = np.random.default_rng(330 + 7 * G + T + layers)
    hidden = 128
    p = _torch(_params(rng, 9, hidden, layers))
    packed = lstm_fused.pack_stacked(p, layers, hidden)
    wgr = lstm_fused.pack_grid(packed[0], packed[1], hidden, layers)
    xp0 = torch.from_numpy(rng.normal(size=(G, T, 4 * hidden)).astype(np.float32))
    h0 = torch.from_numpy((rng.normal(size=(G, layers, hidden)) * 0.5).astype(np.float32))
    c0 = torch.from_numpy((rng.normal(size=(G, layers, hidden)) * 0.5).astype(np.float32))
    got = _mirror_grid(xp0.double().numpy(), wgr.double().numpy(), packed[2].double().numpy(),
                       h0.double().numpy(), c0.double().numpy(), mode == "wavefront")
    ref = KERNELS[mode][1](xp0, *packed, h0, c0)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b.numpy(), atol=ATOL_CARRIED, rtol=0)


# ------------------------------------------------------------ against JAX


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("hidden,layers", [(128, 4), (256, 3)])
@pytest.mark.parametrize("mode", ["stacked", "wavefront"])
def test_grid_plain_versions_match_jax(mode, hidden, layers, carried):
    """Each grid wrapper (its plain version on the CPU, which unpacks the
    grid layout) against the JAX kernel of the same order, two streams, and
    the route as a whole through ``lstm_apply_fused``."""
    rng = np.random.default_rng(340 + hidden + layers + carried)
    G, T, input_size = 2, 5, 19
    p = _params(rng, input_size, hidden, layers)
    x = rng.normal(size=(G, T, input_size)).astype(np.float32)
    if carried:
        h0 = (rng.normal(size=(G, layers, hidden)) * 0.5).astype(np.float32)
        c0 = (rng.normal(size=(G, layers, hidden)) * 0.5).astype(np.float32)
    else:
        h0 = c0 = np.zeros((G, layers, hidden), np.float32)
    atol = ATOL_CARRIED if carried else ATOL
    tp = _torch(p)
    packed = lstm_fused.pack(tp, layers, hidden)
    assert lstm_fused.choose_route(hidden, layers) == "grid" and packed.grid is not None
    xp0 = torch.from_numpy(x) @ tp["weight_ih_l0"].T + tp["bias_ih_l0"] + tp["bias_hh_l0"]
    kernel = KERNELS[mode][0]
    before = kernel.launches
    out, h, c = kernel(xp0, packed.grid, packed.bias, torch.from_numpy(h0), torch.from_numpy(c0))
    fused = lstm_fused.lstm_apply_fused(tp, torch.from_numpy(x),
                                        (torch.from_numpy(h0), torch.from_numpy(c0)),
                                        layers, hidden, mode, packed)
    assert kernel.launches == before  # CPU tensors take the plain version
    for g in range(G):
        ref = jax_lstm_apply_fused({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x[g]),
                                   (jnp.asarray(h0[g]), jnp.asarray(c0[g])),
                                   layers, hidden, mode=mode)
        _close((out[g], (h[g], c[g])), ref, atol)
        _close((fused[0][g], (fused[1][0][g], fused[1][1][g])), ref, atol)


@pytest.mark.parametrize("mode", ["stacked", "wavefront"])
def test_head_shape_matches_jax_scan(mode):
    """(H, L) = (768, 1), the velocity head's LSTM, at T = 3 through the
    grid route against JAX's ``lstm_apply`` (lax.scan)."""
    rng = np.random.default_rng(350)
    T, input_size, hidden = 3, 768, 768
    p = _params(rng, input_size, hidden, 1)
    p = {k: v * 0.25 for k, v in p.items()}  # keep the 768-term sums in tanh's range
    x = rng.normal(size=(T, input_size)).astype(np.float32)
    assert lstm_fused.choose_route(hidden, 1) == "grid"
    got = lstm_fused.lstm_apply_fused(_torch(p), torch.from_numpy(x), None, 1, hidden, mode)
    ref = jax_lstm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), None, 1,
                         hidden)
    _close(got, ref, ATOL)


def test_apply_fused_raises_without_the_routes_layout():
    rng = np.random.default_rng(360)
    tp = _torch(_params(rng, 5, 256, 3))
    packed = lstm_fused.pack(tp, 3, 256)._replace(grid=None)
    with pytest.raises(ValueError, match="'grid' layout"):
        lstm_fused.lstm_apply_fused(tp, torch.zeros(2, 5), None, 3, 256, "stacked", packed)


# ------------------------------------------------------------------ the card


def _problem(device, seed, G, T, hidden, layers, carried=True):
    rng = np.random.default_rng(seed)
    p = _torch(_params(rng, 5, hidden, layers), device)
    if hidden > 256:
        p = {k: v * 0.25 for k, v in p.items()}
    packed = lstm_fused.pack(p, layers, hidden)
    gen = torch.Generator().manual_seed(seed)
    xp0 = torch.randn(G, T, 4 * hidden, generator=gen).to(device)
    h0, c0 = ((torch.randn(G, layers, hidden, generator=gen) * 0.5).to(device)
              if carried else torch.zeros(G, layers, hidden, device=device) for _ in range(2))
    return packed, xp0, h0, c0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["stacked", "wavefront"])
@pytest.mark.parametrize("hidden,layers,G,T", [
    (768, 1, 1, 1), (768, 1, 16, 1), (768, 1, 1, 16), (768, 1, 16, 16), (768, 1, 64, 2),
    (256, 3, 1, 5), (256, 3, 3, 2), (128, 4, 9, 3)])
def test_grid_kernels_match_plain_on_gpu(cuda_device, mode, hidden, layers, G, T):
    kernel, plain = KERNELS[mode]
    for carried, atol in ((False, ATOL), (True, ATOL_CARRIED)):
        packed, xp0, h0, c0 = _problem(cuda_device, 370 + G + T, G, T, hidden, layers, carried)
        before = kernel.launches
        got = kernel(xp0, packed.grid, packed.bias, h0, c0)
        ref = plain(xp0, packed.whh_t, packed.wih_t, packed.bias, h0, c0)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["stacked", "wavefront"])
def test_grid_kernel_replays_in_a_cuda_graph(cuda_device, mode):
    """The cooperative launch captured in a CUDA graph and replayed on new
    inputs: the barrier's count is zeroed at every replay."""
    kernel, plain = KERNELS[mode]
    packed, xp0, h0, c0 = _problem(cuda_device, 380, 16, 4, 768, 1)
    static = [t.clone() for t in (xp0, h0, c0)]
    kernel(static[0], packed.grid, packed.bias, static[1], static[2])  # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        res = kernel(static[0], packed.grid, packed.bias, static[1], static[2])
    for seed in (381, 382, 383):
        _, xp0, h0, c0 = _problem(cuda_device, seed, 16, 4, 768, 1)
        for s, t in zip(static, (xp0, h0, c0)):
            s.copy_(t)
        graph.replay()
        ref = plain(xp0, packed.whh_t, packed.wih_t, packed.bias, h0, c0)
        torch.cuda.synchronize()
        for a, b in zip(res, ref):
            torch.testing.assert_close(a, b, atol=ATOL_CARRIED, rtol=0)


@pytest.mark.gpu
def test_grid_kernel_raises_where_the_launch_is_refused(cuda_device, monkeypatch):
    """A launch the card refuses (cudaErrorCooperativeLaunchTooLarge, 82)
    raises; no other route or plain version runs in its place."""
    packed, xp0, h0, c0 = _problem(cuda_device, 390, 1, 1, 768, 1)

    class Refusing:
        def evfly_lstm_grid(self, *args):
            return 82

        def evfly_error_string(self, status):
            return b"too many blocks in cooperative launch"

    monkeypatch.setattr(_build, "library", lambda *a: Refusing())
    before = [k.launches for k in (lstm_fused.lstm_stacked_grid, lstm_fused.lstm_stacked)]
    with pytest.raises(RuntimeError, match="cooperative"):
        lstm_fused.lstm_apply_fused({"weight_ih_l0": torch.zeros(3072, 4, device=cuda_device)},
                                    torch.zeros(1, 4, device=cuda_device), None, 1, 768,
                                    "stacked", packed)
    assert [k.launches for k in (lstm_fused.lstm_stacked_grid, lstm_fused.lstm_stacked)] == before


@pytest.mark.gpu
def test_stalled_grid_barrier_traps_and_raises(cuda_device):
    """A grid barrier that never opens traps (in a child process, whose CUDA
    context the trap leaves unusable): the launch succeeds, the child's
    synchronize raises."""
    sys.path.insert(0, REPO)
    from chip_smoke import stalled_barrier_run

    rc, text, _ = stalled_barrier_run()
    assert rc != 0 and "launch status 0" in text and "NO TRAP" not in text, text
