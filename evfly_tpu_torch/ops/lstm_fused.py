"""Stacked multi-layer LSTM inference as one CUDA kernel (K4, K5).

Port of ``evfly_tpu/ops/lstm_pallas.py``: the vitfly models run torch
``nn.LSTM`` over an unbatched (T, features) sequence, and step by step that
is T * L dependent matrix-vector products.  Each kernel (``csrc/lstm.cu``)
runs the whole recurrence in one launch, in one of the JAX package's two
orders:

- "stacked" (K4, ``lstm_stacked``, the port of ``_lstm_fused``): time steps,
  advancing layers 0..L-1 inside each;
- "wavefront" (K5, ``lstm_wavefront``, the port of
  ``_lstm_fused_wavefront``): anti-diagonals of the (layer, time) grid, every
  live layer advancing at once on its own time index.

Each order has three routes, chosen by shape (``choose_route``):

- "cluster" (``lstm_stacked_cluster``, ``lstm_wavefront_cluster``): one
  8-CTA cluster per stream with the weights resident in the cluster's shared
  memory, in the layout of ``pack_cluster``; taken by every shape whose
  weights fit (``cluster_fits``: H = 128 with L <= 3, which covers
  ``LSTMNetVIT``'s LSTM, and H = 256 with L = 1);
- "grid" (``lstm_stacked_grid``, ``lstm_wavefront_grid``): one cooperative
  grid of H/8 CTAs for all streams, each holding the gate columns of its 8
  hidden units in shared memory (layout of ``pack_grid``), h exchanged
  through global memory with one grid-wide barrier per link; taken by the
  other shapes whose weights fit up to 132 SMs (``grid_fits``: the velocity
  head's H = 768 with L = 1, H = 256 with L = 2 or 3, H = 128 with L = 4 to 7);
- "l2" (``lstm_stacked``, ``lstm_wavefront``): one block per stream reading
  the weights from L2 on every step, in the layouts of ``pack_stacked``; the
  other shapes with hidden_size % 128 == 0 (e.g. H = 768 with L = 2).

All take a leading stream axis: xp0 (G, T, 4H) and the state (G, L, H), what
``jax.vmap`` over the kernel computes for the batched streaming pipeline; an
unbatched (T, 4H) call is G = 1.  The layer-0 input projection x W_ih0^T + b
is one large matmul and stays outside the kernels (``torch.matmul``), as the
JAX code keeps it outside Pallas.

Each wrapper has a plain PyTorch version (``*_plain``), which CPU tensors
take; ``lstm_apply_fused`` is the drop-in for ``models.recurrent.lstm_apply``
at inference, with ``mode`` defaulting to ``FUSED_LSTM_MODE`` (from
``EVFLY_FLSTM_MODE``, "stacked" when unset, as in the JAX package).  Gates are
ordered (i, f, g, o), as torch packs them; everything is f32.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

Params = Dict[str, torch.Tensor]

FUSED_LSTM_MODE = os.environ.get("EVFLY_FLSTM_MODE", "stacked")

CLUSTER = 8                   # CTAs per stream on the cluster route
_CLUSTER_HIDDEN = (128, 256)  # the hidden sizes the cluster kernels are built for
GRID_UNITS = 8                # hidden units per CTA on the grid route
GRID_STREAMS = 8              # streams whose h one grid CTA stages at once
GRID_MAX_CTAS = 132           # the H100's SMs: at most one grid CTA each
# a block may opt in to 227 KB (232,448 bytes) of shared memory; keep 1 KiB
# for the kernel's static shared variables
_SMEM_LIMIT = 232448 - 1024


def pack_stacked(params: Params, num_layers: int, hidden_size: int):
    """(whh_t (H, L*4H), wih_t (H, (L-1)*4H), bias ((L-1)*4H,)) in the
    kernels' layouts, from torch nn.LSTM state_dict keys."""
    L, H = num_layers, hidden_size
    ref = params["weight_hh_l0"]
    whh_t = torch.cat([params[f"weight_hh_l{l}"].T for l in range(L)], dim=1)
    if L > 1:
        wih_t = torch.cat([params[f"weight_ih_l{l}"].T for l in range(1, L)], dim=1)
    else:
        wih_t = ref.new_zeros(H, 0)
    if "bias_ih_l0" in params and L > 1:
        bias = torch.cat(
            [params[f"bias_ih_l{l}"] + params[f"bias_hh_l{l}"] for l in range(1, L)]
        )
    else:
        bias = ref.new_zeros((L - 1) * 4 * H)
    f32 = torch.float32
    return whh_t.to(f32).contiguous(), wih_t.to(f32).contiguous(), bias.to(f32).contiguous()


def cluster_smem_bytes(hidden_size: int, num_layers: int) -> int:
    """Shared memory of one CTA of the cluster route: its slices of the
    2L - 1 weight blocks, h in two parities, its units' c and biases."""
    H, L = hidden_size, num_layers
    return 4 * ((2 * L - 1) * H * H // 2 + 2 * L * H + L * H // 8 + (L - 1) * 4 * H // 8)


def cluster_fits(hidden_size: int, num_layers: int) -> bool:
    """Whether the cluster route takes (H, L): a built hidden size, and one
    CTA's slice of the weights and state within a block's shared memory.
    The rule of ``csrc/lstm.cu``'s ``cluster_fits``, stated here for the CPU
    where the library is not built (its entry point
    ``evfly_lstm_cluster_fits`` gives the library's)."""
    return (hidden_size in _CLUSTER_HIDDEN and num_layers >= 1
            and cluster_smem_bytes(hidden_size, num_layers) <= _SMEM_LIMIT)


def grid_smem_bytes(hidden_size: int, num_layers: int) -> int:
    """Shared memory of one CTA of the grid route: its slices of the 2L - 1
    weight blocks (4 gates x 8 units x H each) and h staged for
    ``GRID_STREAMS`` streams, two layer inputs."""
    H, L = hidden_size, num_layers
    return 4 * ((2 * L - 1) * 4 * GRID_UNITS * H + 2 * GRID_STREAMS * H)


def grid_fits(hidden_size: int, num_layers: int) -> bool:
    """Whether the grid kernel takes (H, L): H % 128 == 0, its H/8 CTAs
    within the card's 132 SMs, and one CTA's share within a block's shared
    memory.  The rule of ``csrc/lstm.cu``'s ``grid_fits``, for the CPU (its
    entry point ``evfly_lstm_grid_fits`` gives the library's)."""
    H, L = hidden_size, num_layers
    return (H > 0 and H % 128 == 0 and L >= 1 and H // GRID_UNITS <= GRID_MAX_CTAS
            and grid_smem_bytes(H, L) <= _SMEM_LIMIT)


def choose_route(hidden_size: int, num_layers: int) -> str:
    """"cluster" where the weights fit the cluster's shared memory, else
    "grid" where they fit the grid's, else "l2".  Decided by (H, L) alone,
    before any launch: the number of streams does not enter.  The rule of
    ``csrc/lstm.cu``'s ``choose_route`` (entry point ``evfly_lstm_route``)."""
    if cluster_fits(hidden_size, num_layers):
        return "cluster"
    return "grid" if grid_fits(hidden_size, num_layers) else "l2"


def _cluster_view(H: int):
    # (gate, rank, warp, unit parity, i4, e, q) of a block's (4H, H) torch
    # layout: column gate*H + rank*H/8 + 2*warp + parity, k = (4*i4 + e)*16 + q
    return (4, CLUSTER, H // 16, 2, H // 64, 4, 16)


_TO_CLUSTER = (1, 2, 0, 4, 3, 6, 5)    # -> (rank, warp, gate, i4, parity, q, e)
_FROM_CLUSTER = (2, 0, 1, 4, 3, 6, 5)  # and back


def pack_cluster(whh_t: torch.Tensor, wih_t: torch.Tensor, hidden_size: int,
                 num_layers: int) -> torch.Tensor:
    """The cluster route's weights (8, 2L - 1, H*H/2) from ``pack_stacked``'s
    whh_t and wih_t: for each rank r, one contiguous block holding its
    slices of W_hh0, W_ih1, W_hh1, W_ih2, ... in that order.  A slice holds
    the four gate columns of the rank's H/8 hidden units, ordered so that
    thread (unit, q) of the kernel reads its k = i*16 + q as float4s that a
    warp loads contiguously (``csrc/lstm.cu``, ``ClusterShape``)."""
    H, L = hidden_size, num_layers
    slices = [b.reshape(_cluster_view(H)).permute(_TO_CLUSTER).reshape(CLUSTER, H * H // 2)
              for b in _weight_blocks(whh_t, wih_t, H, L)]
    return torch.stack(slices, 1).to(torch.float32).contiguous()


def unpack_cluster(wcl: torch.Tensor, hidden_size: int, num_layers: int):
    """(whh_t, wih_t) in ``pack_stacked``'s layouts from ``pack_cluster``'s."""
    H, L = hidden_size, num_layers
    view = [_cluster_view(H)[d] for d in _TO_CLUSTER]
    blocks = [wcl[:, m].reshape(view).permute(_FROM_CLUSTER).reshape(4 * H, H)
              for m in range(2 * L - 1)]
    return _stacked_from_blocks(blocks, H, L, wcl)


def _weight_blocks(whh_t: torch.Tensor, wih_t: torch.Tensor, H: int, L: int):
    """The blocks W_hh0, W_ih1, W_hh1, W_ih2, ... in torch's (4H, H) layout
    from ``pack_stacked``'s whh_t and wih_t."""
    G = 4 * H
    blocks = [whh_t[:, :G].T]
    for l in range(1, L):
        blocks += [wih_t[:, (l - 1) * G:l * G].T, whh_t[:, l * G:(l + 1) * G].T]
    return blocks


def _stacked_from_blocks(blocks, H: int, L: int, like: torch.Tensor):
    """``pack_stacked``'s (whh_t, wih_t) from ``_weight_blocks``' list."""
    whh_t = torch.cat([blocks[0].T] + [blocks[2 * l].T for l in range(1, L)], dim=1)
    wih_t = (torch.cat([blocks[2 * l - 1].T for l in range(1, L)], dim=1) if L > 1
             else like.new_zeros(H, 0))
    return whh_t.contiguous(), wih_t.contiguous()


def _grid_view(H: int):
    # (gate, cta, unit, i, lane) of a block's (4H, H) torch layout: column
    # gate*H + cta*8 + unit, k = i*32 + lane
    return (4, H // GRID_UNITS, GRID_UNITS, H // 32, 32)


_TO_GRID = (1, 2, 3, 4, 0)    # -> (cta, unit, i, lane, gate)
_FROM_GRID = (4, 0, 1, 2, 3)  # and back


def pack_grid(whh_t: torch.Tensor, wih_t: torch.Tensor, hidden_size: int,
              num_layers: int) -> torch.Tensor:
    """The grid route's weights (H/8, 2L - 1, 32H) from ``pack_stacked``'s
    whh_t and wih_t: for each CTA b, one contiguous block holding its slices
    of W_hh0, W_ih1, W_hh1, W_ih2, ... in that order.  A slice holds the four
    gate columns of hidden units 8b .. 8b + 7, as float4s of the four gates
    ordered (unit, i, lane) so that lane q of warp u reads k = i*32 + q as
    one float4 and a warp's loads are 512 contiguous bytes
    (``csrc/lstm.cu``, ``grid_advance``)."""
    H, L = hidden_size, num_layers
    slices = [b.reshape(_grid_view(H)).permute(_TO_GRID).reshape(H // GRID_UNITS, 32 * H)
              for b in _weight_blocks(whh_t, wih_t, H, L)]
    return torch.stack(slices, 1).to(torch.float32).contiguous()


def unpack_grid(wgr: torch.Tensor, hidden_size: int, num_layers: int):
    """(whh_t, wih_t) in ``pack_stacked``'s layouts from ``pack_grid``'s."""
    H, L = hidden_size, num_layers
    view = [_grid_view(H)[d] for d in _TO_GRID]
    blocks = [wgr[:, m].reshape(view).permute(_FROM_GRID).reshape(4 * H, H)
              for m in range(2 * L - 1)]
    return _stacked_from_blocks(blocks, H, L, wgr)


class Packed(NamedTuple):
    """A module's weights in the kernels' layouts: ``pack_stacked``'s and,
    where the shape takes the cluster route, ``pack_cluster``'s, or where it
    takes the grid route, ``pack_grid``'s."""
    whh_t: torch.Tensor
    wih_t: torch.Tensor
    bias: torch.Tensor
    cluster: Optional[torch.Tensor]
    grid: Optional[torch.Tensor]


def pack(params: Params, num_layers: int, hidden_size: int) -> Packed:
    whh_t, wih_t, bias = pack_stacked(params, num_layers, hidden_size)
    route = choose_route(hidden_size, num_layers)
    wcl = pack_cluster(whh_t, wih_t, hidden_size, num_layers) if route == "cluster" else None
    wgr = pack_grid(whh_t, wih_t, hidden_size, num_layers) if route == "grid" else None
    return Packed(whh_t, wih_t, bias, wcl, wgr)


def _cell(gates: torch.Tensor, c: torch.Tensor, H: int):
    i, f, g, o = gates.split(H, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _layer_gates(l: int, xp_t, h_below, h_own, whh_t, wih_t, bias):
    """Gates (..., 4H) of layer l from the layer-0 gates at its time step
    (layer 0), the input from the layer below (layers >= 1) and its own h."""
    G = xp_t.shape[-1]
    rec = h_own @ whh_t[:, l * G:(l + 1) * G]
    if l == 0:
        return xp_t + rec
    return (h_below @ wih_t[:, (l - 1) * G:l * G] + bias[(l - 1) * G:l * G]) + rec


def _streams(xp0, h0, c0):
    """(xp0, h0, c0) with a leading stream axis, and whether it was added."""
    if xp0.dim() == 2:
        return xp0[None], h0[None], c0[None], True
    return xp0, h0, c0, False


def lstm_stacked_plain(xp0, whh_t, wih_t, bias, h0, c0):
    """Plain PyTorch version of K4: (out (G, T, H), h_n (G, L, H), c_n
    (G, L, H)); without the stream axis, (T, H), (L, H), (L, H)."""
    xp0, h0, c0, squeeze = _streams(xp0, h0, c0)
    S, T, _ = xp0.shape
    H = h0.shape[-1]
    hs, cs = list(h0.unbind(1)), list(c0.unbind(1))
    outs = []
    for t in range(T):
        for l in range(len(hs)):
            gates = _layer_gates(l, xp0[:, t], hs[l - 1] if l else None, hs[l],
                                 whh_t, wih_t, bias)
            hs[l], cs[l] = _cell(gates, cs[l], H)
        outs.append(hs[-1])
    out = torch.stack(outs, 1) if outs else xp0.new_zeros(S, 0, H)
    hn, cn = torch.stack(hs, 1), torch.stack(cs, 1)
    return (out[0], hn[0], cn[0]) if squeeze else (out, hn, cn)


def lstm_wavefront_plain(xp0, whh_t, wih_t, bias, h0, c0):
    """Plain PyTorch version of K5, the wavefront order: on wavefront w each
    layer l with 0 <= w - l < T advances from the state wavefront w - 1
    left.  Shapes as ``lstm_stacked_plain``."""
    xp0, h0, c0, squeeze = _streams(xp0, h0, c0)
    S, T, _ = xp0.shape
    L, H = h0.shape[1], h0.shape[2]
    hs, cs = list(h0.unbind(1)), list(c0.unbind(1))
    out = xp0.new_zeros(S, T, H)
    for w in range(T + L - 1):
        live = range(max(0, w - T + 1), min(L - 1, w) + 1)
        new = {
            l: _cell(_layer_gates(l, xp0[:, min(w, T - 1)], hs[l - 1] if l else None, hs[l],
                                  whh_t, wih_t, bias), cs[l], H)
            for l in live
        }
        for l, (h, c) in new.items():
            hs[l], cs[l] = h, c
        if L - 1 in new:
            out[:, w - (L - 1)] = new[L - 1][0]
    hn, cn = torch.stack(hs, 1), torch.stack(cs, 1)
    return (out[0], hn[0], cn[0]) if squeeze else (out, hn, cn)


def lstm_stacked_cluster_plain(xp0, wcl, bias, h0, c0):
    """Plain PyTorch version of K4 on the cluster route: ``lstm_stacked_plain``
    on the weights that ``wcl`` holds."""
    L, H = h0.shape[-2], h0.shape[-1]
    return lstm_stacked_plain(xp0, *unpack_cluster(wcl, H, L), bias, h0, c0)


def lstm_wavefront_cluster_plain(xp0, wcl, bias, h0, c0):
    """Plain PyTorch version of K5 on the cluster route."""
    L, H = h0.shape[-2], h0.shape[-1]
    return lstm_wavefront_plain(xp0, *unpack_cluster(wcl, H, L), bias, h0, c0)


def lstm_stacked_grid_plain(xp0, wgr, bias, h0, c0):
    """Plain PyTorch version of K4 on the grid route: ``lstm_stacked_plain``
    on the weights that ``wgr`` holds."""
    L, H = h0.shape[-2], h0.shape[-1]
    return lstm_stacked_plain(xp0, *unpack_grid(wgr, H, L), bias, h0, c0)


def lstm_wavefront_grid_plain(xp0, wgr, bias, h0, c0):
    """Plain PyTorch version of K5 on the grid route."""
    L, H = h0.shape[-2], h0.shape[-1]
    return lstm_wavefront_plain(xp0, *unpack_grid(wgr, H, L), bias, h0, c0)


def _launch(name: str, fn, xp0, weights, h0, c0, *extra, scratch=None):
    """Check the inputs of a K4 or K5 route on CUDA, launch ``fn`` of the
    kernel library and return its outputs in the inputs' stream layout.
    ``weights(L, H)`` gives the route's weight arguments and bias as
    {name: (tensor, expected shape)}, in the order of the C entry point;
    ``scratch(S, L, H, device)``, where given, the tensors the kernel works
    in, passed after out, hn and cn and allocated on the launch stream."""
    if xp0.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xp0.device}")
    xp0, h0, c0, squeeze = _streams(xp0, h0, c0)
    S, T, G4 = xp0.shape
    L, H = h0.shape[1], h0.shape[2]
    if H % 128 != 0:
        raise ValueError(f"{name} needs hidden_size % 128 == 0, got {H}")
    expected = {"xp0": (xp0, (S, T, 4 * H)), **weights(L, H),
                "h0": (h0, (S, L, H)), "c0": (c0, (S, L, H))}
    for arg, (t, shape) in expected.items():
        if tuple(t.shape) != shape or t.device != xp0.device:
            raise ValueError(
                f"{name}: {arg} is {tuple(t.shape)} on {t.device}, "
                f"expected {shape} on {xp0.device}"
            )
    if torch.is_grad_enabled() and any(t.requires_grad for t, _ in expected.values()):
        raise RuntimeError(f"{name} has no backward; call it under torch.no_grad()")
    args = {arg: t.to(torch.float32).contiguous() for arg, (t, _) in expected.items()}
    for arg in ("wcl", "wgr"):
        if arg in args and args[arg].data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned (the source of bulk copies)")
    if "wgr" in args and args["h0"].data_ptr() % 16:
        args["h0"] = args["h0"].clone()  # the grid kernel stages h0 as float4s
    with torch.cuda.device(xp0.device):
        out = torch.empty(S, T, H, dtype=torch.float32, device=xp0.device)
        hn = torch.empty(S, L, H, dtype=torch.float32, device=xp0.device)
        cn = torch.empty(S, L, H, dtype=torch.float32, device=xp0.device)
        work = [] if scratch is None else scratch(S, L, H, xp0.device)
        status = fn(
            *(a.data_ptr() for a in args.values()), out.data_ptr(), hn.data_ptr(), cn.data_ptr(),
            *(t.data_ptr() for t in work), S, T, H, L, *extra, _build.stream_of(xp0.device),
        )
    _build.check(name, status)
    return (out[0], hn[0], cn[0]) if squeeze else (out, hn, cn)


def _l2_weights(whh_t, wih_t, bias):
    return lambda L, H: {
        "whh_t": (whh_t, (H, L * 4 * H)), "wih_t": (wih_t, (H, (L - 1) * 4 * H)),
        "bias": (bias, ((L - 1) * 4 * H,)),
    }


def _cluster_weights(name, wcl, bias):
    def weights(L, H):
        if not cluster_fits(H, L):
            raise ValueError(f"{name}: (H, L) = ({H}, {L}) does not fit the cluster route")
        return {"wcl": (wcl, (CLUSTER, 2 * L - 1, H * H // 2)),
                "bias": (bias, ((L - 1) * 4 * H,))}
    return weights


def _grid_weights(name, wgr, bias):
    def weights(L, H):
        if not grid_fits(H, L):
            raise ValueError(f"{name}: (H, L) = ({H}, {L}) does not fit the grid route")
        return {"wgr": (wgr, (H // GRID_UNITS, 2 * L - 1, 32 * H)),
                "bias": (bias, ((L - 1) * 4 * H,))}
    return weights


def _grid_scratch(S: int, L: int, H: int, device):
    """The grid kernel's h exchange (2, S, L, H), written before it is read,
    and its barrier's arrival count, zeroed on the launch stream (inside a
    CUDA graph, at every replay)."""
    return [torch.empty(2, S, L, H, dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device)]


def lstm_stacked(xp0, whh_t, wih_t, bias, h0, c0):
    """K4 on the L2 route: (out, h_n, c_n) from the layouts of
    ``pack_stacked``, the layer-0 gates ``xp0`` (G, T, 4H) and the state
    (G, L, H) of G streams, or (T, 4H) and (L, H) for one sequence.

    CPU tensors take ``lstm_stacked_plain``; CUDA tensors launch the kernel
    or raise.  The kernel has no backward: under autograd the wrapper raises
    for inputs that require grad.  ``lstm_stacked.launches`` counts launches.
    """
    if xp0.device.type == "cpu":
        return lstm_stacked_plain(xp0, whh_t, wih_t, bias, h0, c0)
    res = _launch("lstm_stacked", _build.library().evfly_lstm_stacked, xp0,
                  _l2_weights(whh_t, wih_t, bias), h0, c0)
    lstm_stacked.launches += 1
    return res


lstm_stacked.launches = 0


def lstm_wavefront(xp0, whh_t, wih_t, bias, h0, c0):
    """K5 on the L2 route: ``lstm_stacked``'s function in the wavefront
    order, with the same arguments and results.

    CPU tensors take ``lstm_wavefront_plain``; CUDA tensors launch the
    kernel or raise.  ``lstm_wavefront.launches`` counts launches.
    """
    if xp0.device.type == "cpu":
        return lstm_wavefront_plain(xp0, whh_t, wih_t, bias, h0, c0)
    res = _launch("lstm_wavefront", _build.library().evfly_lstm_wavefront, xp0,
                  _l2_weights(whh_t, wih_t, bias), h0, c0)
    lstm_wavefront.launches += 1
    return res


lstm_wavefront.launches = 0


def lstm_stacked_cluster(xp0, wcl, bias, h0, c0):
    """K4 on the cluster route: ``lstm_stacked``'s function with the weights
    in ``pack_cluster``'s layout ``wcl``; (H, L) must satisfy
    ``cluster_fits``.

    CPU tensors take ``lstm_stacked_cluster_plain``; CUDA tensors launch the
    kernel (one 8-CTA cluster per stream) or raise.
    ``lstm_stacked_cluster.launches`` counts launches.
    """
    if xp0.device.type == "cpu":
        return lstm_stacked_cluster_plain(xp0, wcl, bias, h0, c0)
    name = "lstm_stacked_cluster"
    res = _launch(name, _build.library().evfly_lstm_cluster, xp0,
                  _cluster_weights(name, wcl, bias), h0, c0, 0)
    lstm_stacked_cluster.launches += 1
    return res


lstm_stacked_cluster.launches = 0


def lstm_wavefront_cluster(xp0, wcl, bias, h0, c0):
    """K5 on the cluster route, with ``lstm_stacked_cluster``'s arguments.

    CPU tensors take ``lstm_wavefront_cluster_plain``; CUDA tensors launch
    the kernel or raise.  ``lstm_wavefront_cluster.launches`` counts
    launches.
    """
    if xp0.device.type == "cpu":
        return lstm_wavefront_cluster_plain(xp0, wcl, bias, h0, c0)
    name = "lstm_wavefront_cluster"
    res = _launch(name, _build.library().evfly_lstm_cluster, xp0,
                  _cluster_weights(name, wcl, bias), h0, c0, 1)
    lstm_wavefront_cluster.launches += 1
    return res


lstm_wavefront_cluster.launches = 0


def lstm_stacked_grid(xp0, wgr, bias, h0, c0):
    """K4 on the grid route: ``lstm_stacked``'s function with the weights in
    ``pack_grid``'s layout ``wgr``; (H, L) must satisfy ``grid_fits``.

    CPU tensors take ``lstm_stacked_grid_plain``; CUDA tensors launch the
    kernel (one cooperative grid of H/8 CTAs for all streams) or raise,
    also where the card refuses the cooperative launch.
    ``lstm_stacked_grid.launches`` counts launches.
    """
    if xp0.device.type == "cpu":
        return lstm_stacked_grid_plain(xp0, wgr, bias, h0, c0)
    name = "lstm_stacked_grid"
    res = _launch(name, _build.library().evfly_lstm_grid, xp0, _grid_weights(name, wgr, bias),
                  h0, c0, 0, scratch=_grid_scratch)
    lstm_stacked_grid.launches += 1
    return res


lstm_stacked_grid.launches = 0


def lstm_wavefront_grid(xp0, wgr, bias, h0, c0):
    """K5 on the grid route, with ``lstm_stacked_grid``'s arguments.

    CPU tensors take ``lstm_wavefront_grid_plain``; CUDA tensors launch the
    kernel or raise.  ``lstm_wavefront_grid.launches`` counts launches.
    """
    if xp0.device.type == "cpu":
        return lstm_wavefront_grid_plain(xp0, wgr, bias, h0, c0)
    name = "lstm_wavefront_grid"
    res = _launch(name, _build.library().evfly_lstm_grid, xp0, _grid_weights(name, wgr, bias),
                  h0, c0, 1, scratch=_grid_scratch)
    lstm_wavefront_grid.launches += 1
    return res


lstm_wavefront_grid.launches = 0


def cluster_occupancy(hidden_size: int, num_layers: int, mode: str) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster kernel of ``mode``
    at (H, L) on the current device: how many 8-CTA clusters run at once."""
    n = ctypes.c_int(0)
    status = _build.library().evfly_lstm_cluster_occupancy(
        hidden_size, num_layers, int(mode == "wavefront"), ctypes.byref(n))
    _build.check("evfly_lstm_cluster_occupancy", status)
    return n.value


def grid_occupancy(hidden_size: int, num_layers: int, mode: str) -> int:
    """``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of the grid kernel
    of ``mode`` at (H, L) on the current device: its CTAs per SM."""
    n = ctypes.c_int(0)
    status = _build.library().evfly_lstm_grid_occupancy(
        hidden_size, num_layers, int(mode == "wavefront"), ctypes.byref(n))
    _build.check("evfly_lstm_grid_occupancy", status)
    return n.value


_KERNELS = {
    ("stacked", "l2"): lstm_stacked, ("wavefront", "l2"): lstm_wavefront,
    ("stacked", "cluster"): lstm_stacked_cluster,
    ("wavefront", "cluster"): lstm_wavefront_cluster,
    ("stacked", "grid"): lstm_stacked_grid, ("wavefront", "grid"): lstm_wavefront_grid,
}


def lstm_apply_fused(
    params: Params,
    x: torch.Tensor,  # (T, input_size) or (G, T, input_size)
    hidden: Optional[Tuple[torch.Tensor, torch.Tensor]],
    num_layers: int,
    hidden_size: int,
    mode: Optional[str] = None,
    packed: Optional[Packed] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Inference drop-in for ``models.recurrent.lstm_apply``: the same
    params (nn.LSTM state_dict keys) and return (out (T, H), (h_n, c_n)
    each (L, H)), or with a leading stream axis G on x, the state and every
    result.  mode: "stacked" (K4) or "wavefront" (K5); None takes
    ``FUSED_LSTM_MODE``.  packed: the params in the kernels' layouts
    (``pack``), packed here when None.  The route is ``choose_route``'s, by
    shape.  Requires hidden_size % 128 == 0 on CUDA."""
    mode = FUSED_LSTM_MODE if mode is None else mode
    L, H = num_layers, hidden_size
    route = choose_route(H, L)
    if (mode, route) not in _KERNELS:
        raise ValueError(f"unknown fused-LSTM mode {mode!r}")
    if hidden is None:
        h0 = x.new_zeros(*x.shape[:-2], L, H, dtype=torch.float32)
        c0 = x.new_zeros(*x.shape[:-2], L, H, dtype=torch.float32)
    else:
        h0, c0 = hidden
    # layer-0 input projection: one large matmul, outside the kernel
    xp0 = torch.matmul(x.to(torch.float32), params["weight_ih_l0"].T)
    if "bias_ih_l0" in params:
        xp0 = xp0 + params["bias_ih_l0"] + params["bias_hh_l0"]
    if packed is None:
        packed = pack(params, L, H)
    weights = {"cluster": (packed.cluster, packed.bias), "grid": (packed.grid, packed.bias),
               "l2": (packed.whh_t, packed.wih_t, packed.bias)}[route]
    if weights[0] is None:
        raise ValueError(f"the packed weights have no {route!r} layout (lstm_fused.pack)")
    out, hn, cn = _KERNELS[(mode, route)](xp0, *weights, h0, c0)
    return out.to(x.dtype), (hn.to(x.dtype), cn.to(x.dtype))
