"""Stacked multi-layer LSTM inference as one CUDA kernel (K4).

Port of ``evfly_tpu/ops/lstm_pallas.py`` in its "stacked" mode: the vitfly
models run torch ``nn.LSTM`` over an unbatched (T, features) sequence, and
step by step that is T * L dependent matrix-vector products.  The kernel
(``csrc/lstm.cu``, the port of ``_lstm_fused``) runs the whole recurrence in
one launch, advancing layers 0..L-1 at each time step.  The layer-0 input
projection x W_ih0^T + b is one large matmul and stays outside the kernel
(``torch.matmul``), as the JAX code keeps it outside Pallas.

``lstm_stacked`` is the kernel's wrapper, ``lstm_stacked_plain`` its plain
PyTorch version (what CPU tensors take), and ``lstm_apply_fused`` the
drop-in for ``models.recurrent.lstm_apply`` at inference.  Gates are ordered
(i, f, g, o), as torch packs them; everything is f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build

Params = Dict[str, torch.Tensor]


def pack_stacked(params: Params, num_layers: int, hidden_size: int):
    """(whh_t (H, L*4H), wih_t (H, (L-1)*4H), bias ((L-1)*4H,)) in the
    kernel's layouts, from torch nn.LSTM state_dict keys."""
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


def lstm_stacked_plain(xp0, whh_t, wih_t, bias, h0, c0):
    """Plain PyTorch version of K4: (out (T, H), h_n (L, H), c_n (L, H))."""
    T, G = xp0.shape
    L, H = h0.shape
    hs = list(h0.unbind(0))
    cs = list(c0.unbind(0))
    outs = []
    for t in range(T):
        inp = None
        for l in range(L):
            if l == 0:
                gates = xp0[t]
            else:
                gates = inp @ wih_t[:, (l - 1) * G:l * G] + bias[(l - 1) * G:l * G]
            gates = gates + hs[l] @ whh_t[:, l * G:(l + 1) * G]
            i, f, g, o = gates.split(H)
            c = torch.sigmoid(f) * cs[l] + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs[l], cs[l] = h, c
            inp = h
        outs.append(inp)
    out = torch.stack(outs) if outs else xp0.new_zeros(0, H)
    return out, torch.stack(hs), torch.stack(cs)


def lstm_stacked(xp0, whh_t, wih_t, bias, h0, c0):
    """K4: (out (T, H), h_n (L, H), c_n (L, H)) from the layouts of
    ``pack_stacked`` and the layer-0 gates ``xp0`` (T, 4H).

    CPU tensors take ``lstm_stacked_plain``; CUDA tensors launch the kernel
    or raise.  The kernel has no backward: under autograd the wrapper raises
    for inputs that require grad.  ``lstm_stacked.launches`` counts launches.
    """
    if xp0.device.type == "cpu":
        return lstm_stacked_plain(xp0, whh_t, wih_t, bias, h0, c0)
    if xp0.device.type != "cuda":
        raise ValueError(f"lstm_stacked: unsupported device {xp0.device}")
    L, H = h0.shape
    T, G = xp0.shape
    if H % 128 != 0:
        raise ValueError(f"lstm_stacked needs hidden_size % 128 == 0, got {H}")
    expected = {
        "xp0": (xp0, (T, 4 * H)), "whh_t": (whh_t, (H, L * 4 * H)),
        "wih_t": (wih_t, (H, (L - 1) * 4 * H)), "bias": (bias, ((L - 1) * 4 * H,)),
        "h0": (h0, (L, H)), "c0": (c0, (L, H)),
    }
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape or t.device != xp0.device:
            raise ValueError(
                f"lstm_stacked: {name} is {tuple(t.shape)} on {t.device}, "
                f"expected {shape} on {xp0.device}"
            )
    if torch.is_grad_enabled() and any(t.requires_grad for t, _ in expected.values()):
        raise RuntimeError("lstm_stacked has no backward; call it under torch.no_grad()")
    args = [t.to(torch.float32).contiguous() for t, _ in expected.values()]
    out = torch.empty(T, H, dtype=torch.float32, device=xp0.device)
    hn = torch.empty(L, H, dtype=torch.float32, device=xp0.device)
    cn = torch.empty(L, H, dtype=torch.float32, device=xp0.device)
    lib = _build.library()
    with torch.cuda.device(xp0.device):
        status = lib.evfly_lstm_stacked(
            *(a.data_ptr() for a in args), out.data_ptr(), hn.data_ptr(), cn.data_ptr(),
            T, H, L, _build.stream_of(xp0.device),
        )
    _build.check("evfly_lstm_stacked", status)
    lstm_stacked.launches += 1
    return out, hn, cn


lstm_stacked.launches = 0


def lstm_apply_fused(
    params: Params,
    x: torch.Tensor,  # (T, input_size)
    hidden: Optional[Tuple[torch.Tensor, torch.Tensor]],
    num_layers: int,
    hidden_size: int,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Inference drop-in for ``models.recurrent.lstm_apply``: the same
    params (nn.LSTM state_dict keys) and return (out (T, H), (h_n, c_n)
    each (L, H)).  Requires hidden_size % 128 == 0 on CUDA."""
    L, H = num_layers, hidden_size
    if hidden is None:
        h0 = x.new_zeros(L, H, dtype=torch.float32)
        c0 = x.new_zeros(L, H, dtype=torch.float32)
    else:
        h0, c0 = hidden
    # layer-0 input projection: one large matmul, outside the kernel
    xp0 = torch.matmul(x.to(torch.float32), params["weight_ih_l0"].T)
    if "bias_ih_l0" in params:
        xp0 = xp0 + params["bias_ih_l0"] + params["bias_hh_l0"]
    whh_t, wih_t, bias = pack_stacked(params, L, H)
    out, hn, cn = lstm_stacked(xp0, whh_t, wih_t, bias, h0, c0)
    return out.to(x.dtype), (hn.to(x.dtype), cn.to(x.dtype))
