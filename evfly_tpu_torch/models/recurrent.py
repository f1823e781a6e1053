"""torch nn.LSTM over unbatched (T, features) sequences.

Port of ``lstm_apply`` and ``set_fused_lstm`` of
``evfly_tpu/models/recurrent.py``.  The vitfly models run their LSTM over the
window axis as its time axis, so hidden states are (num_layers, hidden_size).
Gates are ordered (i, f, g, o), as torch packs them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.lstm_fused import lstm_apply_fused
from .common import ParamLeaf, Params, init_lstm

_USE_FUSED_LSTM = True


def set_fused_lstm(enabled: bool) -> None:
    """Let eligible ``lstm_apply`` calls run as the single-kernel recurrence
    (K4, ``ops.lstm_fused``).  On by default; off runs the plain loop on the
    card too, which is how a caller compares the two."""
    global _USE_FUSED_LSTM
    _USE_FUSED_LSTM = enabled


def lstm_apply(
    params: Params,
    x: torch.Tensor,  # (T, input_size)
    hidden: Optional[Tuple[torch.Tensor, torch.Tensor]],  # (num_layers, H) each
    num_layers: int,
    hidden_size: int,
    dropout_p: float = 0.0,
    train: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Multi-layer LSTM over an unbatched sequence; returns (out, (h_n, c_n)).

    Inference on CUDA with hidden_size % 128 == 0 goes through kernel K4
    (the routing rule of the JAX package, plus the device).  Otherwise this
    is the plain loop, with torch's inter-layer dropout when training.
    """
    if _USE_FUSED_LSTM and not train and hidden_size % 128 == 0 and x.is_cuda:
        return lstm_apply_fused(params, x, hidden, num_layers, hidden_size)
    if hidden is None:
        h0 = x.new_zeros(num_layers, hidden_size)
        c0 = x.new_zeros(num_layers, hidden_size)
    else:
        h0, c0 = hidden

    seq = x
    h_finals: List[torch.Tensor] = []
    c_finals: List[torch.Tensor] = []
    for layer in range(num_layers):
        w_hh_t = params[f"weight_hh_l{layer}"].T
        # the input projection of the whole sequence is one matmul
        x_proj = torch.matmul(seq, params[f"weight_ih_l{layer}"].T)
        if f"bias_ih_l{layer}" in params:
            x_proj = x_proj + (params[f"bias_ih_l{layer}"] + params[f"bias_hh_l{layer}"])
        h, c = h0[layer], c0[layer]
        outs = []
        for t in range(x_proj.shape[0]):
            gates = x_proj[t] + torch.matmul(h, w_hh_t)
            i, f, g, o = gates.split(hidden_size)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        h_finals.append(h)
        c_finals.append(c)
        seq = torch.stack(outs) if outs else x_proj.new_zeros(0, hidden_size)
        if layer < num_layers - 1 and dropout_p > 0.0 and train:
            seq = F.dropout(seq, dropout_p, training=True)
    return seq, (torch.stack(h_finals), torch.stack(c_finals))


class LSTM(ParamLeaf):
    """torch nn.LSTM over an unbatched (T, input_size) sequence, with its
    state_dict keys (``weight_ih_l0``, ...)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, gen, device,
                 bias: bool = True, dropout: float = 0.0):
        super().__init__(init_lstm(gen, input_size, hidden_size, num_layers, bias), device)
        self.hidden_size, self.num_layers, self.dropout = hidden_size, num_layers, dropout

    def forward(self, x, hidden=None):
        return lstm_apply(
            dict(self.named_parameters()), x, hidden, self.num_layers, self.hidden_size,
            self.dropout, self.training,
        )
