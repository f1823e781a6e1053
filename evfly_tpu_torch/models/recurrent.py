"""Recurrent cells: torch nn.LSTM over unbatched sequences, and ConvLSTM.

Port of ``lstm_apply``, ``set_fused_lstm``, ``init_convlstm``,
``convlstm_apply`` and ``convlstm_init_hidden`` of
``evfly_tpu/models/recurrent.py``.  The vitfly models run their LSTM over the
window axis as its time axis, so hidden states are (num_layers, hidden_size);
with a leading stream axis (G streams stepped together) they are
(G, num_layers, hidden_size).  OrigUNet runs a 1x1-kernel ConvLSTM over its
bottleneck.  Gate orders differ, as in the reference: nn.LSTM packs
(i, f, g, o), the vendored ConvLSTM (i, f, o, g).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import imageops, lstm_fused
from .common import ParamLeaf, Params, init_conv2d, init_lstm, prefix_params, sub

_USE_FUSED_LSTM = True


def set_fused_lstm(enabled: bool) -> None:
    """Let eligible ``lstm_apply`` calls run as a single-kernel recurrence
    (K4 or K5, ``ops.lstm_fused``).  On by default, unlike the JAX package,
    whose default is off: the results are the same, and on the card the
    kernels are then on the path.  Off runs the plain loop on the card too,
    which is how a caller compares the two."""
    global _USE_FUSED_LSTM
    _USE_FUSED_LSTM = enabled


def fused_lstm_enabled() -> bool:
    """What ``set_fused_lstm`` last set."""
    return _USE_FUSED_LSTM


def _needs_grad(params: Params, x: torch.Tensor, hidden) -> bool:
    """Whether autograd would record this call: grad mode on and the input,
    the state or a parameter requiring grad."""
    if not torch.is_grad_enabled():
        return False
    tensors = [x, *params.values(), *(hidden if hidden is not None else ())]
    return any(t.requires_grad for t in tensors)


def fused_wanted(params: Params, x: torch.Tensor, hidden, hidden_size: int,
                 train: bool) -> bool:
    """Whether ``lstm_apply`` takes the fused kernel for a CUDA input:
    ``set_fused_lstm`` on, inference (not ``train``), hidden_size % 128 == 0,
    and no gradient needed, since the kernels have no backward.  An
    eval-mode forward under autograd takes the plain loop, which is
    differentiable, as the JAX package's eval-mode apply is."""
    return (fused_lstm_enabled() and not train and hidden_size % 128 == 0
            and not _needs_grad(params, x, hidden))


def lstm_apply(
    params: Params,
    x: torch.Tensor,  # (T, input_size) or (G, T, input_size)
    hidden: Optional[Tuple[torch.Tensor, torch.Tensor]],  # (num_layers, H) or (G, num_layers, H)
    num_layers: int,
    hidden_size: int,
    dropout_p: float = 0.0,
    train: bool = False,
    mode: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Multi-layer LSTM over an unbatched sequence, or G of them with a
    leading stream axis; returns (out, (h_n, c_n)).

    A CUDA input goes through kernel K4, or K5 with ``mode="wavefront"``,
    where ``fused_wanted`` allows it (the routing rule of the JAX package,
    plus the device and the need for a gradient; ``mode`` None takes
    ``lstm_fused.FUSED_LSTM_MODE``).  Otherwise this is ``lstm_loop``.
    """
    if x.is_cuda and fused_wanted(params, x, hidden, hidden_size, train):
        return lstm_fused.lstm_apply_fused(params, x, hidden, num_layers, hidden_size, mode)
    return lstm_loop(params, x, hidden, num_layers, hidden_size, dropout_p, train, generator)


def lstm_loop(
    params: Params,
    x: torch.Tensor,
    hidden: Optional[Tuple[torch.Tensor, torch.Tensor]],
    num_layers: int,
    hidden_size: int,
    dropout_p: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The plain loop of ``lstm_apply``, with its arguments.  Inter-layer
    dropout applies only when training and a ``generator`` is given, its
    mask drawn from that generator, as the JAX package drops out only when
    an ``rng`` is passed."""
    lead = x.shape[:-2]
    if hidden is None:
        h0 = x.new_zeros(*lead, num_layers, hidden_size)
        c0 = x.new_zeros(*lead, num_layers, hidden_size)
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
        h, c = h0[..., layer, :], c0[..., layer, :]
        outs = []
        for t in range(x_proj.shape[-2]):
            gates = x_proj[..., t, :] + torch.matmul(h, w_hh_t)
            i, f, g, o = gates.split(hidden_size, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        h_finals.append(h)
        c_finals.append(c)
        seq = torch.stack(outs, -2) if outs else x_proj.new_zeros(*lead, 0, hidden_size)
        if layer < num_layers - 1 and dropout_p > 0.0 and train and generator is not None:
            seq = imageops.dropout(seq, dropout_p, generator)
    return seq, (torch.stack(h_finals, -2), torch.stack(c_finals, -2))


class LSTM(ParamLeaf):
    """torch nn.LSTM over an unbatched (T, input_size) sequence, or G of them
    as (G, T, input_size), with its state_dict keys (``weight_ih_l0``, ...).
    The attribute ``mode`` picks the fused kernel at inference ("stacked" K4
    or "wavefront" K5; None: ``lstm_fused.FUSED_LSTM_MODE``), which takes
    its route by shape (``lstm_fused.choose_route``).  The weights in the
    kernels' layouts are packed once and kept (``packed``) until a
    parameter changes."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, gen, device,
                 bias: bool = True, dropout: float = 0.0):
        super().__init__(init_lstm(gen, input_size, hidden_size, num_layers, bias), device)
        self.hidden_size, self.num_layers, self.dropout = hidden_size, num_layers, dropout
        self.mode: Optional[str] = None
        self._packed: Optional[lstm_fused.Packed] = None
        self._packed_key = None

    def packed(self) -> lstm_fused.Packed:
        """The parameters in the kernels' layouts (``lstm_fused.pack``),
        packed again only after a parameter was replaced (its ``data_ptr``)
        or edited in place (its ``_version``), e.g. by ``load_state_dict``
        or an optimizer step.  An edit through ``.data`` bumps no version
        and is not seen."""
        params = dict(self.named_parameters())
        key = tuple((p.data_ptr(), p._version) for p in params.values())
        if key != self._packed_key:
            # ordinary tensors even under inference_mode: the cache outlives the call
            with torch.inference_mode(False), torch.no_grad():
                self._packed = lstm_fused.pack(
                    {k: v.detach() for k, v in params.items()}, self.num_layers,
                    self.hidden_size)
            self._packed_key = key
        return self._packed

    def kernel(self) -> Tuple[str, str]:
        """The fused kernel an inference call on CUDA takes: (mode, route),
        which a captured graph is keyed by."""
        return (self.mode or lstm_fused.FUSED_LSTM_MODE,
                lstm_fused.choose_route(self.hidden_size, self.num_layers))

    def forward(self, x, hidden=None, generator: Optional[torch.Generator] = None):
        """``lstm_apply`` with the module's parameters, its weights packed
        once for the fused kernel."""
        params = dict(self.named_parameters())
        L, H = self.num_layers, self.hidden_size
        if x.is_cuda and fused_wanted(params, x, hidden, H, self.training):
            return lstm_fused.lstm_apply_fused(params, x, hidden, L, H, self.mode,
                                               self.packed())
        return lstm_loop(params, x, hidden, L, H, self.dropout, self.training, generator)


# ---------------------------------------------------------------------------
# ConvLSTM (vendored ConvLSTM_pytorch parity)
# ---------------------------------------------------------------------------

ConvState = List[Tuple[torch.Tensor, torch.Tensor]]


def init_convlstm(gen, input_dim: int, hidden_dims: Sequence[int], kernel_size,
                  bias: bool) -> Params:
    """Params keyed like the vendored ConvLSTM: cell_list.{i}.conv.{weight,bias};
    each cell's conv maps (input + hidden) channels to 4 * hidden."""
    p: Params = {}
    cur = input_dim
    for i, hd in enumerate(hidden_dims):
        kh, kw = kernel_size
        if kh != kw:
            raise ValueError(f"square ConvLSTM kernels only, got {kernel_size}")
        p.update(prefix_params(f"cell_list.{i}.conv", init_conv2d(gen, cur + hd, 4 * hd, kh, bias)))
        cur = hd
    return p


def convlstm_apply(
    params: Params,
    x: torch.Tensor,  # (B, T, C, H, W), batch_first
    hidden: Optional[ConvState],
    hidden_dims: Sequence[int],
    kernel_size: Tuple[int, int],
) -> Tuple[torch.Tensor, ConvState]:
    """ConvLSTM forward; returns (last layer outputs (B, T, Ch, H, W), last
    states [(h, c)] per layer, each (B, Ch, H, W)).

    Gate order (i, f, o, g) and 'same' padding per convlstm.py:29,44-53.
    """
    B, T, _, H, W = x.shape
    pad = (kernel_size[0] // 2, kernel_size[1] // 2)
    if hidden is None:
        hidden = convlstm_init_hidden(B, hidden_dims, H, W, x.device, x.dtype)
    seq = x
    last_states: ConvState = []
    for layer, hd in enumerate(hidden_dims):
        w = params[f"cell_list.{layer}.conv.weight"]
        b = params.get(f"cell_list.{layer}.conv.bias")
        h, c = hidden[layer]
        outs = []
        for t in range(T):
            gates = imageops.conv2d(torch.cat([seq[:, t], h], dim=1), w, b, padding=pad)
            cc_i, cc_f, cc_o, cc_g = gates.split(hd, dim=1)
            c = torch.sigmoid(cc_f) * c + torch.sigmoid(cc_i) * torch.tanh(cc_g)
            h = torch.sigmoid(cc_o) * torch.tanh(c)
            outs.append(h)
        last_states.append((h, c))
        seq = torch.stack(outs, 1)
    return seq, last_states


def convlstm_init_hidden(batch: int, hidden_dims: Sequence[int], H: int, W: int,
                         device=None, dtype=torch.float32) -> ConvState:
    return [
        (torch.zeros(batch, hd, H, W, dtype=dtype, device=device),
         torch.zeros(batch, hd, H, W, dtype=dtype, device=device))
        for hd in hidden_dims
    ]


class ConvLSTM(nn.Module):
    """The vendored ConvLSTM (batch_first), with its state_dict keys
    (``cell_list.0.conv.weight``, ...)."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int], kernel_size, gen, device,
                 bias: bool = True):
        super().__init__()
        params = init_convlstm(gen, input_dim, hidden_dims, kernel_size, bias)
        self.hidden_dims, self.kernel_size = list(hidden_dims), tuple(kernel_size)
        self.cell_list = nn.ModuleList(
            nn.ModuleDict({"conv": ParamLeaf(sub(params, f"cell_list.{i}.conv"), device)})
            for i in range(len(hidden_dims))
        )

    def forward(self, x, hidden: Optional[ConvState] = None):
        return convlstm_apply(
            dict(self.named_parameters()), x, hidden, self.hidden_dims, self.kernel_size
        )
