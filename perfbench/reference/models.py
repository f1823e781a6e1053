"""Plain PyTorch reference of the two benchmarked models, on state_dicts.

V(phi) is ``LSTMNetVIT`` of evfly's ``learner/vitfly_models.py`` (two
MixTransformer blocks, a spectral-norm decoder, a 3-layer LSTM over the
window axis, a spectral-norm head).  D(theta)+V(phi) is evfly's
``OrigUNet_w_VITFLY_ViTLSTM`` (``learner/learner_models.py``): a 5-level
valid-padding UNet with a 1x1 ConvLSTM at its bottleneck, bilinear skips,
its depth upsampled to the input size, then clip(2 depth, 0, 1) into V(phi).

Every function takes the state_dict (the reference's keys) and tensors, and
uses only ``torch`` and ``torch.nn.functional``: no module of the measured
program.  Spectral-norm layers use their stored u and v (eval semantics);
``power_iteration`` is the training forward's update of them.  The LSTM is
the plain loop of ``torch.nn.LSTM`` over an unbatched sequence, or over G of
them with a leading stream axis.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

SD = Dict[str, torch.Tensor]

ENCODER = (("e1", 32), ("e2", 64), ("e3", 128), ("e4", 256), ("e5", 512))
DECODER = (("d1", 256), ("d2", 128), ("d3", 64), ("d4", 32))
# (in, out, patch, stride, padding, reduction ratio, heads) of the two blocks
VIT_BLOCKS = ((1, 32, 7, 4, 3, 8, 1), (32, 64, 3, 2, 1, 4, 2))
VIT_LAYERS, VIT_EXPANSION = 2, 8
LSTM_IN, LSTM_H, LSTM_L = 517, 128, 3
CONVLSTM_H = 512


# ----------------------------------------------------------------- shapes

def vitlstm_shapes(prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    """state_dict key -> shape of LSTMNetVIT (3,563,663 trained parameters)."""
    s: Dict[str, Tuple[int, ...]] = {}
    for b, (ci, co, k, _st, _pad, rr, _heads) in enumerate(VIT_BLOCKS):
        p = f"{prefix}encoder_blocks.{b}."
        s[p + "patchMerge.cn1.weight"], s[p + "patchMerge.cn1.bias"] = (co, ci, k, k), (co,)
        s[p + "patchMerge.layerNorm.weight"] = s[p + "patchMerge.layerNorm.bias"] = (co,)
        for i in range(VIT_LAYERS):
            a = f"{p}_attn.{i}."
            s[a + "cn1.weight"], s[a + "cn1.bias"] = (co, co, rr, rr), (co,)
            s[a + "ln1.weight"] = s[a + "ln1.bias"] = (co,)
            s[a + "keyValueExtractor.weight"], s[a + "keyValueExtractor.bias"] = (2 * co, co), (2 * co,)
            s[a + "query.weight"], s[a + "query.bias"] = (co, co), (co,)
            s[a + "finalLayer.weight"], s[a + "finalLayer.bias"] = (co, co), (co,)
        for i in range(VIT_LAYERS):
            f, ex = f"{p}_ffn.{i}.", co * VIT_EXPANSION
            s[f + "mlp1.weight"], s[f + "mlp1.bias"] = (ex, co), (ex,)
            # groups = channels, not the expanded width (the reference's quirk)
            s[f + "depthwise.weight"], s[f + "depthwise.bias"] = (ex, ex // co, 3, 3), (ex,)
            s[f + "mlp2.weight"], s[f + "mlp2.bias"] = (co, ex), (co,)
        for i in range(VIT_LAYERS):
            s[f"{p}_lNorm.{i}.weight"] = s[f"{p}_lNorm.{i}.bias"] = (co,)
    for name, (o, i) in (("decoder", (512, 4608)), ("nn_fc2", (3, LSTM_H))):
        s[f"{prefix}{name}.weight_orig"], s[f"{prefix}{name}.bias"] = (o, i), (o,)
        s[f"{prefix}{name}.weight_u"], s[f"{prefix}{name}.weight_v"] = (o,), (i,)
    for layer in range(LSTM_L):
        s[f"{prefix}lstm.weight_ih_l{layer}"] = (4 * LSTM_H, LSTM_IN if layer == 0 else LSTM_H)
        s[f"{prefix}lstm.weight_hh_l{layer}"] = (4 * LSTM_H, LSTM_H)
        s[f"{prefix}lstm.bias_ih_l{layer}"] = s[f"{prefix}lstm.bias_hh_l{layer}"] = (4 * LSTM_H,)
    s[f"{prefix}down_sample.weight"], s[f"{prefix}down_sample.bias"] = (12, 48, 3, 3), (12,)
    return s


def joint_shapes() -> Dict[str, Tuple[int, ...]]:
    """state_dict key -> shape of OrigUNet_w_VITFLY_ViTLSTM with one input
    channel (form_BEV 2), interpolated skips, a 1-layer ConvLSTM and no
    velocity head (13,420,336 trained parameters)."""
    s: Dict[str, Tuple[int, ...]] = {}
    cin = 1
    for name, cout in ENCODER:
        s[f"origunet.unet_{name}1.weight"], s[f"origunet.unet_{name}1.bias"] = (cout, cin, 3, 3), (cout,)
        s[f"origunet.unet_{name}2.weight"], s[f"origunet.unet_{name}2.bias"] = (cout, cout, 3, 3), (cout,)
        cin = cout
    for level, (name, cout) in enumerate(DECODER, start=1):
        s[f"origunet.unet_{name}1.weight"], s[f"origunet.unet_{name}1.bias"] = (cout, 2 * cout, 3, 3), (cout,)
        s[f"origunet.unet_{name}2.weight"], s[f"origunet.unet_{name}2.bias"] = (cout, cout, 3, 3), (cout,)
        s[f"origunet.unet_upconv{level}.weight"] = (2 * cout, cout, 2, 2)
        s[f"origunet.unet_upconv{level}.bias"] = (cout,)
    s["origunet.unet_out.weight"], s["origunet.unet_out.bias"] = (1, 32, 1, 1), (1,)
    s["origunet.lstm.cell_list.0.conv.weight"] = (4 * CONVLSTM_H, 2 * CONVLSTM_H, 1, 1)
    s.update(vitlstm_shapes("vitfly_vitlstm."))
    return s


# ------------------------------------------------------------ primitives

def spectral_weight(sd: SD, name: str) -> torch.Tensor:
    w = sd[name + ".weight_orig"]
    sigma = torch.dot(sd[name + ".weight_u"], torch.mv(w, sd[name + ".weight_v"]))
    return w / sigma


def power_iteration(sd: SD, name: str, eps: float = 1e-12) -> None:
    """One step of torch spectral_norm's power iteration on u and v, in place."""
    with torch.no_grad():
        w = sd[name + ".weight_orig"]
        v = torch.mv(w.t(), sd[name + ".weight_u"])
        v = v / (v.norm() + eps)
        u = torch.mv(w, v)
        u = u / (u.norm() + eps)
        sd[name + ".weight_u"].copy_(u)
        sd[name + ".weight_v"].copy_(v)


def spectral_names(sd: SD) -> List[str]:
    return [k[: -len(".weight_orig")] for k in sd if k.endswith(".weight_orig")]


def lstm_loop(sd: SD, prefix: str, x: torch.Tensor, hidden, layers: int, H: int):
    """torch.nn.LSTM over x (T, in) or (G, T, in); gates (i, f, g, o).
    Returns (out (..., T, H), (h, c) each (..., layers, H))."""
    lead = x.shape[:-2]
    if hidden is None:
        h0 = x.new_zeros(*lead, layers, H)
        c0 = x.new_zeros(*lead, layers, H)
    else:
        h0, c0 = hidden
    seq, hs, cs = x, [], []
    for layer in range(layers):
        w_ih, w_hh = sd[f"{prefix}weight_ih_l{layer}"], sd[f"{prefix}weight_hh_l{layer}"]
        h, c = h0[..., layer, :], c0[..., layer, :]
        outs = []
        for t in range(seq.shape[-2]):
            gates = seq[..., t, :] @ w_ih.t() + h @ w_hh.t()
            if f"{prefix}bias_ih_l{layer}" in sd:
                gates = gates + sd[f"{prefix}bias_ih_l{layer}"] + sd[f"{prefix}bias_hh_l{layer}"]
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        seq = torch.stack(outs, dim=-2)
        hs.append(h)
        cs.append(c)
    return seq, (torch.stack(hs, dim=-2), torch.stack(cs, dim=-2))


# ------------------------------------------------------------------ V(phi)

def _linear(sd: SD, name: str, x):
    return F.linear(x, sd[name + ".weight"], sd[name + ".bias"])


def _layer_norm(sd: SD, name: str, x):
    return F.layer_norm(x, (x.shape[-1],), sd[name + ".weight"], sd[name + ".bias"], 1e-5)


def _mix_block(sd: SD, p: str, x, block):
    _ci, co, _k, stride, pad, rr, heads = block
    x = F.conv2d(x, sd[p + "patchMerge.cn1.weight"], sd[p + "patchMerge.cn1.bias"], stride, pad)
    B, C, H, W = x.shape
    x = _layer_norm(sd, p + "patchMerge.layerNorm", x.flatten(2).transpose(1, 2))
    dh = C // heads
    for i in range(VIT_LAYERS):
        a = f"{p}_attn.{i}."
        red = F.conv2d(x.transpose(1, 2).reshape(B, C, H, W), sd[a + "cn1.weight"],
                       sd[a + "cn1.bias"], rr)
        red = _layer_norm(sd, a + "ln1", red.flatten(2).transpose(1, 2))
        kv = _linear(sd, a + "keyValueExtractor", red)
        kv = kv.reshape(B, kv.shape[1], 2, heads, dh).permute(2, 0, 3, 1, 4)
        q = _linear(sd, a + "query", x).reshape(B, H * W, heads, dh).transpose(1, 2)
        att = torch.softmax(q @ kv[0].transpose(-1, -2) / math.sqrt(C / heads), dim=-1)
        x = x + _linear(sd, a + "finalLayer", (att @ kv[1]).transpose(1, 2).reshape(B, H * W, C))
        f = f"{p}_ffn.{i}."
        y = _linear(sd, f + "mlp1", x)
        E = y.shape[-1]
        y = F.conv2d(y.transpose(1, 2).reshape(B, E, H, W), sd[f + "depthwise.weight"],
                     sd[f + "depthwise.bias"], padding=1, groups=co)
        y = F.gelu(y.flatten(2).transpose(1, 2))
        x = x + _linear(sd, f + "mlp2", y)
        x = _layer_norm(sd, f"{p}_lNorm.{i}", x)
    return x.reshape(B, H, W, C).permute(0, 3, 1, 2)


def vitlstm(sd: SD, img: torch.Tensor, desvel: torch.Tensor, hidden=None, prefix: str = ""):
    """LSTMNetVIT: img (N, 1, H, W) with desvel (N, 1), the LSTM over N as
    its time axis; or img (G, N, 1, H, W) with desvel (G, N, 1), G streams.
    Returns (velocity (..., N, 3), (h, c))."""
    lead = img.shape[:-3]
    x = img.reshape(-1, *img.shape[-3:])
    d = desvel.reshape(-1, 1)
    if x.shape[-2:] != (60, 90):
        x = F.interpolate(x, size=(60, 90), mode="bilinear", align_corners=False)
    e1 = _mix_block(sd, prefix + "encoder_blocks.0.", x, VIT_BLOCKS[0])
    e2 = _mix_block(sd, prefix + "encoder_blocks.1.", e1, VIT_BLOCKS[1])
    fused = torch.cat([F.pixel_shuffle(e2, 2),
                       F.interpolate(e1, size=(16, 24), mode="bilinear", align_corners=True)], 1)
    fused = F.conv2d(fused, sd[prefix + "down_sample.weight"], sd[prefix + "down_sample.bias"],
                     padding=1)
    enc = F.linear(fused.flatten(1), spectral_weight(sd, prefix + "decoder"),
                   sd[prefix + "decoder.bias"])
    quat = torch.zeros(enc.shape[0], 4, dtype=enc.dtype, device=enc.device)
    quat[:, 0] = 1.0
    out = torch.cat([enc, d / 10.0, quat], dim=1)
    out, h = lstm_loop(sd, prefix + "lstm.", out.reshape(*lead, out.shape[-1]), hidden,
                       LSTM_L, LSTM_H)
    return F.linear(out, spectral_weight(sd, prefix + "nn_fc2"), sd[prefix + "nn_fc2.bias"]), h


# ---------------------------------------------------------------- D(theta)

def _unet_block(sd: SD, name: str, x):
    p = f"origunet.unet_{name}"
    x = F.relu(F.conv2d(x, sd[p + "1.weight"], sd[p + "1.bias"]))
    return F.relu(F.conv2d(x, sd[p + "2.weight"], sd[p + "2.bias"]))


def convlstm(sd: SD, x: torch.Tensor, hidden):
    """The 1x1 ConvLSTM without bias over x (B, T, C, h, w); gates (i, f, o, g).
    Returns (out (B, T, 512, h, w), (h, c))."""
    w = sd["origunet.lstm.cell_list.0.conv.weight"]
    if hidden is None:
        z = x.new_zeros(x.shape[0], CONVLSTM_H, *x.shape[-2:])
        hidden = (z, z)
    h, c = hidden
    outs = []
    for t in range(x.shape[1]):
        gates = F.conv2d(torch.cat([x[:, t], h], dim=1), w)
        i, f, o, g = gates.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, 1), (h, c)


def unet_depth(sd: SD, x: torch.Tensor, hidden=None, cutoff: float = 0.0):
    """OrigUNet at form_BEV 2 with interpolated skips: event frames (N, 1, H,
    W), the ConvLSTM over N with batch 1, or (G, N, 1, H, W) with batch G.
    Returns (depth with x's leading axes, (h, c) of the ConvLSTM)."""
    lead = x.shape[:-3]
    im = x.reshape(-1, *x.shape[-3:])
    im = torch.where(im.abs() < cutoff, 0.0, im)
    im = torch.where(im != 0.0, 1.0, 0.0).to(x.dtype)
    skips, y = [], im
    for i, (name, _) in enumerate(ENCODER):
        if i:
            skips.append(y)
            y = F.max_pool2d(y, 2, 2)
        y = _unet_block(sd, name, y)
    seq_shape = lead if len(lead) == 2 else (1, *lead)
    out, h_unet = convlstm(sd, y.reshape(*seq_shape, *y.shape[1:]), hidden)
    y = out.reshape(y.shape)
    for level, (name, _) in enumerate(DECODER, start=1):
        up = F.conv_transpose2d(y, sd[f"origunet.unet_upconv{level}.weight"],
                                sd[f"origunet.unet_upconv{level}.bias"], stride=2)
        sk = F.interpolate(skips[-level], size=up.shape[-2:], mode="bilinear", align_corners=False)
        y = _unet_block(sd, name, torch.cat([sk, up], dim=1))
    y = F.conv2d(y, sd["origunet.unet_out.weight"], sd["origunet.unet_out.bias"])
    depth = F.interpolate(y, size=im.shape[-2:], mode="bilinear", align_corners=False)
    return depth.reshape(*lead, *depth.shape[1:]), h_unet


def joint(sd: SD, x: torch.Tensor, desvel: torch.Tensor, h_unet=None, h_vit=None):
    """OrigUNet_w_VITFLY_ViTLSTM: x (N, 1, H, W) or (G, N, 1, H, W), desvel
    (N, 1) or (G, N, 1).  Returns (velocity, depth, h_unet, h_vit)."""
    depth, h_unet = unet_depth(sd, x, h_unet)
    vel, h_vit = vitlstm(sd, torch.clamp(depth * 2.0, 0.0, 1.0), desvel, h_vit,
                         "vitfly_vitlstm.")
    return vel, depth, h_unet, h_vit


def stream_step(sd: SD, frame: torch.Tensor, desvel: torch.Tensor, h_unet, h_vit):
    """One streaming step of G >= 1 streams: frames (G, H, W), already
    percentile-scaled, desvel (G,); states with the leading G (the ConvLSTM's
    (G, 512, h, w), the LSTM's (G, 3, 128)).  Returns (velocity (G, 3) times
    desvel, depth (G, H, W), h_unet, h_vit)."""
    G, H, W = frame.shape
    vel, depth, h_unet, h_vit = joint(sd, frame.reshape(G, 1, 1, H, W), desvel.reshape(G, 1, 1),
                                      h_unet, h_vit)
    return vel[:, 0] * desvel[:, None], depth[:, 0, 0], h_unet, h_vit


def count_params(shapes: Dict[str, Tuple[int, ...]]) -> int:
    """Trained parameters: every key but the spectral-norm vectors."""
    return sum(math.prod(s) for k, s in shapes.items()
               if not k.endswith((".weight_u", ".weight_v")))
