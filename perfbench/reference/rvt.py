"""Plain PyTorch reference of RVT-B at 1 Mpx, on a state_dict, for inference.

RVT is the Recurrent Vision Transformer of Gehrig and Scaramuzza (CVPR
2023, arXiv:2212.05598); this is its base size with YOLOX's PAFPN and
decoupled head, written from the model's equations:

* ``histogram``: the stacked histogram of one window of events (x, y, p, t):
  coordinates halved, T = 10 time bins of the window's real span,
  channel ``T [p > 0] + tau``, counts clipped at 10, in a frame of 384x640.
* four stages: a strided convolution without bias and a LayerNorm over
  channels; for each partition (window, then grid, of 6x10 tokens) a
  pre-norm multi-head self-attention of C/32 heads and a pre-norm MLP, each
  residual scaled by its LayerScale; a per-pixel LSTM (gates (i, f, o, g)
  from a 1x1 convolution of the stage's map and h).  The attention gathers
  each group's tokens by their group's number (sorted), attends, and
  scatters them back.
* YOLOX's PAFPN over stages 2-4 (two bottlenecks a CSP layer) and its
  decoupled head at width 128, 3 classes; BatchNorm from its running
  statistics; the decode of the raw output.

Every function takes the state_dict and tensors, and uses only ``torch``
and ``torch.nn.functional``: nothing of the measured program.
``init_weights`` draws the weights with ``perfbench/weights.py`` and then
each LayerScale at order one and each BatchNorm's statistics.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import weights

SD = Dict[str, torch.Tensor]

DIMS = (64, 128, 256, 512)
PARTITION = (6, 10)
HEAD_WIDTH_ATTN = 32
BINS = 10
FRAME_HW = (384, 640)
CLIP = 10.0
CSP_DEPTH = 2
HEAD_WIDTH = 128
CLASSES = 3
LN_EPS = 1e-5
BN_EPS = 1e-3


# ----------------------------------------------------------------- shapes

def _base_conv(s, key, cin, cout, k):
    s[key + ".conv.weight"] = (cout, cin, k, k)
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        s[f"{key}.bn.{leaf}"] = (cout,)


def _csp(s, key, cin, cout):
    hid = cout // 2
    _base_conv(s, key + ".conv1", cin, hid, 1)
    _base_conv(s, key + ".conv2", cin, hid, 1)
    _base_conv(s, key + ".conv3", 2 * hid, cout, 1)
    for i in range(CSP_DEPTH):
        _base_conv(s, f"{key}.m.{i}.conv1", hid, hid, 1)
        _base_conv(s, f"{key}.m.{i}.conv2", hid, hid, 3)


def shapes() -> Dict[str, Tuple[int, ...]]:
    """state_dict key -> shape (18,538,776 trained parameters, and the
    BatchNorms' running statistics)."""
    s: Dict[str, Tuple[int, ...]] = {}
    cin = 2 * BINS
    for i, c in enumerate(DIMS):
        k = 7 if i == 0 else 3
        p = f"stages.{i}."
        s[p + "downsample.conv.weight"] = (c, cin, k, k)
        s[p + "downsample.norm.weight"] = s[p + "downsample.norm.bias"] = (c,)
        for kind in ("window", "grid"):
            b = f"{p}{kind}."
            s[b + "norm1.weight"] = s[b + "norm1.bias"] = (c,)
            s[b + "qkv.weight"], s[b + "qkv.bias"] = (3 * c, c), (3 * c,)
            s[b + "proj.weight"], s[b + "proj.bias"] = (c, c), (c,)
            s[b + "ls1.gamma"] = (c,)
            s[b + "norm2.weight"] = s[b + "norm2.bias"] = (c,)
            s[b + "fc1.weight"], s[b + "fc1.bias"] = (4 * c, c), (4 * c,)
            s[b + "fc2.weight"], s[b + "fc2.bias"] = (c, 4 * c), (c,)
            s[b + "ls2.gamma"] = (c,)
        s[p + "lstm.cell_list.0.conv.weight"] = (4 * c, 2 * c, 1, 1)
        s[p + "lstm.cell_list.0.conv.bias"] = (4 * c,)
        cin = c
    c3, c4, c5 = DIMS[1:]
    _base_conv(s, "fpn.lateral_conv0", c5, c4, 1)
    _csp(s, "fpn.C3_p4", 2 * c4, c4)
    _base_conv(s, "fpn.reduce_conv1", c4, c3, 1)
    _csp(s, "fpn.C3_p3", 2 * c3, c3)
    _base_conv(s, "fpn.bu_conv2", c3, c3, 3)
    _csp(s, "fpn.C3_n3", 2 * c3, c4)
    _base_conv(s, "fpn.bu_conv1", c4, c4, 3)
    _csp(s, "fpn.C3_n4", 2 * c4, c5)
    for i, c in enumerate((c3, c4, c5)):
        _base_conv(s, f"head.stems.{i}", c, HEAD_WIDTH, 1)
        for branch in ("cls_convs", "reg_convs"):
            for j in range(2):
                _base_conv(s, f"head.{branch}.{i}.{j}", HEAD_WIDTH, HEAD_WIDTH, 3)
        for name, n in (("cls_preds", CLASSES), ("reg_preds", 4), ("obj_preds", 1)):
            s[f"head.{name}.{i}.weight"], s[f"head.{name}.{i}.bias"] = (n, HEAD_WIDTH, 1, 1), (n,)
    return s


def param_count() -> int:
    return sum(math.prod(v) for k, v in shapes().items()
               if not k.endswith(("running_mean", "running_var")))


def init_weights(seed: int, device) -> SD:
    """``weights.init_state_dict`` of ``shapes()`` (PyTorch's default
    draws; LayerNorms ones and zeros), then from a generator of its own:
    each LayerScale U(0.5, 1.5) (RVT's 1e-5 would leave every block nearly
    the identity and the check blind to it), each BatchNorm's weight and
    running variance U(0.5, 1.5), bias and running mean U(-0.1, 0.1)."""
    sh = shapes()
    sd = weights.init_state_dict(sh, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for k, shape in sh.items():
        leaf = k.rsplit(".", 1)[1]
        if leaf == "gamma" or (".bn." in k and leaf in ("weight", "running_var")):
            sd[k] = 0.5 + torch.rand(shape, generator=gen, device=device)
        elif ".bn." in k:
            sd[k] = 0.2 * torch.rand(shape, generator=gen, device=device) - 0.1
    return sd


# -------------------------------------------------------------- histogram

def histogram(x, y, p, t, bins: int = BINS, frame_hw=FRAME_HW, downsample: int = 2,
              clip: float = CLIP) -> torch.Tensor:
    """One window's real events (N,) -> (2 bins, H, W) f32 counts."""
    H, W = frame_hw
    t = t.to(torch.int64)
    t_first, t_last = int(t.min()), int(t.max())
    tau = (bins * (t - t_first)) // max(t_last - t_first, 1)
    tau = torch.clamp(tau, max=bins - 1)
    ch = bins * (p > 0).to(torch.int64) + tau
    xs, ys = x.to(torch.int64) // downsample, y.to(torch.int64) // downsample
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    idx = (ch * H + ys) * W + xs
    counts = torch.bincount(idx[keep], minlength=2 * bins * H * W)
    return counts.to(torch.float32).clamp(max=clip).reshape(2 * bins, H, W)


# -------------------------------------------------------------- backbone

def group_ids(H: int, W: int, kind: str, partition=PARTITION) -> torch.Tensor:
    """Each token's (row-major) group: the ph x pw window it lies in, or for
    the grid the group of tokens H/gh rows and W/gw columns apart."""
    ph, pw = partition
    i = torch.arange(H)[:, None].expand(H, W)
    j = torch.arange(W)[None, :].expand(H, W)
    if kind == "window":
        g = (i // ph) * (W // pw) + j // pw
    else:
        g = (i % (H // ph)) * (W // pw) + j % (W // pw)
    return g.reshape(-1)


def attention(z: torch.Tensor, sd: SD, key: str, kind: str, partition=PARTITION) -> torch.Tensor:
    """MHSA within each group of ``kind`` over (B, H, W, C) tokens."""
    B, H, W, C = z.shape
    L, heads = partition[0] * partition[1], C // HEAD_WIDTH_ATTN
    order = torch.argsort(group_ids(H, W, kind, partition) * (H * W) + torch.arange(H * W))
    order = order.to(z.device)
    t = z.reshape(B, H * W, C)[:, order].reshape(-1, L, C)
    qkv = t @ sd[key + ".qkv.weight"].t() + sd[key + ".qkv.bias"]
    q, k, v = (u.reshape(-1, L, heads, HEAD_WIDTH_ATTN).transpose(1, 2)
               for u in qkv.split(C, dim=-1))
    a = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(HEAD_WIDTH_ATTN), dim=-1)
    o = (a @ v).transpose(1, 2).reshape(-1, L, C)
    o = o @ sd[key + ".proj.weight"].t() + sd[key + ".proj.bias"]
    out = torch.empty_like(o.reshape(B, H * W, C))
    out[:, order] = o.reshape(B, H * W, C)
    return out.reshape(B, H, W, C)


def _ln(x, sd, key):
    return F.layer_norm(x, (x.shape[-1],), sd[key + ".weight"], sd[key + ".bias"], LN_EPS)


def block(z: torch.Tensor, sd: SD, key: str, kind: str, partition=PARTITION) -> torch.Tensor:
    z = z + sd[key + ".ls1.gamma"] * attention(_ln(z, sd, key + ".norm1"), sd, key, kind,
                                              partition)
    m = _ln(z, sd, key + ".norm2") @ sd[key + ".fc1.weight"].t() + sd[key + ".fc1.bias"]
    m = F.gelu(m) @ sd[key + ".fc2.weight"].t() + sd[key + ".fc2.bias"]
    return z + sd[key + ".ls2.gamma"] * m


def stage(x: torch.Tensor, sd: SD, s: int, state, partition=PARTITION):
    """Stage s (0-3): x (B, Cin, H, W), state (h, c) -> (h, (h, c))."""
    p = f"stages.{s}."
    k, stride = (7, 4) if s == 0 else (3, 2)
    z = F.conv2d(x, sd[p + "downsample.conv.weight"], None, stride, k // 2)
    z = _ln(z.permute(0, 2, 3, 1), sd, p + "downsample.norm")
    z = block(z, sd, p + "window", "window", partition)
    z = block(z, sd, p + "grid", "grid", partition)
    z = z.permute(0, 3, 1, 2)
    h, c = state if state is not None else (torch.zeros_like(z), torch.zeros_like(z))
    gates = F.conv2d(torch.cat([z, h], 1), sd[p + "lstm.cell_list.0.conv.weight"],
                     sd[p + "lstm.cell_list.0.conv.bias"])
    gi, gf, go, gg = gates.chunk(4, 1)
    c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
    h = torch.sigmoid(go) * torch.tanh(c)
    return h, (h, c)


# ----------------------------------------------------------- FPN and head

def base_conv(x, sd: SD, key: str, stride: int = 1):
    w = sd[key + ".conv.weight"]
    y = F.conv2d(x, w, None, stride, (w.shape[-1] - 1) // 2)
    b = lambda leaf: sd[f"{key}.bn.{leaf}"][None, :, None, None]  # noqa: E731
    y = (y - b("running_mean")) / torch.sqrt(b("running_var") + BN_EPS) * b("weight") + b("bias")
    return y * torch.sigmoid(y)


def csp(x, sd: SD, key: str):
    a = base_conv(x, sd, key + ".conv1")
    for i in range(CSP_DEPTH):
        a = base_conv(base_conv(a, sd, f"{key}.m.{i}.conv1"), sd, f"{key}.m.{i}.conv2")
    return base_conv(torch.cat([a, base_conv(x, sd, key + ".conv2")], 1), sd, key + ".conv3")


def upsample(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def pafpn(sd: SD, x3, x4, x5):
    f = "fpn."
    top = base_conv(x5, sd, f + "lateral_conv0")
    mid = csp(torch.cat([upsample(top), x4], 1), sd, f + "C3_p4")
    mid_r = base_conv(mid, sd, f + "reduce_conv1")
    out3 = csp(torch.cat([upsample(mid_r), x3], 1), sd, f + "C3_p3")
    out4 = csp(torch.cat([base_conv(out3, sd, f + "bu_conv2", 2), mid_r], 1), sd, f + "C3_n3")
    out5 = csp(torch.cat([base_conv(out4, sd, f + "bu_conv1", 2), top], 1), sd, f + "C3_n4")
    return out3, out4, out5


def head(sd: SD, levels: Sequence[torch.Tensor]) -> torch.Tensor:
    """-> raw (B, anchors, 5 + classes): box 4, objectness, classes."""
    out = []
    for i, x in enumerate(levels):
        x = base_conv(x, sd, f"head.stems.{i}")
        c = base_conv(base_conv(x, sd, f"head.cls_convs.{i}.0"), sd, f"head.cls_convs.{i}.1")
        r = base_conv(base_conv(x, sd, f"head.reg_convs.{i}.0"), sd, f"head.reg_convs.{i}.1")
        pred = lambda name, u: F.conv2d(u, sd[f"head.{name}.{i}.weight"],  # noqa: E731
                                        sd[f"head.{name}.{i}.bias"])
        y = torch.cat([pred("reg_preds", r), pred("obj_preds", r), pred("cls_preds", c)], 1)
        out.append(y.reshape(y.shape[0], y.shape[1], -1).transpose(1, 2))
    return torch.cat(out, 1)


def decode(raw: torch.Tensor, levels: Sequence[torch.Tensor], frame_h: int) -> torch.Tensor:
    parts_xy, parts_s = [], []
    for lv in levels:
        h, w = lv.shape[-2:]
        ys = torch.arange(h, device=raw.device).repeat_interleave(w)
        xs = torch.arange(w, device=raw.device).repeat(h)
        parts_xy.append(torch.stack([xs, ys], 1).to(torch.float32))
        parts_s.append(torch.full((h * w, 1), float(frame_h // h), device=raw.device))
    grid, stride = torch.cat(parts_xy), torch.cat(parts_s)
    return torch.cat([(raw[..., :2] + grid) * stride, torch.exp(raw[..., 2:4]) * stride,
                      torch.sigmoid(raw[..., 4:])], -1)


def forward(sd: SD, frame: torch.Tensor, hidden: Optional[Sequence] = None,
            partition=PARTITION):
    """frame (B, 2 bins, H, W), hidden four (h, c) or None -> (raw, decoded,
    the new hidden)."""
    x, feats, new_hidden = frame, [], []
    for s in range(len(DIMS)):
        x, hc = stage(x, sd, s, None if hidden is None else hidden[s], partition)
        feats.append(x)
        new_hidden.append(hc)
    levels = pafpn(sd, *feats[1:])
    raw = head(sd, levels)
    return raw, decode(raw, levels, frame.shape[-2]), new_hidden


def stream_step(sd: SD, frame: torch.Tensor, hidden, partition=PARTITION):
    """One stream's window: frame (2 bins, H, W) -> (raw (anchors, 8), the
    new hidden state as (h, c) of each stage, batch 1)."""
    raw, _, new_hidden = forward(sd, frame[None], hidden, partition)
    return raw[0], new_hidden


def state_leaves(hidden) -> List[torch.Tensor]:
    return [t for hc in hidden for t in hc]
