"""Plain PyTorch reference of E-RAFT at DSEC's 480x640, on a state_dict, for
inference.

E-RAFT is RAFT over event voxel grids (Gehrig, Millhaeusler, Gehrig and
Scaramuzza, 3DV 2021, arXiv:2108.10552; RAFT: Teed and Deng, ECCV 2020),
here in its warm-start form; this is written from the equations:

* ``voxel_grid``: E-RAFT's ``VoxelGrid(normalize=True)`` of one window's real
  events, looped over the 8 corners as E-RAFT's ``convert`` does, the
  normalisation over the nonzero cells with host branches;
* ``encoder``: RAFT's BasicEncoder (instance norm for fnet, BatchNorm from
  its running statistics for cnet), each norm written out;
* ``pyramid`` and ``lookup``: the all-pairs correlation, its 2x2 average
  pools, and each level's 9x9 window sampled bilinearly by explicit gathers
  of the four neighbours (zero outside the level), channel ``81 i + 9 a +
  b`` at x offset ``a - 4`` and y offset ``b - 4``;
* ``update``: the motion encoder, the separable ConvGRU, the flow head;
* ``upsample``: the convex combination summed over the 9 neighbours one by
  one;
* ``forward_interpolate``: the nearest kept source of each target by
  ``argmin`` (its first minimum: the lowest index) over the kept sources;
* ``stream_step``: one window of a stream from its state.

Departures, shared with the program and each noted there: the voxel grid's
sums, statistics and normalisation in f64, rounded once to f32 (so that a
cell's zero test does not depend on the order of the additions); u = 0
where the window has no time span (E-RAFT divides by zero); the mask head
and the upsampling after the last iteration only; the warm start's nearest
neighbour in f32 on the device, ties to the lowest index (scipy's
``griddata`` in f64 on the host).

Every function takes the state_dict and tensors, and uses only ``torch`` and
``torch.nn.functional``: nothing of the measured program.  ``init_weights``
draws the weights with ``perfbench/weights.py`` and then each BatchNorm's
statistics and affine parameters.  A caller may pass ``track``, a dict of
``inside`` and ``samples``, to count the level-0 lookup samples that land
inside the map: a flow that drives the lookups off the pyramid would leave
the check blind to the correlation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import weights

SD = Dict[str, torch.Tensor]

BINS = 15
SENSOR_HW = (480, 640)
LEVELS = 4
RADIUS = 4
ITERATIONS = 12
EPS = 1e-5
ENCODER_LAYERS = ((64, 1), (96, 2), (128, 2))
# the flow head's last layer is drawn at this scale: at PyTorch's default
# draws the carried flow drifts by up to pixels a window, and over a 20 s
# run (about 670 windows) the lookups leave the pyramid (on some seeds under
# half of the level-0 samples inside the map, PERF.md)
FLOW_HEAD_SCALE = 0.02


# ----------------------------------------------------------------- shapes

def _conv(s, key, cin, cout, kh, kw=None):
    s[key + ".weight"] = (cout, cin, kh, kh if kw is None else kw)
    s[key + ".bias"] = (cout,)


def _bn(s, key, dim):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        s[f"{key}.{leaf}"] = (dim,)


def _encoder(s, key, out_dim, batch):
    _conv(s, key + ".conv1", BINS, 64, 7)
    if batch:
        _bn(s, key + ".norm1", 64)
    cin = 64
    for i, (dim, stride) in enumerate(ENCODER_LAYERS, 1):
        for j in range(2):
            b = f"{key}.layer{i}.{j}"
            _conv(s, b + ".conv1", cin if j == 0 else dim, dim, 3)
            _conv(s, b + ".conv2", dim, dim, 3)
            if batch:
                _bn(s, b + ".norm1", dim)
                _bn(s, b + ".norm2", dim)
            if j == 0 and stride != 1:
                if batch:
                    _bn(s, b + ".norm3", dim)
                _conv(s, b + ".downsample.0", cin, dim, 1)
                if batch:  # the same module as norm3, in RAFT's state_dict twice
                    _bn(s, b + ".downsample.1", dim)
        cin = dim
    _conv(s, key + ".conv2", 128, out_dim, 1)


def shapes() -> Dict[str, Tuple[int, ...]]:
    """state_dict key -> shape: RAFT's module tree with 15-channel first
    convolutions (BatchNorm's counters left out)."""
    s: Dict[str, Tuple[int, ...]] = {}
    _encoder(s, "fnet", 256, False)
    _encoder(s, "cnet", 256, True)
    u = "update_block."
    _conv(s, u + "encoder.convc1", LEVELS * (2 * RADIUS + 1) ** 2, 256, 1)
    _conv(s, u + "encoder.convc2", 256, 192, 3)
    _conv(s, u + "encoder.convf1", 2, 128, 7)
    _conv(s, u + "encoder.convf2", 128, 64, 3)
    _conv(s, u + "encoder.conv", 256, 126, 3)
    for i, (kh, kw) in ((1, (1, 5)), (2, (5, 1))):
        for gate in "zrq":
            _conv(s, f"{u}gru.conv{gate}{i}", 128 + 256, 128, kh, kw)
    _conv(s, u + "flow_head.conv1", 128, 256, 3)
    _conv(s, u + "flow_head.conv2", 256, 2, 3)
    _conv(s, u + "mask.0", 128, 256, 3)
    _conv(s, u + "mask.2", 256, 576, 1)
    return s


def _trained(key: str) -> bool:
    return not key.endswith(("running_mean", "running_var")) and ".downsample.1." not in key


def param_count() -> int:
    return sum(math.prod(v) for k, v in shapes().items() if _trained(k))


def param_parts() -> Dict[str, int]:
    parts: Dict[str, int] = {}
    for k, v in shapes().items():
        if _trained(k):
            part = k.split(".")[0]
            parts[part] = parts.get(part, 0) + math.prod(v)
    return parts


def init_weights(seed: int, device) -> SD:
    """``weights.init_state_dict`` of ``shapes()`` (PyTorch's default
    draws), then from a generator of its own each BatchNorm's weight and
    running variance U(0.5, 1.5), bias and running mean U(-0.1, 0.1), so that
    the check sees each BatchNorm; ``downsample.1`` is ``norm3``; the flow
    head's last layer times ``FLOW_HEAD_SCALE``."""
    sh = shapes()
    sd = weights.init_state_dict(sh, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for k, shape in sh.items():
        leaf = k.rsplit(".", 1)[1]
        if not k.startswith("cnet") or ".conv" in k or ".downsample.0." in k:
            continue
        if leaf in ("weight", "running_var"):
            sd[k] = 0.5 + torch.rand(shape, generator=gen, device=device)
        else:
            sd[k] = 0.2 * torch.rand(shape, generator=gen, device=device) - 0.1
    for k in sh:
        if ".downsample.1." in k:
            sd[k] = sd[k.replace(".downsample.1.", ".norm3.")]
        if k.startswith("update_block.flow_head.conv2."):
            sd[k] = sd[k] * FLOW_HEAD_SCALE
    return sd


def rectify_map(seed: int, hw=SENSOR_HW, device="cpu") -> torch.Tensor:
    """(H, W, 2) rectified (x, y) of each sensor pixel: a radial distortion
    about the centre, r^2 the squared distance over the half-diagonal's,
    ``(x, y) -> c + (p - c)(1 + k1 r^2)`` with k1 ~ U(-0.15, -0.05) from the
    seed (in place of DSEC's calibration)."""
    H, W = hw
    k1 = -0.15 + 0.1 * float(torch.rand(1, generator=torch.Generator().manual_seed(seed + 2)))
    cx, cy = (W - 1) / 2, (H - 1) / 2
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64), indexing="ij")
    r2 = ((xs - cx) ** 2 + (ys - cy) ** 2) / (cx ** 2 + cy ** 2)
    scale = 1 + k1 * r2
    out = torch.stack([cx + (xs - cx) * scale, cy + (ys - cy) * scale], -1)
    return out.to(torch.float32).to(device)


# -------------------------------------------------------------- voxel grid

def voxel_grid(x, y, p, t, rect: torch.Tensor, bins: int = BINS,
               accumulate: torch.dtype = torch.float64) -> torch.Tensor:
    """One window's real events (N,) (sorted by t) -> (bins, H, W) f32,
    summed, normalised and rounded to f32 from ``accumulate`` (f32 is
    E-RAFT's own, the control's precision below the configuration's f64)."""
    H, W = rect.shape[:2]
    f32 = torch.float32
    xy = rect[y.long(), x.long()]
    xr, yr = xy[:, 0], xy[:, 1]
    t = t.to(torch.int64)
    span = int(t.max()) - int(t.min())
    u = (t - t.min()).to(f32) / torch.tensor(float(span), dtype=f32, device=t.device) \
        if span > 0 else torch.zeros(t.shape, dtype=f32, device=t.device)
    tn = (bins - 1) * u
    value = 2 * (p > 0).to(f32) - 1
    x0, y0, t0 = xr.int(), yr.int(), tn.int()
    grid = torch.zeros(bins * H * W, dtype=accumulate, device=x.device)
    for xl in (x0, x0 + 1):
        for yl in (y0, y0 + 1):
            for tl in (t0, t0 + 1):
                keep = (xl < W) & (xl >= 0) & (yl < H) & (yl >= 0) & (tl >= 0) & (tl < bins)
                w = value * (1 - (xl - xr).abs()) * (1 - (yl - yr).abs()) * (1 - (tl - tn).abs())
                index = H * W * tl.long() + W * yl.long() + xl.long()
                grid.put_(index[keep], w[keep].to(accumulate), accumulate=True)
    nonzero = torch.nonzero(grid, as_tuple=True)
    if nonzero[0].numel() > 0:
        # torch's std of one value is NaN (and warns): E-RAFT then subtracts the mean
        mean = grid[nonzero].mean()
        std = grid[nonzero].std() if nonzero[0].numel() > 1 else torch.tensor(float("nan"))
        if std > 0:
            grid[nonzero] = (grid[nonzero] - mean) / std
        else:
            grid[nonzero] = grid[nonzero] - mean
    return grid.to(f32).reshape(bins, H, W)


# ---------------------------------------------------------------- encoders

def _c(x, sd, key, stride=1, padding=0):
    return F.conv2d(x, sd[key + ".weight"], sd[key + ".bias"], stride, padding)


def _norm(x, sd, key, batch):
    if batch:
        b = lambda leaf: sd[f"{key}.{leaf}"][None, :, None, None]  # noqa: E731
        return (x - b("running_mean")) / torch.sqrt(b("running_var") + EPS) * b("weight") \
            + b("bias")
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


def encoder(x, sd: SD, key: str) -> torch.Tensor:
    batch = key == "cnet"
    x = F.relu(_norm(_c(x, sd, key + ".conv1", 2, 3), sd, key + ".norm1", batch))
    for i, (_, stride) in enumerate(ENCODER_LAYERS, 1):
        for j in range(2):
            b, s = f"{key}.layer{i}.{j}", stride if j == 0 else 1
            y = F.relu(_norm(_c(x, sd, b + ".conv1", s, 1), sd, b + ".norm1", batch))
            y = F.relu(_norm(_c(y, sd, b + ".conv2", 1, 1), sd, b + ".norm2", batch))
            if s != 1:
                x = _norm(_c(x, sd, b + ".downsample.0", s), sd, b + ".norm3", batch)
            x = F.relu(x + y)
    return _c(x, sd, key + ".conv2")


# ----------------------------------------------------- correlation, lookup

def pyramid(f1: torch.Tensor, f2: torch.Tensor) -> List[torch.Tensor]:
    """f1, f2 (D, h, w) -> levels (h w, h_i, w_i)."""
    D, h, w = f1.shape
    corr = (f1.reshape(D, h * w).t() @ f2.reshape(D, h * w)) / math.sqrt(D)
    levels = [corr.reshape(h * w, h, w)]
    for _ in range(LEVELS - 1):
        levels.append(F.avg_pool2d(levels[-1][:, None], 2, 2)[:, 0])
    return levels


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img (N, H, W), x and y (N, K) pixel coordinates -> (N, K): the four
    neighbours' values weighted bilinearly, zero outside the image."""
    N, H, W = img.shape
    flat = img.reshape(N, H * W)
    xf, yf = torch.floor(x), torch.floor(y)
    out = torch.zeros_like(x)
    for xi, wx in ((xf, 1 - (x - xf)), (xf + 1, x - xf)):
        for yi, wy in ((yf, 1 - (y - yf)), (yf + 1, y - yf)):
            inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            out = out + torch.where(inside, flat.gather(1, idx), 0.0) * wx * wy
    return out


def lookup(levels: List[torch.Tensor], coords: torch.Tensor,
           track: Optional[dict] = None) -> torch.Tensor:
    """coords (2, h, w) of (x, y) -> (324, h, w); level 0's samples inside
    the map and all its samples added to ``track``."""
    _, h, w = coords.shape
    r = RADIUS
    offsets = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
    # channel 9 a + b: x offset a - r, y offset b - r
    ox = offsets[:, None].expand(2 * r + 1, 2 * r + 1).reshape(1, -1)
    oy = offsets[None, :].expand(2 * r + 1, 2 * r + 1).reshape(1, -1)
    cx, cy = coords[0].reshape(-1, 1), coords[1].reshape(-1, 1)
    out = []
    for i, lv in enumerate(levels):
        x, y = cx / 2 ** i + ox, cy / 2 ** i + oy
        if i == 0 and track is not None:
            H, W = lv.shape[-2:]
            track["inside"] += int(((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)).sum())
            track["samples"] += x.numel()
        out.append(bilinear(lv, x, y))
    return torch.cat(out, 1).t().reshape(-1, h, w)


# ------------------------------------------------------------ update block

def update(sd: SD, net, inp, corr, flow):
    """(net, inp (128, h, w), corr (324, h, w), flow (2, h, w)) -> (net,
    delta flow)."""
    u = "update_block."
    one = lambda t: t[None]  # noqa: E731
    cor = F.relu(_c(one(corr), sd, u + "encoder.convc1"))
    cor = F.relu(_c(cor, sd, u + "encoder.convc2", 1, 1))
    flo = F.relu(_c(one(flow), sd, u + "encoder.convf1", 1, 3))
    flo = F.relu(_c(flo, sd, u + "encoder.convf2", 1, 1))
    motion = torch.cat([F.relu(_c(torch.cat([cor, flo], 1), sd, u + "encoder.conv", 1, 1)),
                        one(flow)], 1)
    x = torch.cat([one(inp), motion], 1)
    h = one(net)
    for i, pad in ((1, (0, 2)), (2, (2, 0))):
        g = f"{u}gru.conv"
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(_c(hx, sd, f"{g}z{i}", 1, pad))
        rr = torch.sigmoid(_c(hx, sd, f"{g}r{i}", 1, pad))
        q = torch.tanh(_c(torch.cat([rr * h, x], 1), sd, f"{g}q{i}", 1, pad))
        h = (1 - z) * h + z * q
    d = _c(F.relu(_c(h, sd, u + "flow_head.conv1", 1, 1)), sd, u + "flow_head.conv2", 1, 1)
    return h[0], d[0]


def upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """flow (2, h, w), mask (576, h, w) -> (2, 8 h, 8 w): sub-pixel (i, j)
    of cell (y, x) is sum_k softmax_k(mask[k, i, j]) 8 flow at neighbour k
    (row-major over the 3x3 around (y, x), zero outside)."""
    _, h, w = flow.shape
    m = torch.softmax(mask.reshape(9, 8, 8, h, w), dim=0)
    padded = F.pad(8 * flow, (1, 1, 1, 1))
    up = torch.zeros(2, 8, 8, h, w, device=flow.device)
    for k in range(9):
        dy, dx = divmod(k, 3)
        up = up + m[k][None] * padded[:, dy:dy + h, dx:dx + w][:, None, None]
    return up.permute(0, 3, 1, 4, 2).reshape(2, 8 * h, 8 * w)


def forward(sd: SD, prev: torch.Tensor, cur: torch.Tensor, init: torch.Tensor,
            track: Optional[dict] = None):
    """prev, cur (BINS, H, W), init (2, h, w) -> (flow_low (2, h, w), flow
    (2, H, W), carried (2, H, W)): ``carried``, the init upsampled with the
    same mask, is the part of ``flow`` that the window did not compute, so
    ``flow - carried`` is the upsampling of the window's own corrections
    ``flow_low - init`` (the upsampling is linear in the flow)."""
    f1 = encoder(prev[None], sd, "fnet")[0]
    f2 = encoder(cur[None], sd, "fnet")[0]
    c = encoder(cur[None], sd, "cnet")[0]
    net, inp = torch.tanh(c[:128]), F.relu(c[128:])
    levels = pyramid(f1, f2)
    _, h, w = f1.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=cur.device),
                            torch.arange(w, dtype=torch.float32, device=cur.device),
                            indexing="ij")
    coords0 = torch.stack([xs, ys])
    coords1 = coords0 + init
    for _ in range(ITERATIONS):
        corr = lookup(levels, coords1, track)
        net, delta = update(sd, net, inp, corr, coords1 - coords0)
        coords1 = coords1 + delta
    u = "update_block."
    mask = 0.25 * _c(F.relu(_c(net[None], sd, u + "mask.0", 1, 1)), sd, u + "mask.2")[0]
    low = coords1 - coords0
    return low, upsample(low, mask), upsample(init, mask)


# ------------------------------------------------------------- warm start

def forward_interpolate(flow: torch.Tensor) -> torch.Tensor:
    """RAFT's forward_interpolate: flow (2, h, w) -> (2, h, w)."""
    _, h, w = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=flow.device),
                            torch.arange(w, dtype=torch.float32, device=flow.device),
                            indexing="ij")
    x0, y0 = xs.reshape(-1), ys.reshape(-1)
    dx, dy = flow[0].reshape(-1), flow[1].reshape(-1)
    x1, y1 = x0 + dx, y0 + dy
    valid = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
    if not bool(valid.any()):
        return torch.zeros_like(flow)
    kx, ky, kdx, kdy = x1[valid], y1[valid], dx[valid], dy[valid]
    out = torch.empty(2, h * w, device=flow.device)
    for lo in range(0, h * w, 1024):
        ex = x0[lo:lo + 1024, None] - kx[None]
        ey = y0[lo:lo + 1024, None] - ky[None]
        nearest = torch.argmin(ex * ex + ey * ey, dim=1)
        out[0, lo:lo + 1024], out[1, lo:lo + 1024] = kdx[nearest], kdy[nearest]
    return out.reshape(2, h, w)


# ---------------------------------------------------------------- a stream

def stream_step(sd: SD, voxel: torch.Tensor, prev: torch.Tensor, init: torch.Tensor, seen: int,
                track: Optional[dict] = None):
    """One window of a stream: this window's voxel grid, the previous one's,
    the carried init (2, h, w) and the windows seen before (0, 1, 2 or more)
    -> (flow (2, H, W), flow_low (2, h, w), the init the window started from
    (2, h, w), ``forward``'s carried (2, H, W)), or None for a stream's
    first window."""
    if seen == 0:
        return None
    start = init if seen >= 2 else torch.zeros_like(init)
    low, flow, carried = forward(sd, prev, voxel, start, track)
    return flow, low, start, carried
