"""Smoke run of the PyTorch/CUDA port (evfly_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``evfly_tpu_torch/csrc`` (one ``nvcc``
call, cached in ``build/``), holds each of K1-K5 against its plain PyTorch
version on the card, then drives the port's paths through the entry points a
user calls, each compared with its plain path on the card and each with the
kernels' launch counts set to 0 just before it and read just after:

- serving: 256 windows x 5,000 raw events -> ``event_histogram_scaled_resized``
  (K3) -> ``LSTMNetVIT`` with ``artifacts/pretrain_v_final.pth`` (its LSTM
  through K4) -> velocity (256, 3);
- the fused rung of ``bench.py``: the same windows -> ``event_histogram_scaled``
  (K2) -> bilinear resize -> ``LSTMNetVIT`` (K4);
- streaming: ``StreamingPipeline.step_events`` with the joint model
  ``OrigUNet_w_VITFLY_ViTLSTM`` and ``artifacts/policy_best.pth`` over 8
  windows of 5,000 events, state carried: ``event_histogram`` (K1) ->
  97th-percentile scale -> OrigUNet with its ConvLSTM -> LSTMNetVIT through
  K4 (mode "stacked") or K5 (mode "wavefront");
- batched streaming: ``BatchedStreamingPipeline`` with 16 streams over 4
  steps, some streams reset before the third, against 16 single streams.

It then times a streaming step and the G-stream rates, in the manner of
``tools/latency_bench.py``.  Every phase prints a flushed line when it starts
and when it ends.  The last lines of standard output are the card's name and
power limit, the kernels' JSON line and the result line
``{"ok": true, "device": {...}}``.

Exits non-zero, and prints no result, when there is no CUDA device, when a
kernel fails to build, launch or agree, or when the run exceeds its budget.
"""

from __future__ import annotations

import json
import os
import signal
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.port import load_state_dict
from evfly_tpu_torch.models.recurrent import set_fused_lstm
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.ops import _build
from evfly_tpu_torch.ops.imageops import interpolate_bilinear
from evfly_tpu_torch.ops.lstm_fused import (
    lstm_stacked,
    lstm_stacked_plain,
    lstm_wavefront,
    lstm_wavefront_plain,
    pack_stacked,
)
from evfly_tpu_torch.ops.voxelizer import (
    bin_events,
    event_histogram_scaled,
    event_histogram_scaled_resized,
    hist_frame,
    hist_frame_plain,
    hist_scaled,
    hist_scaled_plain,
    hist_scaled_resized,
    hist_scaled_resized_plain,
)
from evfly_tpu_torch.stream import BatchedStreamingPipeline, StreamingPipeline

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "artifacts", "pretrain_v_final.pth")
JOINT_CHECKPOINT = os.path.join(REPO, "artifacts", "policy_best.pth")
# the trained joint model's configuration (tools/train_policy.py:238-241)
JOINT_CONFIG = dict(num_in_channels=2, num_out_channels=1, num_recurrent=[1, 0],
                    input_shape=[1, 1, 260, 346], velpred=0, form_BEV=2,
                    evs_min_cutoff=0.0, skip_type="interp")

H, W, H_OUT, W_OUT = 260, 346, 60, 90   # sensor frame -> model input
N_WINDOWS, N_EVENTS = 256, 5000         # the JAX benchmark's serving step
SPARSE_EVENTS = 80                      # a window whose 97th percentile is 0
T, L, HID, IN = N_WINDOWS, 3, 128, 517  # LSTMNetVIT's LSTM over the windows
BIG_EVENTS, HOT_EVENTS = 100_000, 40_000  # K1's window past any int16 count
STREAM_WINDOWS, STREAMS = 8, 16         # streaming steps; batched streams
# tools/latency_bench.py's counts: chained and synchronized streaming
# steps, and batched steps at each number of streams
CHAINED_STEPS, SYNC_STEPS, RATE_STEPS, RATE_STREAMS = 100, 20, 30, (16, 64)

# tolerances: the JAX package's own bounds for the TPU kernels
# (tests/test_fused_voxelizer.py:34,68, tests/test_lstm_pallas.py:53,79) and
# the velocity bound of the port's tests; K1's counts are exact
K2_ATOL, K3_ATOL, K4_ATOL, K4_ATOL_CARRIED, VEL_ATOL = 2e-5, 3e-5, 2e-5, 3e-5, 1e-4

BUDGET_S = 600  # the whole run, cold build included
# H100 SXM datasheet peaks: HBM bytes/s, f32 FLOP/s
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"phase {self.name}: start")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        state = "done" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        log(f"phase {self.name}: {state} in {time.perf_counter() - self.t0:.1f}s")
        return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class L2Flush:
    """Writes 64 MiB (more than the 50 MB L2) so that the next launch finds
    its inputs in device memory, as a serving step does."""

    def __init__(self, device):
        self.buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self):
        self.buf.fill_(1)


def time_ms(fn, flush: L2Flush, reps: int, warmup: int = 2) -> float:
    """Median device time of one call of ``fn``, L2 flushed before each.
    A spin kernel ahead of the flush keeps the card busy while the host
    queues the call, so the time is the device's, not the wrapper's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    """Least time for the work: bytes over HBM rate vs f32 ops over peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, ref) -> float:
    return max((a - r).abs().max().item() for a, r in zip(got, ref))


def make_events(seed: int, B: int, N: int, device):
    rng = np.random.default_rng(seed)
    ex = torch.tensor(rng.uniform(0, W, (B, N)), dtype=torch.float32, device=device)
    ey = torch.tensor(rng.uniform(0, H, (B, N)), dtype=torch.float32, device=device)
    ep = torch.tensor(rng.choice([-1, 1], (B, N)), dtype=torch.int32, device=device)
    return ex, ey, ep


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build():
    info = _build.build()
    _build.library()
    log(f"build: {info.seconds:.1f}s, cache hit: {info.cache_hit}, {info.path.name}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  nvcc: {line.strip()}")


def phase_k3(dev, flush):
    ex, ey, ep = make_events(0, N_WINDOWS, N_EVENTS, dev)
    out, q = hist_scaled_resized(ex, ey, ep, H, W, H_OUT, W_OUT)
    ref, qref = hist_scaled_resized_plain(ex, ey, ep, H, W, H_OUT, W_OUT)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    q_bad = int((q != qref).sum().item())
    log(f"K3 {N_WINDOWS}x{N_EVENTS} events: max|diff| {err:.3e} (atol {K3_ATOL}), "
        f"q mismatches {q_bad}, q range [{q.min().item()}, {q.max().item()}]")
    require(out.shape == (N_WINDOWS, H_OUT, W_OUT), f"K3 output shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "K3 output not finite")
    require(err <= K3_ATOL and q_bad == 0, "K3 disagrees with its plain version")

    sx, sy, sp = make_events(1, 2, SPARSE_EVENTS, dev)
    s_out, s_q = hist_scaled_resized(sx, sy, sp, H, W, H_OUT, W_OUT)
    s_ref, s_qref = hist_scaled_resized_plain(sx, sy, sp, H, W, H_OUT, W_OUT)
    torch.cuda.synchronize()
    s_err = (s_out - s_ref).abs().max().item()
    log(f"K3 sparse {SPARSE_EVENTS} events: q {s_q.tolist()} (plain {s_qref.tolist()}), "
        f"max|diff| {s_err:.3e}")
    require(bool((s_q == 0).all()) and bool((s_qref == 0).all()), "zero-quantile snap missed")
    require(s_err <= K3_ATOL, "K3 sparse window disagrees with its plain version")

    ms = time_ms(lambda: hist_scaled_resized(ex, ey, ep, H, W, H_OUT, W_OUT), flush, 20)
    plain_ms = time_ms(lambda: hist_scaled_resized_plain(ex, ey, ep, H, W, H_OUT, W_OUT),
                       flush, 5)
    n_bytes = sum(t.numel() * t.element_size() for t in (ex, ey, ep, out, q))
    valid_events = N_WINDOWS * N_EVENTS
    # one add per event, |count| and its table entry per cell, and per output
    # 4 scalings + 6 resize flops
    n_flops = valid_events + 2 * N_WINDOWS * H * W + N_WINDOWS * H_OUT * W_OUT * 10
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    log(f"K3 times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def phase_k4(dev, flush):
    gen = torch.Generator().manual_seed(4)
    b = 1.0 / HID ** 0.5
    # cuDNN's LSTM with the same weights: the yardstick (library_ms) only
    lstm = torch.nn.LSTM(IN, HID, L)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.empty_like(p).uniform_(-b, b, generator=gen))
    lstm = lstm.to(dev)
    params = {k: v.detach() for k, v in lstm.named_parameters()}
    x = torch.randn(T, IN, generator=gen).to(dev)
    h0 = (torch.randn(L, HID, generator=gen) * 0.5).to(dev)
    c0 = (torch.randn(L, HID, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        xp0 = x @ params["weight_ih_l0"].T + params["bias_ih_l0"] + params["bias_hh_l0"]
        whh_t, wih_t, bias = pack_stacked(params, L, HID)
        zeros = torch.zeros(L, HID, device=dev)
        errs = {}
        for label, (hh, cc), atol in (("zero state", (zeros, zeros), K4_ATOL),
                                      ("carried state", (h0, c0), K4_ATOL_CARRIED)):
            got = lstm_stacked(xp0, whh_t, wih_t, bias, hh, cc)
            ref = lstm_stacked_plain(xp0, whh_t, wih_t, bias, hh, cc)
            torch.cuda.synchronize()
            err = max((a - r).abs().max().item() for a, r in zip(got, ref))
            errs[label] = err
            log(f"K4 T={T} L={L} H={HID} {label}: max|diff| {err:.3e} (atol {atol})")
            require(all(bool(torch.isfinite(a).all()) for a in got), "K4 output not finite")
            require(err <= atol, f"K4 disagrees with its plain version ({label})")
        lib_out, _ = lstm(x, (h0, c0))
        k4_out, _, _ = lstm_stacked(xp0, whh_t, wih_t, bias, h0, c0)
        log(f"K4 vs torch.nn.LSTM (yardstick only): max|diff| "
            f"{(lib_out - k4_out).abs().max().item():.3e}")

        ms = time_ms(lambda: lstm_stacked(xp0, whh_t, wih_t, bias, h0, c0), flush, 10)
        plain_ms = time_ms(lambda: lstm_stacked_plain(xp0, whh_t, wih_t, bias, h0, c0),
                           flush, 3, warmup=1)
        library_ms = time_ms(lambda: lstm(x, (h0, c0)), flush, 10)
    G = 4 * HID
    n_bytes = sum(t.numel() * 4 for t in (xp0, whh_t, wih_t, bias, h0, c0)) \
        + (T * HID + 2 * L * HID) * 4
    n_flops = 2 * T * HID * G * (2 * L - 1)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    log(f"K4 times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.nn.LSTM "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def phase_k1(dev, flush):
    """K1 exactly equal to its plain version; times at the streaming
    path's shape, one window of 5,000 events."""
    cases = []
    ex, ey, ep = make_events(10, 1, N_EVENTS, dev)
    cases.append(("5,000 uniform events", (ex, ey, ep), (0.2, 0.2)))
    cases.append(("pos 0.2 / neg 0.3", (ex, ey, ep), (0.2, 0.3)))
    bx, by, bp = make_events(11, 1, BIG_EVENTS, dev)
    bx[:, :HOT_EVENTS], by[:, :HOT_EVENTS], bp[:, :HOT_EVENTS] = 100.5, 130.5, 1
    cases.append((f"{BIG_EVENTS:,} events, {HOT_EVENTS:,} on one pixel", (bx, by, bp),
                  (0.2, 0.2)))
    cases.append((f"{BIG_EVENTS:,} events, two-pass", (bx, by, bp), (0.2, 0.3)))
    err = 0.0
    for label, events, thresholds in cases:
        got = hist_frame(*events, H, W, *thresholds)
        ref = hist_frame_plain(*events, H, W, *thresholds)
        torch.cuda.synchronize()
        bad = int((got != ref).sum().item())
        err = max(err, (got - ref).abs().max().item())
        log(f"K1 {label}: {bad} cells differ of {got.numel()}, max|frame| "
            f"{got.abs().max().item():.1f}")
        require(got.shape == (1, H, W) and bool(torch.isfinite(got).all()), "K1 output")
        require(bad == 0, f"K1 disagrees with its plain version ({label})")

    xi, yi, sign = bin_events(ex, ey, ep, H, W)
    idx = (yi * W + xi)[0]
    ms = time_ms(lambda: hist_frame(ex, ey, ep, H, W), flush, 20)
    plain_ms = time_ms(lambda: hist_frame_plain(ex, ey, ep, H, W), flush, 10)
    library_ms = time_ms(lambda: torch.bincount(idx, weights=sign[0], minlength=H * W),
                         flush, 10)
    # each event read once (12 bytes), the frame written once; one add per
    # event and one multiply per cell
    n_bytes = 12 * N_EVENTS + 4 * H * W
    b_ms, b_by = bound_ms(n_bytes, N_EVENTS + H * W)
    log(f"K1 times (1 x {N_EVENTS} events): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.bincount {library_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def phase_k2(dev, flush):
    ex, ey, ep = make_events(0, N_WINDOWS, N_EVENTS, dev)
    out, q = hist_scaled(ex, ey, ep, H, W)
    ref, qref = hist_scaled_plain(ex, ey, ep, H, W)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    q_bad = int((q != qref).sum().item())
    log(f"K2 {N_WINDOWS}x{N_EVENTS} events: max|diff| {err:.3e} (atol {K2_ATOL}), "
        f"q mismatches {q_bad}")
    require(out.shape == (N_WINDOWS, H, W) and bool(torch.isfinite(out).all()), "K2 output")
    require(err <= K2_ATOL and q_bad == 0, "K2 disagrees with its plain version")

    sx, sy, sp = make_events(1, 2, SPARSE_EVENTS, dev)
    s_out, s_q = hist_scaled(sx, sy, sp, H, W)
    s_ref, s_qref = hist_scaled_plain(sx, sy, sp, H, W)
    torch.cuda.synchronize()
    s_err = (s_out - s_ref).abs().max().item()
    log(f"K2 sparse {SPARSE_EVENTS} events: q {s_q.tolist()} (plain {s_qref.tolist()}), "
        f"max|diff| {s_err:.3e}")
    require(bool((s_q == 0).all()) and bool((s_qref == 0).all()), "zero-quantile snap missed")
    require(s_err <= K2_ATOL, "K2 sparse window disagrees with its plain version")

    ms = time_ms(lambda: hist_scaled(ex, ey, ep, H, W), flush, 20)
    plain_ms = time_ms(lambda: hist_scaled_plain(ex, ey, ep, H, W), flush, 5)
    n_bytes = sum(t.numel() * t.element_size() for t in (ex, ey, ep, out, q))
    # one add per event, |count| and its table entry per cell, scale and
    # clip per cell
    n_flops = N_WINDOWS * N_EVENTS + 4 * N_WINDOWS * H * W
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    log(f"K2 times: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def _lstm_problem(dev, seed, G, T):
    """cuDNN's LSTM (the yardstick only) and, from its weights, the kernels'
    packed layouts, layer-0 gates (G, T, 4H) and a carried state (G, L, H)."""
    gen = torch.Generator().manual_seed(seed)
    b = 1.0 / HID ** 0.5
    lstm = torch.nn.LSTM(IN, HID, L)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.empty_like(p).uniform_(-b, b, generator=gen))
    lstm = lstm.to(dev)
    params = {k: v.detach() for k, v in lstm.named_parameters()}
    x = torch.randn(G, T, IN, generator=gen).to(dev)
    h0 = (torch.randn(G, L, HID, generator=gen) * 0.5).to(dev)
    c0 = (torch.randn(G, L, HID, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        xp0 = x @ params["weight_ih_l0"].T + params["bias_ih_l0"] + params["bias_hh_l0"]
    return lstm, x, xp0, pack_stacked(params, L, HID), h0, c0


def _check_lstm(name, kernel, plain, xp0, packed, h0, c0):
    zeros = torch.zeros_like(h0)
    errs = []
    for label, (hh, cc), atol in (("zero state", (zeros, zeros), K4_ATOL),
                                  ("carried state", (h0, c0), K4_ATOL_CARRIED)):
        got = kernel(xp0, *packed, hh, cc)
        ref = plain(xp0, *packed, hh, cc)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        errs.append(err)
        log(f"{name} G={xp0.shape[0]} T={xp0.shape[1]} L={L} H={HID} {label}: "
            f"max|diff| {err:.3e} (atol {atol})")
        require(all(bool(torch.isfinite(a).all()) for a in got), f"{name} output not finite")
        require(err <= atol, f"{name} disagrees with its plain version ({label})")
    return max(errs)


def _lstm_times(kernel, plain, lstm, x, xp0, packed, h0, c0, flush, plain_reps):
    G, T = xp0.shape[:2]
    ms = time_ms(lambda: kernel(xp0, *packed, h0, c0), flush, 10)
    plain_ms = time_ms(lambda: plain(xp0, *packed, h0, c0), flush, plain_reps, warmup=1)
    # cuDNN's LSTM takes (T, G, in) with (L, G, H) states
    xs, hs, cs = x.transpose(0, 1).contiguous(), h0.transpose(0, 1).contiguous(), \
        c0.transpose(0, 1).contiguous()
    library_ms = time_ms(lambda: lstm(xs, (hs, cs)), flush, 10)
    n_bytes = sum(t.numel() * 4 for t in (xp0, *packed, h0, c0)) \
        + (G * T * HID + 2 * G * L * HID) * 4
    n_flops = 2 * G * T * HID * 4 * HID * (2 * L - 1)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return ms, plain_ms, library_ms, b_ms, b_by


def phase_k5(dev, flush):
    """K5 against its plain version at the serving length and the short
    sequences of the wavefront's corners; times at the streaming path's
    shape (one stream, T = 1) and at T = 256 beside K4."""
    lstm, x, xp0, packed, h0, c0 = _lstm_problem(dev, 5, 1, T)
    with torch.no_grad():
        err = _check_lstm("K5", lstm_wavefront, lstm_wavefront_plain, xp0, packed, h0, c0)
        for t_short in (1, 2):
            err = max(err, _check_lstm("K5", lstm_wavefront, lstm_wavefront_plain,
                                       xp0[:, :t_short], packed, h0, c0))
        k5_out = lstm_wavefront(xp0[0], *packed, h0[0], c0[0])[0]
        lib_out, _ = lstm(x[0], (h0[0], c0[0]))
        log(f"K5 vs torch.nn.LSTM (yardstick only): max|diff| "
            f"{(lib_out - k5_out).abs().max().item():.3e}")
        long_ms = _lstm_times(lstm_wavefront, lstm_wavefront_plain, lstm, x, xp0, packed,
                              h0, c0, flush, 3)
        log("K5 times at T=%d: kernel %.4f ms, plain %.4f ms, torch.nn.LSTM %.4f ms, "
            "bound %.4f ms (%s)" % ((T,) + long_ms))
        one = _lstm_times(lstm_wavefront, lstm_wavefront_plain, lstm, x[:, :1], xp0[:, :1],
                          packed, h0, c0, flush, 10)
    ms, plain_ms, library_ms, b_ms, b_by = one
    log(f"K5 times at G=1 T=1 (streaming): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.nn.LSTM {library_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def phase_streams(dev, flush):
    """K4 and K5 with a stream axis: G = 16 streams of T = 1, the batched
    streaming path's shape, one launch each."""
    lstm, x, xp0, packed, h0, c0 = _lstm_problem(dev, 6, STREAMS, 1)
    with torch.no_grad():
        for name, kernel, plain in (("K4", lstm_stacked, lstm_stacked_plain),
                                    ("K5", lstm_wavefront, lstm_wavefront_plain)):
            _check_lstm(name, kernel, plain, xp0, packed, h0, c0)
            ms, plain_ms, library_ms, b_ms, _ = _lstm_times(
                kernel, plain, lstm, x, xp0, packed, h0, c0, flush, 10)
            log(f"{name} times at G={STREAMS} T=1: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, torch.nn.LSTM {library_ms:.4f} ms, bound {b_ms:.6f} ms")


def phase_main_path(dev, smi):
    model = LSTMNetVIT(device=dev).eval().load_params(load_state_dict(CHECKPOINT))
    ex, ey, ep = make_events(2, N_WINDOWS, N_EVENTS, dev)
    desvel = torch.full((N_WINDOWS, 1), 4.0, device=dev)

    def step():
        small = event_histogram_scaled_resized(ex, ey, ep, H, W, H_OUT, W_OUT, device=dev)
        return model(small[:, None], desvel)

    with torch.inference_mode():
        set_fused_lstm(True)
        hist_scaled_resized.launches = 0
        lstm_stacked.launches = 0
        vel, (h, c) = step()
        torch.cuda.synchronize()
        launches = {"K3": hist_scaled_resized.launches, "K4": lstm_stacked.launches}
        log(f"main path launches: {launches}")
        require(all(n > 0 for n in launches.values()), "a kernel of the path never launched")

        set_fused_lstm(False)
        small_p, _ = hist_scaled_resized_plain(ex, ey, ep, H, W, H_OUT, W_OUT)
        vel_p, (h_p, c_p) = model(small_p[:, None], desvel)
        set_fused_lstm(True)
        torch.cuda.synchronize()
        err = (vel - vel_p).abs().max().item()
        herr = (h - h_p).abs().max().item()
        cerr = (c - c_p).abs().max().item()
        cmax = c_p.abs().max().item()
        log(f"velocity {tuple(vel.shape)}: max|diff| vs plain path {err:.3e} (atol {VEL_ATOL}); "
            f"h max|diff| {herr:.3e}; c max|diff| {cerr:.3e} at max|c| {cmax:.3f}; "
            f"mean velocity {vel.mean(0).tolist()}")
        require(vel.shape == (N_WINDOWS, 3), f"velocity shape {tuple(vel.shape)}")
        require(bool(torch.isfinite(vel).all()), "velocity not finite")
        require(err <= VEL_ATOL and herr <= VEL_ATOL, "main path disagrees with the plain path")
        # the cell state is unbounded (it sums over 256 steps): its bound
        # scales with its size
        require(cerr <= VEL_ATOL * max(1.0, cmax), "LSTM cell state disagrees with the plain path")

        for _ in range(3):
            step()
        reps = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                step()
            torch.cuda.synchronize()
            reps.append(10 * N_WINDOWS / (time.perf_counter() - t0))
    wps = statistics.median(reps)
    log(f"main path: {wps:.1f} windows/s median of 5 reps x 10 steps "
        f"(min {min(reps):.1f}, max {max(reps):.1f}) on {smi}, f32, TF32 off")
    return launches, wps, step


def phase_fused_rung(dev):
    """bench.py's fused rung: events -> event_histogram_scaled (K2) ->
    bilinear 60x90 -> LSTMNetVIT (K4), against its plain path."""
    model = LSTMNetVIT(device=dev).eval().load_params(load_state_dict(CHECKPOINT))
    ex, ey, ep = make_events(2, N_WINDOWS, N_EVENTS, dev)
    desvel = torch.full((N_WINDOWS, 1), 4.0, device=dev)
    with torch.inference_mode():
        set_fused_lstm(True)
        hist_scaled.launches = 0
        lstm_stacked.launches = 0
        frames = event_histogram_scaled(ex, ey, ep, H, W, device=dev)
        vel, (h, c) = model(interpolate_bilinear(frames[:, None], (H_OUT, W_OUT)), desvel)
        torch.cuda.synchronize()
        launches = {"K2": hist_scaled.launches, "K4": lstm_stacked.launches}
        log(f"fused rung launches: {launches}")
        require(all(n > 0 for n in launches.values()), "a kernel of the fused rung never launched")

        set_fused_lstm(False)
        frames_p, _ = hist_scaled_plain(ex, ey, ep, H, W)
        vel_p, (h_p, c_p) = model(interpolate_bilinear(frames_p[:, None], (H_OUT, W_OUT)), desvel)
        set_fused_lstm(True)
        torch.cuda.synchronize()
    err, herr = (vel - vel_p).abs().max().item(), (h - h_p).abs().max().item()
    cerr, cmax = (c - c_p).abs().max().item(), c_p.abs().max().item()
    log(f"fused rung velocity {tuple(vel.shape)}: max|diff| vs plain path {err:.3e}; h "
        f"{herr:.3e}; c {cerr:.3e} at max|c| {cmax:.3f}")
    require(vel.shape == (N_WINDOWS, 3) and bool(torch.isfinite(vel).all()), "velocity")
    require(err <= VEL_ATOL and herr <= VEL_ATOL and cerr <= VEL_ATOL * max(1.0, cmax),
            "fused rung disagrees with its plain path")
    return launches


def joint_model(dev):
    """The trained joint model on the card, with policy_best.pth."""
    model = OrigUNet_w_VITFLY_ViTLSTM(device=dev, **JOINT_CONFIG).eval()
    return model.load_params(load_state_dict(JOINT_CHECKPOINT))


def stream_windows(dev, n: int):
    """n windows of N_EVENTS raw events, (x, y, pol) of shape (N,) each."""
    ex, ey, ep = make_events(3, n, N_EVENTS, dev)
    return [(ex[i], ey[i], ep[i]) for i in range(n)]


def state_errs(hidden, ref):
    """(max |h - h_ref| over the ConvLSTM's and the ViTLSTM's h, max over
    their c of |c - c_ref| / max(1, max|c_ref|)) for one stream's states."""
    ((unet, _), (hv, cv)), ((unet_r, _), (hv_r, cv_r)) = hidden, ref
    pairs_h = [(unet[0][0], unet_r[0][0]), (hv, hv_r)]
    pairs_c = [(unet[0][1], unet_r[0][1]), (cv, cv_r)]
    herr = max((a - b).abs().max().item() for a, b in pairs_h)
    cerr = max((a - b).abs().max().item() / max(1.0, b.abs().max().item()) for a, b in pairs_c)
    return herr, cerr


def phase_streaming(dev, model):
    """StreamingPipeline.step_events over STREAM_WINDOWS windows, state
    carried, in each LSTM mode and percentile mode, against the plain path
    (plain K1, set_fused_lstm(False)) on the same model."""
    windows = stream_windows(dev, STREAM_WINDOWS)
    launches = {}
    for mode, kernel, key in (("stacked", lstm_stacked, "K4"),
                              ("wavefront", lstm_wavefront, "K5")):
        for fast in (False, True):
            model.vitfly_vitlstm.lstm.mode = mode
            pipe = StreamingPipeline(model, fast_percentile=fast, device=dev)
            plain = StreamingPipeline(model, fast_percentile=fast, device=dev)
            set_fused_lstm(True)
            hist_frame.launches = lstm_stacked.launches = lstm_wavefront.launches = 0
            outs = [pipe.step_events(*w) for w in windows]
            torch.cuda.synchronize()
            counts = {"K1": hist_frame.launches, key: kernel.launches}
            require(all(n > 0 for n in counts.values()),
                    f"a kernel of the streaming path ({mode}) never launched")
            if not fast:
                launches.update(counts)
            set_fused_lstm(False)
            refs = [plain.step_frame(hist_frame_plain(ex[None], ey[None], ep[None], H, W)[0])
                    for ex, ey, ep in windows]
            set_fused_lstm(True)
            torch.cuda.synchronize()
            verr = max((v - vr).abs().max().item() for (v, _), (vr, _) in zip(outs, refs))
            derr = max((d - dr).abs().max().item() for (_, d), (_, dr) in zip(outs, refs))
            herr, cerr = state_errs(pipe.hidden, plain.hidden)
            log(f"streaming {mode}, fast_percentile={fast}: launches {counts}; over "
                f"{STREAM_WINDOWS} windows max|diff| vs plain path: velocity {verr:.3e}, "
                f"depth {derr:.3e}, h {herr:.3e}, c/max(1,|c|) {cerr:.3e}; last velocity "
                f"{outs[-1][0].tolist()}")
            require(all(v.shape == (3,) and d.shape == (H, W) for v, d in outs), "shapes")
            require(all(bool(torch.isfinite(v).all()) and bool(torch.isfinite(d).all())
                        for v, d in outs), "streaming output not finite")
            require(max(verr, derr, herr, cerr) <= VEL_ATOL,
                    f"streaming path ({mode}, fast={fast}) disagrees with the plain path")
    model.vitfly_vitlstm.lstm.mode = None
    return launches, windows


def sparse_frames(seed: int, shape, dev) -> torch.Tensor:
    """Sparse signed event frames, as tools/latency_bench.py makes them."""
    rng = np.random.default_rng(seed)
    frames = (rng.integers(-3, 4, shape) * (rng.random(shape) < 0.08)) * 0.2
    return torch.tensor(frames, dtype=torch.float32, device=dev)


def _one_stream(hidden, g):
    """Stream g's state of a batched hidden state, with the single stream's
    shapes."""
    (unet, _), (h, c) = hidden
    return ([(hu[g:g + 1], cu[g:g + 1]) for hu, cu in unet], None), (h[g], c[g])


def phase_batched(dev, model, steps: int = 4):
    """BatchedStreamingPipeline with STREAMS streams over ``steps`` steps,
    streams 1, 5, 9, 13 reset before the third, against STREAMS single-stream
    plain runs."""
    frames = sparse_frames(4, (steps, STREAMS, H, W), dev)
    masks = [torch.tensor([s == 2 and g % 4 == 1 for g in range(STREAMS)], device=dev)
             for s in range(steps)]
    desvel = [3.0 + 2.0 * g / (STREAMS - 1) for g in range(STREAMS)]
    set_fused_lstm(True)
    lstm_stacked.launches = lstm_wavefront.launches = 0
    pipe = BatchedStreamingPipeline(model, STREAMS, desvel=desvel, fast_percentile=True,
                                    device=dev)
    outs = [pipe.step_frames(frames[s], masks[s]) for s in range(steps)]
    torch.cuda.synchronize()
    counts = {"K4": lstm_stacked.launches, "K5": lstm_wavefront.launches}
    require(sum(counts.values()) > 0, "the batched path launched no LSTM kernel")
    set_fused_lstm(False)
    verr = derr = herr = cerr = 0.0
    for g in range(STREAMS):
        single = StreamingPipeline(model, desvel=desvel[g], fast_percentile=True, device=dev)
        for s in range(steps):
            if masks[s][g]:
                single.reset()
            v, d = single.step_frame(frames[s, g])
            verr = max(verr, (outs[s][0][g] - v).abs().max().item())
            derr = max(derr, (outs[s][1][g] - d).abs().max().item())
        he, ce = state_errs(_one_stream(pipe.hidden, g), single.hidden)
        herr, cerr = max(herr, he), max(cerr, ce)
    set_fused_lstm(True)
    log(f"batched G={STREAMS} x {steps} steps: launches {counts}; max|diff| vs {STREAMS} "
        f"single plain streams: velocity {verr:.3e}, depth {derr:.3e}, h {herr:.3e}, "
        f"c/max(1,|c|) {cerr:.3e}")
    require(outs[-1][0].shape == (STREAMS, 3) and outs[-1][1].shape == (STREAMS, H, W),
            "batched shapes")
    require(max(verr, derr, herr, cerr) <= VEL_ATOL, "batched path disagrees with single streams")


def phase_card_numbers(dev, model, windows, smi):
    """tools/latency_bench.py's numbers on the card: ms per streaming step
    over 100 chained steps (one synchronize), p50 of 20 synchronized steps,
    and steps/s of G streams stepped together."""
    numbers = {}
    with torch.inference_mode():
        for mode in ("stacked", "wavefront"):
            model.vitfly_vitlstm.lstm.mode = mode
            pipe = StreamingPipeline(model, fast_percentile=True, device=dev)
            for w in windows[:3]:
                pipe.step_events(*w)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(CHAINED_STEPS):
                vel, _ = pipe.step_events(*windows[i % len(windows)])
            torch.cuda.synchronize()
            chained = (time.perf_counter() - t0) / CHAINED_STEPS * 1e3
            samples = []
            for i in range(SYNC_STEPS):
                t0 = time.perf_counter()
                vel, _ = pipe.step_events(*windows[i % len(windows)])
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            p50 = statistics.median(samples)
            numbers[mode] = (chained, p50)
            log(f"streaming step ({mode}, fast percentile): {chained:.3f} ms per step over "
                f"{CHAINED_STEPS} chained steps; p50 {p50:.3f} ms of {SYNC_STEPS} synchronized (min {min(samples):.3f}, "
                f"max {max(samples):.3f}) on {smi}")
        model.vitfly_vitlstm.lstm.mode = None
        for G in RATE_STREAMS:
            frames = sparse_frames(5, (G, H, W), dev)
            pipe = BatchedStreamingPipeline(model, G, fast_percentile=True, device=dev)
            for _ in range(2):
                pipe.step_frames(frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(RATE_STEPS):
                pipe.step_frames(frames)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            numbers[G] = G * RATE_STEPS / dt
            log(f"batched G={G}: {numbers[G]:.1f} steps/s ({dt / RATE_STEPS * 1e3:.3f} ms per "
                f"batched step, {int(numbers[G] / 15.0)} streams at 15 Hz) on {smi}")
    return numbers


_SERVING_KERNELS = {"K3": "hist_scaled_resized_kernel", "K4": "lstm_stacked_kernel"}


def phase_profile(step, kernel_names=_SERVING_KERNELS, label="main-path"):
    """Device time of 3 steps of a path by kernel, under torch.profiler;
    ``kernel_names`` maps a label to a substring of a kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log("profile: the trace has no device time (not measured)")
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    share = {**{k: 0.0 for k in kernel_names}, "other": 0.0}
    others = {}
    for e in kernels:
        key = next((k for k, sub in kernel_names.items() if sub in e.name), "other")
        share[key] += e.time_range.elapsed_us()
        if key == "other":
            n, us = others.get(e.name, (0, 0.0))
            others[e.name] = (n + 1, us + e.time_range.elapsed_us())
    log(f"profile of 3 {label} steps: device busy {busy / 1e3:.3f} ms over a {span / 1e3:.3f} ms span "
        f"(idle share {1 - busy / span:.3f}); device ms by kernel: "
        + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in share.items())
        + f"; {len(kernels)} kernels")
    for name, (n, us) in sorted(others.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  other: {us / 1e3:8.3f} ms in {n:5d} launches  {name[:90]}")


def _on_alarm(signum, frame):
    raise TimeoutError(f"chip_smoke exceeded its {BUDGET_S}s budget")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(BUDGET_S)
    dev = torch.device("cuda")
    # full f32 in every comparison and time: TF32 off for convolutions and
    # cuDNN's LSTM (cuDNN's default is on) and for matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off: torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")
    with Phase("device"):
        name, smi = phase_device()
    with Phase("build"):
        phase_build()
    flush = L2Flush(dev)
    with Phase("K1 vs plain"):
        k1 = phase_k1(dev, flush)
    with Phase("K2 vs plain"):
        k2 = phase_k2(dev, flush)
    with Phase("K3 vs plain"):
        k3 = phase_k3(dev, flush)
    with Phase("K4 vs plain"):
        k4 = phase_k4(dev, flush)
    with Phase("K5 vs plain"):
        k5 = phase_k5(dev, flush)
    with Phase(f"K4 and K5 with {STREAMS} streams"):
        phase_streams(dev, flush)
    with Phase("main path"):
        launches, wps, step = phase_main_path(dev, smi)
    with Phase("profile"):
        phase_profile(step)
    with Phase("fused rung"):
        rung_launches = phase_fused_rung(dev)
    model = joint_model(dev)
    with Phase("streaming path"):
        stream_launches, windows = phase_streaming(dev, model)
    with Phase(f"batched streaming, {STREAMS} streams"):
        phase_batched(dev, model)
    with Phase("card numbers"):
        numbers = phase_card_numbers(dev, model, windows, smi)
    with Phase("streaming profile"):
        pipe = StreamingPipeline(model, fast_percentile=True, device=dev)
        phase_profile(lambda: pipe.step_events(*windows[0]),
                      {"K1": "hist_frame_kernel", "K4": "lstm_stacked_kernel"}, "streaming")
    with Phase(f"batched profile, {STREAMS} streams"):
        bpipe = BatchedStreamingPipeline(model, STREAMS, fast_percentile=True, device=dev)
        bframes = sparse_frames(6, (STREAMS, H, W), dev)
        phase_profile(lambda: bpipe.step_frames(bframes), {"K4": "lstm_stacked_kernel"},
                      f"batched G={STREAMS}")
    signal.alarm(0)

    def entry(name, source, replaces, n, **times):
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=n,
                    **times)

    vox, lstm_src = "evfly_tpu_torch/csrc/voxelizer.cu", "evfly_tpu_torch/csrc/lstm.cu"
    kernels = [
        entry("hist_frame (K1)", vox, "evfly_tpu/ops/voxelizer.py:153",
              stream_launches["K1"], **k1),
        entry("hist_scaled (K2)", vox, "evfly_tpu/ops/voxelizer.py:251", rung_launches["K2"],
              **k2),
        entry("hist_scaled_resized (K3)", vox, "evfly_tpu/ops/voxelizer.py:405",
              launches["K3"], **k3),
        entry("lstm_stacked (K4)", lstm_src, "evfly_tpu/ops/lstm_pallas.py:111",
              launches["K4"], **k4),
        entry("lstm_wavefront (K5)", lstm_src, "evfly_tpu/ops/lstm_pallas.py:203",
              stream_launches["K5"], **k5),
    ]
    log(f"done in {time.perf_counter() - _T0:.1f}s; main path {wps:.1f} windows/s; streaming "
        f"{numbers['stacked'][0]:.3f} ms per chained step (stacked), "
        f"{numbers['wavefront'][0]:.3f} (wavefront); steps/s "
        + ", ".join(f"G={G} {numbers[G]:.1f}" for G in RATE_STREAMS))
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
