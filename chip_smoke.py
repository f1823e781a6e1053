"""Smoke run of the PyTorch/CUDA port (evfly_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``evfly_tpu_torch/csrc`` (one ``nvcc``
call, cached in ``build/``), holds each against its plain PyTorch version on
the card, then drives the serving path once through the entry points a user
calls: 256 windows x 5,000 raw events -> ``event_histogram_scaled_resized``
(kernel K3) -> ``LSTMNetVIT`` with the trained ``artifacts/pretrain_v_final.pth``
weights (its LSTM through kernel K4) -> velocity (256, 3), compared with the
plain path on the card.  Every phase prints a flushed line when it starts
and when it ends.  The last two lines of standard output are the kernels'
JSON line and the result line ``{"ok": true, "device": {...}}``.

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

from evfly_tpu_torch.models.port import load_state_dict
from evfly_tpu_torch.models.recurrent import set_fused_lstm
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.ops import _build
from evfly_tpu_torch.ops.lstm_fused import lstm_stacked, lstm_stacked_plain, pack_stacked
from evfly_tpu_torch.ops.voxelizer import (
    event_histogram_scaled_resized,
    hist_scaled_resized,
    hist_scaled_resized_plain,
)

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "artifacts", "pretrain_v_final.pth")

H, W, H_OUT, W_OUT = 260, 346, 60, 90   # sensor frame -> model input
N_WINDOWS, N_EVENTS = 256, 5000         # the JAX benchmark's serving step
SPARSE_EVENTS = 80                      # a window whose 97th percentile is 0
T, L, HID, IN = N_WINDOWS, 3, 128, 517  # LSTMNetVIT's LSTM over the windows

# tolerances: the JAX package's own bounds for the TPU kernels
# (tests/test_fused_voxelizer.py:68, tests/test_lstm_pallas.py:53,79) and
# the velocity bound of the port's tests
K3_ATOL, K4_ATOL, K4_ATOL_CARRIED, VEL_ATOL = 3e-5, 2e-5, 3e-5, 1e-4

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


def phase_profile(step):
    """Device time of 3 main-path steps by kernel, under torch.profiler."""
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
    share = {"K3": 0.0, "K4": 0.0, "other": 0.0}
    others = {}
    for e in kernels:
        key = ("K3" if "hist_scaled_resized_kernel" in e.name
               else "K4" if "lstm_stacked_kernel" in e.name else "other")
        share[key] += e.time_range.elapsed_us()
        if key == "other":
            n, us = others.get(e.name, (0, 0.0))
            others[e.name] = (n + 1, us + e.time_range.elapsed_us())
    log(f"profile of 3 steps: device busy {busy / 1e3:.3f} ms over a {span / 1e3:.3f} ms span "
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
    with Phase("K3 vs plain"):
        k3 = phase_k3(dev, flush)
    with Phase("K4 vs plain"):
        k4 = phase_k4(dev, flush)
    with Phase("main path"):
        launches, wps, step = phase_main_path(dev, smi)
    with Phase("profile"):
        phase_profile(step)
    signal.alarm(0)

    kernels = [
        dict(name="hist_scaled_resized (K3)", route="cuda",
             source="evfly_tpu_torch/csrc/voxelizer.cu",
             replaces="evfly_tpu/ops/voxelizer.py:405", launches=launches["K3"], **k3),
        dict(name="lstm_stacked (K4)", route="cuda", source="evfly_tpu_torch/csrc/lstm.cu",
             replaces="evfly_tpu/ops/lstm_pallas.py:111", launches=launches["K4"], **k4),
    ]
    log(f"done in {time.perf_counter() - _T0:.1f}s; main path {wps:.1f} windows/s")
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
