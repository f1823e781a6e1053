"""Smoke run of the PyTorch/CUDA port (evfly_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``evfly_tpu_torch/csrc`` (one ``nvcc``
call, cached in ``build/``), holds each of K1-K5 against its plain PyTorch
version on the card (K1 on both of its kernels: one thread-block cluster
per window with the frame in the cluster's shared memory, and the band
kernel of before, for the frames no cluster holds; K2 and K3 on their
cluster kernel, with int16 and int32 counts; K4 and K5 on both of their
routes: one 8-CTA cluster per stream with the weights in shared memory, and
one block per stream reading them from L2), times each pair in turns, old
and new, beside an empty launch, sweeps the cluster sizes, checks the
port's repaired faults (precision under PyTorch's default flags, an
eval-mode forward under autograd, more events per window than K2's and
K3's caps through their entry points and ``scale_counts``' cluster kernels,
more than 65,535 windows through K1), then drives the
port's paths through the entry points a user calls, each compared with its
plain path on the card and each with the kernels' launch counts set to 0
just before it and read just after:

- serving: 256 windows x 5,000 raw events -> ``event_histogram_scaled_resized``
  (K3 on clusters) -> ``LSTMNetVIT`` with ``artifacts/pretrain_v_final.pth`` (its LSTM
  through K4 on the cluster route) -> velocity (256, 3), its rate timed
  against the L2 route in turns;
- the fused rung of ``bench.py``: the same windows -> ``event_histogram_scaled``
  (K2 on clusters) -> bilinear resize -> ``LSTMNetVIT`` (K4);
- streaming: ``StreamingPipeline.step_events`` with the joint model
  ``OrigUNet_w_VITFLY_ViTLSTM`` and ``artifacts/policy_best.pth`` over 8
  windows of 5,000 events, state carried: ``event_histogram`` (K1 on
  clusters) ->
  97th-percentile scale -> OrigUNet with its ConvLSTM -> LSTMNetVIT through
  K4 (mode "stacked") or K5 (mode "wavefront"), on each route, and once
  with K1's band kernel;
- batched streaming: ``BatchedStreamingPipeline`` with 16 streams over 4
  steps, some streams reset before the third, against 16 single streams;
- the graph step: each streaming step replays one CUDA graph on the card
  (the default), held against the same step run eagerly (``graph=False``)
  with the state carried: ``step_events`` in both LSTM modes and both
  percentile modes with windows in two event buckets (two graphs sharing
  the state), ``step_frame``, and ``step_frames`` of 16 streams with a
  reset mask; a profile of replays names K1 and K4/K5 among the replayed
  kernels (a wrapper's launch count grows at the warm-up and the capture of
  a graph, not at its replays);
- the deployment loop: ``stream.hil.run_hil_episode`` flies 30 ticks on the
  port's native event accumulator and flight-stack core (built with g++ at
  their first use) with the joint model's graph step, each tick's velocity
  against an eager run on the plain path;
- training: ``Learner(cfg).train_loop()`` for 2 epochs with the joint
  configuration of ``tools/train_policy.py`` at 260x346, chunks of 16,
  from ``artifacts/policy_best.pth``, on a synthetic dataset that the
  port's dataloader preprocesses into its cache (``cache_dataset``: numpy
  only, no h5py); every loss finite, the JAX package's workspace files and
  checkpoint names, ``model_ep000001.pth`` reloaded bit for bit and
  streamed once; validation runs K4 once per chunk and the train steps no
  LSTM kernel, and validation through K4 matches the plain loop; every
  kernel's launches over the run are counted; one train step on the card
  against the same step on the CPU (loss, terms, every gradient, the
  gradient norm, Adam's update of every parameter element, u and v), and
  a step in TF32 must fail the same bounds.

It then times a streaming step and the G-stream rates, each as graphs and
eagerly in turns, in the manner of ``tools/torch_latency_bench.py``, and
profiles a graph step beside an eager one for their idle shares, and
times the train step (chunks/s, frames/s, idle share, peak memory),
validation (frames/s) and an epoch.  Every
phase prints a flushed line when it starts and when it ends.  The last lines of standard output are the card's name and
power limit, the kernels' JSON line and the result line
``{"ok": true, "device": {...}}``.

Exits non-zero, and prints no result, when there is no CUDA device, when a
kernel fails to build, launch or agree, or when the run exceeds its budget.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from evfly_tpu_torch.configs import EvflyConfig
from evfly_tpu_torch.data.dataloading import cache_dataset
from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.port import load_state_dict
from evfly_tpu_torch.models.recurrent import set_fused_lstm
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.precision import get_precision, set_precision
from evfly_tpu_torch.ops import _build, lstm_fused, voxelizer
from evfly_tpu_torch.ops.imageops import interpolate_bilinear
from evfly_tpu_torch.ops.lstm_fused import (
    choose_route,
    cluster_fits,
    cluster_occupancy,
    lstm_stacked,
    lstm_stacked_cluster,
    lstm_stacked_cluster_plain,
    lstm_stacked_plain,
    lstm_wavefront,
    lstm_wavefront_cluster,
    lstm_wavefront_cluster_plain,
    lstm_wavefront_plain,
    pack,
)
from evfly_tpu_torch.ops.voxelizer import (
    K1_CLUSTER,
    K2_CLUSTER,
    K3_CLUSTER,
    SCALE_CLUSTER,
    _frame_cluster_launch,
    _resized_cluster_launch,
    _scale_launch,
    _scaled_cluster_launch,
    bin_events,
    event_histogram_scaled,
    event_histogram_scaled_resized,
    frame_cluster_fits,
    hist_frame,
    hist_frame_cluster,
    hist_frame_plain,
    hist_frame_routed,
    hist_scaled,
    hist_scaled_plain,
    hist_scaled_resized,
    hist_scaled_resized_plain,
    hist_scaled_resized_routed,
    hist_scaled_routed,
    resized_cluster_cap,
    resized_cluster_smem,
    resized_packed,
    scale_counts,
    scale_slice_cached,
    scaled_cluster_cap,
    scaled_cluster_smem,
    scale_counts_plain,
    scale_counts_resized,
    scale_counts_resized_plain,
    scaled_route,
)
from evfly_tpu_torch.ops.voxelizer import cluster_occupancy as vox_cluster_occupancy
from evfly_tpu_torch.stream import BatchedStreamingPipeline, StreamingPipeline, hil
from evfly_tpu_torch.stream.pipeline import event_bucket
from evfly_tpu_torch.train import Learner, stepfn
from evfly_tpu_torch.train.learner import dataloader_kwargs

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
CAP_EVENTS, HOT = 1_500_000, 33_000    # past K2's and K3's caps per window; on one pixel
# windows K2 and K3 take and their one-block kernels of before did not:
# uniform; a count past int16 on one pixel; half the events on a 20x20 patch
# (400 counts past the dense table of 64)
WIDE_EVENTS, K3_HOT_EVENTS, PATCH_EVENTS = 20_000, 40_000, 100_000
# the most events K2's and K3's cluster kernels pack as int16 counts, 32,000
# of them on one pixel (+ in one window, - in the other)
PACKED_EVENTS, PACKED_HOT = 32_767, 32_000
# cluster sizes timed
K1_SWEEP, K2_SWEEP, K3_SWEEP, SCALE_SWEEP = (4, 8, 16), (2, 4, 8), (2, 4, 8), (4, 8, 16)
MANY_WINDOWS, FEW_EVENTS, SMALL_H, SMALL_W = 70_000, 16, 64, 86  # past grid.y's 65,535
# (G, T) of the K4 and K5 checks; (G, T) of their timings, in turns
LSTM_CHECKS = ((1, N_WINDOWS), (1, 2), (1, 1), (16, N_WINDOWS), (16, 2), (16, 1))
LSTM_TIMED = ((1, N_WINDOWS), (1, 1), (16, 1), (64, 1))
TURNS = ("l2", "cluster", "cluster", "l2")  # old, new, new, old
GRAPH_TURNS = (False, True, True, False)     # eager, graph, graph, eager
STREAM_WINDOWS, STREAMS = 8, 16         # streaming steps; batched streams
HIL_SECONDS = 2.0                       # 30 ticks of the deployment loop at 15 Hz
# the window of the graph-step phase cut to another event bucket (2,048)
SECOND_BUCKET_AT, SECOND_BUCKET_EVENTS = 5, 1500
# tools/latency_bench.py's counts: chained and synchronized streaming
# steps, and batched steps at each number of streams
CHAINED_STEPS, SYNC_STEPS, RATE_STEPS, RATE_STREAMS = 100, 20, 30, (16, 64)

# the training phase: the joint configuration of tools/train_policy.py
# (_cfg :61-98 and _joint_cfg :179-198) at full width, from policy_best.pth,
# on a synthetic dataset of TRAIN_TRAJS trajectories of TRAIN_FRAMES frames
TRAIN_CONFIG = dict(
    model_type=["OrigUNet", "VITFLY_ViTLSTM"], velpred=0, num_in_channels=2,
    num_out_channels=1, bev=2, num_recurrent=[1, 0], skip_type="interp", resize_input=[H, W],
    use_h5=True, events="evs_frames", keep_collisions=False, val_split=0.15, seed=7,
    batch_size=16, rescale_depth=1.0, rescale_evs=-1.0, evs_min_cutoff=0.0,
    data_augmentation=1.0, device_data_quantized=True, traj_scan=True, epoch_scan=True,
    scan_group=16, lr=1e-4, lr_warmup_epochs=1, loss_weights=[10.0, 1.0],
    optional_loss_param=[5.0, -1.0], N_eps=2, save_model_freq=1, val_freq=1,
    print_trainprogress_freq=1, checkpoint_path=[JOINT_CHECKPOINT], load_trainval=False,
    enc_num_layers=2, enc_kernel_sizes=[5, 3], enc_kernel_strides=[2, 2],
    enc_out_channels=[8, 32], enc_activations=["relu", "relu"], enc_pool_type="max",
    enc_invert_pool_inputs=True, enc_pool_kernels=[2, 2], enc_pool_strides=[2, 2],
    fc_num_layers=4, fc_layer_sizes=[1024, 128, 16, 1],
    fc_activations=["leaky_relu", "leaky_relu", "leaky_relu", "tanh"], fc_dropout_p=0.1,
)
TRAIN_TRAJS, TRAIN_FRAMES, TRAIN_TIMED = 6, 49, 8
# the card's train step against the port's on the CPU (same params and
# chunk, no augmentation or dropout): loss, terms and gradient norm within
# TRAIN_RTOL relative; each gradient within TRAIN_GRAD_TOL x the largest
# |gradient| of its leaf on the CPU (the f32 sums of a 16-frame 260x346
# UNet and its backward in cuDNN's order against the CPU's); Adam's update
# of each parameter element, p_after - p_before, within TRAIN_STEP_ATOL
# (0.01 lr) plus one f32 ulp of p.  The first step moves an element by
# lr g / (|g| + eps), which a change of d in g moves by at most
# lr d / (4 |g|): where |g| is at most TRAIN_SMALL_G times its leaf's
# largest gradient disagreement and either gradient is nonzero (rounding
# may set the step's sign), the update is held to 2 lr, elsewhere it moves
# by at most lr / (4 TRAIN_SMALL_G) from the gradients' disagreement; u, v
# within TRAIN_UV_TOL; a step in TF32 must fail these bounds (the readings
# these were set from are in PERF.md); validation with K4 against the plain
# loop within VEL_ATOL x max(1, |x|)
TRAIN_RTOL, TRAIN_GRAD_TOL, TRAIN_STEP_ATOL, TRAIN_SMALL_G, TRAIN_UV_TOL = (
    1e-4, 1e-4, 1e-6, 100.0, 1e-5)

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


def in_turns(fns: dict, order, flush: L2Flush, reps: int = 20) -> dict:
    """time_ms of each of ``fns`` (name -> call) in the turns of ``order``,
    e.g. old, new, new, old: name -> its times, one per turn."""
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(time_ms(fns[name], flush, reps))
    return times


def bound_ms(n_bytes: float, n_flops: float):
    """Least time for the work: bytes over HBM rate vs f32 ops over peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, ref) -> float:
    return max((a - r).abs().max().item() for a, r in zip(got, ref))


def make_events(seed: int, B: int, N: int, device, h: int = H, w: int = W):
    rng = np.random.default_rng(seed)
    ex = torch.tensor(rng.uniform(0, w, (B, N)), dtype=torch.float32, device=device)
    ey = torch.tensor(rng.uniform(0, h, (B, N)), dtype=torch.float32, device=device)
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


def _kernel_label(mangled: str) -> str:
    """A readable name for a mangled kernel name of ptxas's log."""
    name = next((n for n in ("lstm_cluster_kernel", "lstm_stacked_kernel",
                             "lstm_wavefront_kernel", "hist_scaled_cluster_kernel",
                             "hist_frame_cluster_kernel", "hist_frame_kernel",
                             "scale_counts_cluster_kernel", "empty_kernel")
                 if n in mangled), mangled)
    m = re.search(r"ILi(\d+)ELb([01])E", mangled)
    if m:
        name += f"<H={m.group(1)}, {'wavefront' if m.group(2) == '1' else 'stacked'}>"
    elif (m := re.search(r"scale_counts_cluster_kernelILb([01])E", mangled)):
        name += "<resize>" if m.group(1) == "1" else "<frame>"
    elif (m := re.search(r"hist_scaled_cluster_kernelILb([01])ELb([01])E", mangled)):
        name += (f"<{'packed' if m.group(1) == '1' else 'int32'}, "
                 f"{'K3' if m.group(2) == '1' else 'K2'}>")
    return name


def phase_build():
    info = _build.build()
    _build.library()
    log(f"build: {info.seconds:.1f}s, cache hit: {info.cache_hit}, {info.path.name}")
    kernel = "?"
    for line in info.log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = _kernel_label(m.group(1))
        elif "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  nvcc (-Xptxas -v) {kernel}: {line.strip()}")


def _route_rules():
    """The CPU copies of K1's, K2's and K3's cluster rules (ops/voxelizer.py)
    against the library's (csrc/voxelizer.cu), on a grid of shapes."""
    lib = _build.library()
    shapes = [(h, w) for h in (1, 7, 64, 260, 480, 720) for w in (1, 86, 346, 640, 1280)]
    differ = []
    for (h, w) in shapes:
        for cluster in (1, 2, 4, 8, 16):
            for two_pass in (False, True):
                if frame_cluster_fits(h, w, two_pass, cluster) != bool(
                        lib.evfly_hist_frame_cluster_fits(h, w, int(two_pass), cluster)):
                    differ.append(("K1", h, w, two_pass, cluster))
            for ho, wo in ((60, 90), (1, 1), (h, w)):
                if resized_cluster_cap(h, w, ho, wo, cluster) != \
                        lib.evfly_hist_resized_cluster_cap(h, w, ho, wo, cluster):
                    differ.append(("K3", h, w, ho, wo, cluster))
            if scaled_cluster_cap(h, w, cluster) != \
                    lib.evfly_hist_scaled_cluster_cap(h, w, cluster):
                differ.append(("K2", h, w, cluster))
    n_cases = len(shapes) * 5 * 6
    log(f"cluster route rules: Python and csrc/voxelizer.cu agree on "
        f"{n_cases - len(differ)} of {n_cases} cases; K3's cap at {H}x{W} -> {H_OUT}x{W_OUT}: "
        f"{resized_cluster_cap(H, W, H_OUT, W_OUT)} events per window on {K3_CLUSTER} CTAs; "
        f"K2's at {H}x{W}: {scaled_cluster_cap(H, W)} on {K2_CLUSTER} CTAs")
    require(not differ, f"the cluster rules disagree with csrc/voxelizer.cu at {differ[:5]}")


def scaled_cases(dev):
    """(label, events) of the windows K2 and K3 are checked on: the serving
    shape, the zero-quantile windows, and windows the one-block kernels of
    before refused: WIDE_EVENTS; PACKED_EVENTS, the most with int16 counts,
    one of them at +-32,000; K3_HOT_EVENTS with a count past int16 (int32
    counts); PATCH_EVENTS with hundreds of counts past the dense table."""
    ex, ey, ep = make_events(0, N_WINDOWS, N_EVENTS, dev)
    sx, sy, sp = make_events(1, 2, SPARSE_EVENTS, dev)
    wx, wy, wp = make_events(15, 2, WIDE_EVENTS, dev)
    hx, hy, hp = make_events(16, 2, K3_HOT_EVENTS, dev)
    hx[0, :HOT], hy[0, :HOT], hp[0, :HOT] = 100.5, 130.5, 1
    px, py, pp = make_events(18, 2, PATCH_EVENTS, dev)
    half = PATCH_EVENTS // 2
    px[:, :half] = 150.0 + px[:, :half] * (20.0 / W)
    py[:, :half] = 25.0 + py[:, :half] * (20.0 / H)  # across a band edge
    pp[:, :half] = 1
    kx, ky, kp = make_events(19, 2, PACKED_EVENTS, dev)
    kx[:, :PACKED_HOT], ky[:, :PACKED_HOT] = 200.5, 129.5  # the last row of band 0
    kp[0, :PACKED_HOT], kp[1, :PACKED_HOT] = 1, -1
    for resize in (None, (H_OUT, W_OUT)):
        require(all(scaled_route(n, H, W, resize) == "cluster"
                    for n in (N_EVENTS, WIDE_EVENTS, K3_HOT_EVENTS, PATCH_EVENTS,
                              PACKED_EVENTS)),
                f"the routes of the wide windows (resize {resize})")
    require(resized_packed(PACKED_EVENTS) and not resized_packed(K3_HOT_EVENTS),
            "the layouts of the wide windows")
    return [(f"{N_WINDOWS}x{N_EVENTS} events", (ex, ey, ep)),
            (f"sparse {SPARSE_EVENTS} events", (sx, sy, sp)),
            (f"2x{WIDE_EVENTS:,} events (past the one-block kernels' caps)", (wx, wy, wp)),
            (f"2x{PACKED_EVENTS:,} events, {PACKED_HOT:,} of +-1 on one pixel (int16 counts)",
             (kx, ky, kp)),
            (f"2x{K3_HOT_EVENTS:,} events, {HOT:,} on one pixel (int32 counts)", (hx, hy, hp)),
            (f"2x{PATCH_EVENTS:,} events, half on a 20x20 patch", (px, py, pp))]


def phase_k3(dev, flush):
    """K3 against its plain version (within K3_ATOL, q exactly equal) on
    ``scaled_cases``.  Timed at the serving shape and at one window; the
    cluster size swept."""
    _route_rules()
    cases = scaled_cases(dev)
    ex, ey, ep = cases[0][1]
    out_hw = (H_OUT, W_OUT)
    max_err = 0.0
    for label, events in cases:
        ref, qref = hist_scaled_resized_plain(*events, H, W, H_OUT, W_OUT)
        out, q = hist_scaled_resized(*events, H, W, H_OUT, W_OUT)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        q_bad = int((q != qref).sum().item())
        max_err = max(max_err, err)
        log(f"K3 {label}: max|diff| {err:.3e} (atol {K3_ATOL}), q mismatches "
            f"{q_bad}, q range [{q.min().item()}, {q.max().item()}]")
        require(out.shape == ref.shape, f"K3 output shape {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), "K3 output not finite")
        require(err <= K3_ATOL and q_bad == 0, f"K3 disagrees with its plain version ({label})")
        if label.startswith("sparse"):
            require(bool((q == 0).all()) and bool((qref == 0).all()), "zero-quantile snap missed")

    # the serving shape, and one window (the latency of a single request),
    # each in two turns
    ox, oy, op = (t[:1] for t in (ex, ey, ep))
    turns = [time_ms(lambda: hist_scaled_resized(ex, ey, ep, H, W, H_OUT, W_OUT), flush, 20)
             for _ in range(2)]
    one = [time_ms(lambda: hist_scaled_resized(ox, oy, op, H, W, H_OUT, W_OUT), flush, 20)
           for _ in range(2)]
    plain_ms = time_ms(lambda: hist_scaled_resized_plain(ex, ey, ep, H, W, H_OUT, W_OUT),
                       flush, 5)
    out, q = hist_scaled_resized(ex, ey, ep, H, W, H_OUT, W_OUT)
    n_bytes = sum(t.numel() * t.element_size() for t in (ex, ey, ep, out, q))
    valid_events = N_WINDOWS * N_EVENTS
    # one add per event, |count| and its table entry per cell, and per output
    # 4 scalings + 6 resize flops
    n_flops = valid_events + 2 * N_WINDOWS * H * W + N_WINDOWS * H_OUT * W_OUT * 10
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    log(f"K3 times {N_WINDOWS}x{N_EVENTS}: {turns[0]:.4f} / {turns[1]:.4f} ms; plain "
        f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); 1x{N_EVENTS}: {one[0]:.4f} / "
        f"{one[1]:.4f} ms")

    # the cluster size: each size against the plain version, its time, its
    # shared memory per CTA and its clusters resident at once
    ref, qref = hist_scaled_resized_plain(ex, ey, ep, H, W, H_OUT, W_OUT)
    for cluster in K3_SWEEP:
        got, gq = _resized_cluster_launch(ex, ey, ep, H, W, H_OUT, W_OUT, 0.2, 0.97, 18, False,
                                          cluster)
        torch.cuda.synchronize()
        require(torch.equal(gq, qref) and (got - ref).abs().max().item() <= K3_ATOL,
                f"K3 on {cluster} CTAs disagrees with its plain version")
        ms = time_ms(lambda: _resized_cluster_launch(ex, ey, ep, H, W, H_OUT, W_OUT, 0.2, 0.97,
                                                     18, False, cluster), flush, 20)
        smem = resized_cluster_smem(N_EVENTS, H, W, H_OUT, W_OUT, cluster)
        resident = vox_cluster_occupancy("k3", H, W, N_EVENTS, out_hw, cluster)
        log(f"K3 cluster of {cluster} CTAs{' (K3_CLUSTER)' if cluster == K3_CLUSTER else ''}:"
            f" {ms:.4f} ms at {N_WINDOWS}x{N_EVENTS}; {smem} bytes of dynamic shared memory "
            f"per CTA; {resident} clusters resident at once; cap "
            f"{resized_cluster_cap(H, W, H_OUT, W_OUT, cluster)} events per window")
    return dict(bound_ms=b_ms, bound_by=b_by, library_ms=None, plain_ms=plain_ms,
                max_abs_err=max_err, ms=statistics.mean(turns))


def phase_k1(dev, flush):
    """K1's cluster kernel and its band kernel exactly equal to their plain
    version in every case; old and new timed in turns at the streaming
    path's shape (1 x 5,000) and the batch shape (256 x 5,000), beside the
    empty-launch floor; the cluster size swept."""
    cases = []
    ex, ey, ep = make_events(10, 1, N_EVENTS, dev)
    cases.append(("5,000 uniform events", (ex, ey, ep), (0.2, 0.2)))
    cases.append(("pos 0.2 / neg 0.3", (ex, ey, ep), (0.2, 0.3)))
    bx, by, bp = make_events(11, 1, BIG_EVENTS, dev)
    bx[:, :HOT_EVENTS], by[:, :HOT_EVENTS], bp[:, :HOT_EVENTS] = 100.5, 130.5, 1
    cases.append((f"{BIG_EVENTS:,} events, {HOT_EVENTS:,} on one pixel", (bx, by, bp),
                  (0.2, 0.2)))
    cases.append((f"{BIG_EVENTS:,} events, two-pass", (bx, by, bp), (0.2, 0.3)))
    mx, my, mp = make_events(14, N_WINDOWS, N_EVENTS, dev)
    cases.append((f"{N_WINDOWS} windows x {N_EVENTS:,} events", (mx, my, mp), (0.2, 0.2)))
    # a window of 4,999 events: the slices of the windows after the first
    # start off 16-byte alignment
    ox, oy, op = make_events(17, 3, N_EVENTS - 1, dev)
    cases.append((f"3 windows x {N_EVENTS - 1:,} events, two-pass", (ox, oy, op), (0.2, 0.3)))
    errs = {"cluster": 0.0, "band": 0.0}
    for label, events, thresholds in cases:
        ref = hist_frame_plain(*events, H, W, *thresholds)
        bad = {}
        for route, kernel in (("cluster", hist_frame_cluster), ("band", hist_frame)):
            got = kernel(*events, H, W, *thresholds)
            torch.cuda.synchronize()
            bad[route] = int((got != ref).sum().item())
            errs[route] = max(errs[route], (got - ref).abs().max().item())
            require(got.shape == ref.shape and bool(torch.isfinite(got).all()), "K1 output")
        log(f"K1 {label}: cells that differ from plain, of {ref.numel()}: {bad}; max|frame| "
            f"{ref.abs().max().item():.1f}")
        require(not any(bad.values()), f"K1 disagrees with its plain version ({label})")

    lib, stream = _build.library(), _build.stream_of(dev)
    empty = {c: time_ms(lambda: _build.check("evfly_empty", lib.evfly_empty(c, stream)), flush,
                        20) for c in (1, K1_CLUSTER)}
    log(f"empty kernel, the floor of one launch: {empty[1]:.4f} ms (1 block), "
        f"{empty[K1_CLUSTER]:.4f} ms (a cluster of {K1_CLUSTER} CTAs)")
    results = {}
    kernels = {"band": hist_frame, "cluster": hist_frame_cluster}
    for B, (x_, y_, p_) in ((1, (ex, ey, ep)), (N_WINDOWS, (mx, my, mp))):
        fns = {route: (lambda k=k: k(x_, y_, p_, H, W)) for route, k in kernels.items()}
        turns = in_turns(fns, ("band", "cluster", "cluster", "band"), flush)
        # each event read once (12 bytes), the frame written once; one add per
        # event and one multiply per cell
        b_ms, b_by = bound_ms(B * (12 * N_EVENTS + 4 * H * W), B * (N_EVENTS + H * W))
        sweep = {c: time_ms(lambda: _frame_cluster_launch(x_, y_, p_, H, W, 0.2, 0.2, c),
                            flush, 20) for c in K1_SWEEP}
        for c in K1_SWEEP:
            require(torch.equal(_frame_cluster_launch(x_, y_, p_, H, W, 0.2, 0.2, c),
                                hist_frame_plain(x_, y_, p_, H, W)),
                    f"K1 on {c} CTAs disagrees with its plain version")
        log(f"K1 times {B} x {N_EVENTS} events, in turns band, cluster, cluster, band: band "
            f"{turns['band'][0]:.4f} / {turns['band'][1]:.4f} ms, cluster "
            f"{turns['cluster'][0]:.4f} / {turns['cluster'][1]:.4f} ms; bound {b_ms:.6f} ms "
            f"({b_by}); cluster sizes: "
            + ", ".join(f"{c} CTAs {t:.4f} ms" for c, t in sweep.items()))
        results[B] = dict(turns=turns, bound_ms=b_ms, bound_by=b_by)
    for kind in ("k1", "k1_two_pass"):
        log(f"K1 cluster kernel ({kind}): {vox_cluster_occupancy(kind, H, W)} clusters of "
            f"{K1_CLUSTER} CTAs resident at once")

    xi, yi, sign = bin_events(ex, ey, ep, H, W)
    idx = (yi * W + xi)[0]
    plain_ms = time_ms(lambda: hist_frame_plain(ex, ey, ep, H, W), flush, 10)
    library_ms = time_ms(lambda: torch.bincount(idx, weights=sign[0], minlength=H * W),
                         flush, 10)
    log(f"K1 at 1 x {N_EVENTS}: plain {plain_ms:.4f} ms, torch.bincount {library_ms:.4f} ms")
    one = results[1]
    return {route: dict(max_abs_err=errs[route], ms=statistics.mean(one["turns"][route]),
                        plain_ms=plain_ms, bound_ms=one["bound_ms"], bound_by=one["bound_by"],
                        library_ms=library_ms)
            for route in kernels}


def phase_k2(dev, flush):
    """K2's cluster kernel against its plain version (within K2_ATOL, q
    exactly equal) on ``scaled_cases``; timed at the serving shape (the
    fused rung's) and at one window; the cluster size swept."""
    cases = scaled_cases(dev)
    ex, ey, ep = cases[0][1]
    max_err = 0.0
    for label, events in cases:
        ref, qref = hist_scaled_plain(*events, H, W)
        out, q = hist_scaled(*events, H, W)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        q_bad = int((q != qref).sum().item())
        max_err = max(max_err, err)
        log(f"K2 {label}: max|diff| {err:.3e} (atol {K2_ATOL}), q mismatches {q_bad}, "
            f"q range [{q.min().item()}, {q.max().item()}]")
        require(out.shape == ref.shape and bool(torch.isfinite(out).all()), "K2 output")
        require(err <= K2_ATOL and q_bad == 0, f"K2 disagrees with its plain version ({label})")
        if label.startswith("sparse"):
            require(bool((q == 0).all()) and bool((qref == 0).all()), "zero-quantile snap missed")

    ox, oy, op = (t[:1] for t in (ex, ey, ep))
    turns = [time_ms(lambda: hist_scaled(ex, ey, ep, H, W), flush, 20) for _ in range(2)]
    one = [time_ms(lambda: hist_scaled(ox, oy, op, H, W), flush, 20) for _ in range(2)]
    plain_ms = time_ms(lambda: hist_scaled_plain(ex, ey, ep, H, W), flush, 5)
    out, q = hist_scaled(ex, ey, ep, H, W)
    n_bytes = sum(t.numel() * t.element_size() for t in (ex, ey, ep, out, q))
    # one add per event, |count| and its table entry per cell, scale and
    # clip per cell
    n_flops = N_WINDOWS * N_EVENTS + 4 * N_WINDOWS * H * W
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    log(f"K2 times {N_WINDOWS}x{N_EVENTS}: {turns[0]:.4f} / {turns[1]:.4f} ms; plain "
        f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); 1x{N_EVENTS}: {one[0]:.4f} / "
        f"{one[1]:.4f} ms")

    ref, qref = hist_scaled_plain(ex, ey, ep, H, W)
    for cluster in K2_SWEEP:
        got, gq = _scaled_cluster_launch(ex, ey, ep, H, W, 0.2, 0.97, 18, cluster)
        torch.cuda.synchronize()
        require(torch.equal(gq, qref) and (got - ref).abs().max().item() <= K2_ATOL,
                f"K2 on {cluster} CTAs disagrees with its plain version")
        ms = time_ms(lambda: _scaled_cluster_launch(ex, ey, ep, H, W, 0.2, 0.97, 18, cluster),
                     flush, 20)
        smem = scaled_cluster_smem(N_EVENTS, H, W, cluster)
        resident = vox_cluster_occupancy("k2", H, W, N_EVENTS, cluster=cluster)
        log(f"K2 cluster of {cluster} CTAs{' (K2_CLUSTER)' if cluster == K2_CLUSTER else ''}:"
            f" {ms:.4f} ms at {N_WINDOWS}x{N_EVENTS}; {smem} bytes of dynamic shared memory "
            f"per CTA; {resident} clusters resident at once; cap "
            f"{scaled_cluster_cap(H, W, cluster)} events per window")
    return dict(max_abs_err=max_err, ms=statistics.mean(turns), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# (mode, route) -> (label, kernel wrapper, its plain version)
LSTM_ROUTES = {
    ("stacked", "cluster"): ("K4 cluster", lstm_stacked_cluster, lstm_stacked_cluster_plain),
    ("stacked", "l2"): ("K4 L2", lstm_stacked, lstm_stacked_plain),
    ("wavefront", "cluster"): ("K5 cluster", lstm_wavefront_cluster,
                               lstm_wavefront_cluster_plain),
    ("wavefront", "l2"): ("K5 L2", lstm_wavefront, lstm_wavefront_plain),
}


def _route_weights(packed, route):
    """A route's weight arguments from ``lstm_fused.pack``'s result."""
    if route == "cluster":
        return packed.cluster, packed.bias
    return packed.whh_t, packed.wih_t, packed.bias


@contextlib.contextmanager
def forced_voxel_routes():
    """K1 takes its band kernel where the shape would pick its cluster
    kernel, for driving a path through it in this script; the port itself
    always routes by shape."""
    k1 = voxelizer.k1_route
    voxelizer.k1_route = lambda h, w, two_pass: "band"
    try:
        yield
    finally:
        voxelizer.k1_route = k1


@contextlib.contextmanager
def forced_route(route):
    """Every fused LSTM call takes ``route`` instead of ``choose_route``'s
    choice by shape, for comparing the routes end to end in this script;
    the port itself always routes by shape."""
    by_shape = lstm_fused.choose_route
    lstm_fused.choose_route = lambda hidden, layers: route
    try:
        yield
    finally:
        lstm_fused.choose_route = by_shape


def _lstm_problem(dev, seed, G, T, hidden=HID, layers=L):
    """cuDNN's LSTM (the yardstick only) and, from its weights, the kernels'
    packed layouts, layer-0 gates (G, T, 4H) and a carried state (G, L, H)."""
    gen = torch.Generator().manual_seed(seed)
    b = 1.0 / hidden ** 0.5
    lstm = torch.nn.LSTM(IN, hidden, layers)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.empty_like(p).uniform_(-b, b, generator=gen))
    lstm = lstm.to(dev)
    params = {k: v.detach() for k, v in lstm.named_parameters()}
    x = torch.randn(G, T, IN, generator=gen).to(dev)
    h0 = (torch.randn(G, layers, hidden, generator=gen) * 0.5).to(dev)
    c0 = (torch.randn(G, layers, hidden, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        xp0 = x @ params["weight_ih_l0"].T + params["bias_ih_l0"] + params["bias_hh_l0"]
    return lstm, x, xp0, pack(params, layers, hidden), h0, c0


def _check_lstm(name, kernel, plain, xp0, weights, h0, c0):
    """The kernel against its plain version with a zero and a carried state."""
    zeros = torch.zeros_like(h0)
    errs = []
    for (hh, cc), atol in (((zeros, zeros), K4_ATOL), ((h0, c0), K4_ATOL_CARRIED)):
        got = kernel(xp0, *weights, hh, cc)
        ref = plain(xp0, *weights, hh, cc)
        torch.cuda.synchronize()
        errs.append(max_err(got, ref))
        require(all(bool(torch.isfinite(a).all()) for a in got), f"{name} output not finite")
        require(errs[-1] <= atol, f"{name} disagrees with its plain version")
    G, T = xp0.shape[:2]
    log(f"{name} G={G} T={T} L={h0.shape[1]} H={h0.shape[2]}: max|diff| zero state "
        f"{errs[0]:.3e} (atol {K4_ATOL}), carried {errs[1]:.3e} (atol {K4_ATOL_CARRIED})")
    return max(errs)


def phase_lstm_routes(dev):
    """K4 and K5 on both routes against their plain versions, at the
    serving length, the wavefront's short corners and 16 streams; the route
    each other shape takes; how many clusters fit the card."""
    errs = dict.fromkeys(LSTM_ROUTES, 0.0)
    with torch.no_grad():
        for G, T_ in LSTM_CHECKS:
            lstm, x, xp0, packed, h0, c0 = _lstm_problem(dev, 20 + G + T_, G, T_)
            for key, (name, kernel, plain) in LSTM_ROUTES.items():
                err = _check_lstm(name, kernel, plain, xp0, _route_weights(packed, key[1]),
                                  h0, c0)
                errs[key] = max(errs[key], err)
            if (G, T_) == (1, N_WINDOWS):
                lib_out, _ = lstm(x[0], (h0[0], c0[0]))
                k4_out = lstm_stacked_cluster(xp0[0], packed.cluster, packed.bias, h0[0],
                                              c0[0])[0]
                log(f"K4 cluster vs torch.nn.LSTM (yardstick only): max|diff| "
                    f"{(lib_out - k4_out).abs().max().item():.3e}")
        # the routes of the other shapes: H = 256 fits the cluster with one
        # layer; with three it takes the L2 route
        for hidden, layers, route in ((256, 1, "cluster"), (256, 3, "l2")):
            require(choose_route(hidden, layers) == route, f"route of H={hidden} L={layers}")
            _, _, xp0, packed, h0, c0 = _lstm_problem(dev, 30 + layers, 3, 5, hidden, layers)
            for mode in ("stacked", "wavefront"):
                name, kernel, plain = LSTM_ROUTES[(mode, route)]
                err = _check_lstm(name, kernel, plain, xp0, _route_weights(packed, route),
                                  h0, c0)
                errs[(mode, route)] = max(errs[(mode, route)], err)
    # the route rule of lstm_fused against the library's own (csrc/lstm.cu)
    shapes = [(h, l) for h in (64, 128, 192, 256, 384, 512) for l in (1, 2, 3, 4)]
    differ = [s for s in shapes
              if cluster_fits(*s) != bool(_build.library().evfly_lstm_cluster_fits(*s))]
    log(f"cluster route rule: Python and csrc/lstm.cu agree on {len(shapes) - len(differ)} "
        f"of {len(shapes)} (H, L) shapes; cluster route: "
        f"{[s for s in shapes if cluster_fits(*s)]}")
    require(not differ, f"cluster_fits disagrees with csrc/lstm.cu at {differ}")
    for hidden, layers in ((HID, L), (256, 1)):
        for mode in ("stacked", "wavefront"):
            clusters = cluster_occupancy(hidden, layers, mode)
            log(f"cudaOccupancyMaxActiveClusters, {mode} H={hidden} L={layers}: "
                f"{clusters} clusters of 8 CTAs")
            require(clusters > 0, f"no cluster of the {mode} kernel fits the card")
    return errs


def phase_lstm_times(dev, flush):
    """Both routes of K4 and K5 timed in turns (L2, cluster, cluster, L2)
    at each shape of LSTM_TIMED, beside cuDNN's LSTM and the bound; the
    plain versions at the shapes of the kernels' JSON entries."""
    times = {}
    with torch.no_grad():
        for G, T_ in LSTM_TIMED:
            lstm, x, xp0, packed, h0, c0 = _lstm_problem(dev, 40 + G + T_, G, T_)
            # cuDNN's LSTM takes (T, G, in) with (L, G, H) states
            xs, hs, cs = (t.transpose(0, 1).contiguous() for t in (x, h0, c0))
            library_ms = time_ms(lambda: lstm(xs, (hs, cs)), flush, 10)
            n_bytes = sum(t.numel() * 4 for t in (xp0, packed.whh_t, packed.wih_t, packed.bias,
                                                   h0, c0)) + (G * T_ * HID + 2 * G * L * HID) * 4
            n_flops = 2 * G * T_ * HID * 4 * HID * (2 * L - 1)
            b_ms, b_by = bound_ms(n_bytes, n_flops)
            for mode in ("stacked", "wavefront"):
                turns = {"l2": [], "cluster": []}
                for route in TURNS:
                    _, kernel, _ = LSTM_ROUTES[(mode, route)]
                    w = _route_weights(packed, route)
                    turns[route].append(time_ms(lambda: kernel(xp0, *w, h0, c0), flush, 10))
                entry = dict(library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                             **{r: statistics.mean(v) for r, v in turns.items()})
                if (mode, G, T_) in (("stacked", 1, N_WINDOWS), ("wavefront", 1, 1)):
                    for route in ("l2", "cluster"):
                        _, _, plain = LSTM_ROUTES[(mode, route)]
                        w = _route_weights(packed, route)
                        entry[f"plain_{route}"] = time_ms(lambda: plain(xp0, *w, h0, c0), flush,
                                                          3 if T_ > 1 else 10, warmup=1)
                times[(mode, G, T_)] = entry
                log(f"{'K4' if mode == 'stacked' else 'K5'} times G={G} T={T_}, in turns L2, "
                    f"cluster, cluster, L2: L2 {turns['l2'][0]:.4f} / {turns['l2'][1]:.4f} ms, "
                    f"cluster {turns['cluster'][0]:.4f} / {turns['cluster'][1]:.4f} ms; "
                    f"torch.nn.LSTM {library_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by})"
                    + "".join(f"; plain ({r}) {entry[f'plain_{r}']:.4f} ms"
                              for r in ("l2", "cluster") if f"plain_{r}" in entry))
    return times


def serving_rate(step) -> list:
    """Windows/s of 5 reps x 10 serving steps, after 3 warm-up steps."""
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
    return reps


def phase_main_path(dev, smi):
    """The serving path through K3 and K4 on the cluster route, against its
    plain path; its rate against the L2 route's, in turns."""
    model = LSTMNetVIT(device=dev).eval().load_params(load_state_dict(CHECKPOINT))
    ex, ey, ep = make_events(2, N_WINDOWS, N_EVENTS, dev)
    desvel = torch.full((N_WINDOWS, 1), 4.0, device=dev)

    def step():
        small = event_histogram_scaled_resized(ex, ey, ep, H, W, H_OUT, W_OUT, device=dev)
        return model(small[:, None], desvel)

    with torch.inference_mode():
        set_fused_lstm(True)
        hist_scaled_resized.launches = 0
        lstm_stacked_cluster.launches = lstm_stacked.launches = 0
        vel, (h, c) = step()
        torch.cuda.synchronize()
        launches = {"K3": hist_scaled_resized.launches,
                    "K4 cluster": lstm_stacked_cluster.launches}
        log(f"main path launches: {launches}, K4 L2 {lstm_stacked.launches}")
        require(all(n > 0 for n in launches.values()), "a kernel of the path never launched")
        require(lstm_stacked.launches == 0, "the serving LSTM did not take the cluster route")

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

        # the same path with its LSTM forced onto the L2 route: its launches,
        # then the two routes' rates in turns
        with forced_route("l2"):
            lstm_stacked.launches = lstm_stacked_cluster.launches = 0
            step()
            torch.cuda.synchronize()
        l2_launches = {"K4 L2": lstm_stacked.launches}
        require(lstm_stacked.launches > 0 and lstm_stacked_cluster.launches == 0,
                "the L2 route did not run")
        rates = {"l2": [], "cluster": []}
        for route in TURNS:
            with forced_route(route):
                rates[route].append(serving_rate(step))
    for route in ("cluster", "l2"):
        runs = rates[route]
        log(f"main path, K4 {route} route: windows/s medians "
            + ", ".join(f"{statistics.median(r):.1f}" for r in runs)
            + f" (5 reps x 10 steps each, in turns L2, cluster, cluster, L2; min "
            f"{min(min(r) for r in runs):.1f}, max {max(max(r) for r in runs):.1f}) on {smi}, "
            f"f32, TF32 off")
    wps = statistics.median([v for r in rates["cluster"] for v in r])
    wps_l2 = statistics.median([v for r in rates["l2"] for v in r])
    return launches, l2_launches, wps, wps_l2, step


def phase_fused_rung(dev):
    """bench.py's fused rung: events -> event_histogram_scaled (K2) ->
    bilinear 60x90 -> LSTMNetVIT (K4, cluster route), against its plain
    path."""
    model = LSTMNetVIT(device=dev).eval().load_params(load_state_dict(CHECKPOINT))
    ex, ey, ep = make_events(2, N_WINDOWS, N_EVENTS, dev)
    desvel = torch.full((N_WINDOWS, 1), 4.0, device=dev)
    with torch.inference_mode():
        set_fused_lstm(True)
        hist_scaled.launches = 0
        lstm_stacked_cluster.launches = 0
        frames = event_histogram_scaled(ex, ey, ep, H, W, device=dev)
        vel, (h, c) = model(interpolate_bilinear(frames[:, None], (H_OUT, W_OUT)), desvel)
        torch.cuda.synchronize()
        launches = {"K2": hist_scaled.launches, "K4 cluster": lstm_stacked_cluster.launches}
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
    carried, in each LSTM mode, route and percentile mode, against the plain
    path (plain K1, set_fused_lstm(False)) on the same model."""
    windows = stream_windows(dev, STREAM_WINDOWS)
    launches = {}
    lstm = model.vitfly_vitlstm.lstm
    kernels = (lstm_stacked, lstm_wavefront, lstm_stacked_cluster, lstm_wavefront_cluster)
    for (mode, route), (key, kernel, _) in LSTM_ROUTES.items():
        for fast in (False, True):
            lstm.mode = mode
            pipe = StreamingPipeline(model, fast_percentile=fast, device=dev)
            plain = StreamingPipeline(model, fast_percentile=fast, device=dev, graph=False)
            set_fused_lstm(True)
            hist_frame.launches = hist_frame_cluster.launches = 0
            for k in kernels:
                k.launches = 0
            with forced_route(route):
                outs = [pipe.step_events(*w) for w in windows]
                torch.cuda.synchronize()
            counts = {"K1 cluster": hist_frame_cluster.launches, key: kernel.launches}
            require(all(n > 0 for n in counts.values()),
                    f"a kernel of the streaming path ({mode}, {route}) never launched")
            require(hist_frame.launches == 0, "K1 did not take its cluster kernel")
            require(sum(k.launches for k in kernels) == kernel.launches,
                    f"the streaming path ({mode}, {route}) ran another LSTM kernel")
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
            log(f"streaming {mode} {route}, fast_percentile={fast}: launches {counts}; over "
                f"{STREAM_WINDOWS} windows max|diff| vs plain path: velocity {verr:.3e}, "
                f"depth {derr:.3e}, h {herr:.3e}, c/max(1,|c|) {cerr:.3e}; last velocity "
                f"{outs[-1][0].tolist()}")
            require(all(v.shape == (3,) and d.shape == (H, W) for v, d in outs), "shapes")
            require(all(bool(torch.isfinite(v).all()) and bool(torch.isfinite(d).all())
                        for v, d in outs), "streaming output not finite")
            require(max(verr, derr, herr, cerr) <= VEL_ATOL,
                    f"streaming path ({mode}, {route}, fast={fast}) disagrees with the plain path")
    # once more with K1's band kernel: its launches, the outputs as the
    # cluster kernel's (the frames are the same bit for bit)
    lstm.mode = "stacked"
    pipe = StreamingPipeline(model, fast_percentile=True, device=dev)
    banded = StreamingPipeline(model, fast_percentile=True, device=dev)
    hist_frame.launches = hist_frame_cluster.launches = 0
    outs = [pipe.step_events(*w) for w in windows]
    n_cluster = hist_frame_cluster.launches
    with forced_voxel_routes():
        outs_band = [banded.step_events(*w) for w in windows]
    torch.cuda.synchronize()
    launches["K1 band"] = hist_frame.launches
    berr = max((a - b).abs().max().item()
               for o, ob in zip(outs, outs_band) for a, b in zip(o, ob))
    log(f"streaming with K1's band kernel: {hist_frame.launches} launches (cluster kernel "
        f"{n_cluster} in the run beside it); velocity and depth max|diff| vs the cluster "
        f"kernel's {berr:.3e}")
    require(hist_frame.launches > 0 and n_cluster == hist_frame.launches,
            "K1's band kernel did not run")
    require(berr <= VEL_ATOL, "the streaming path through K1's band kernel disagrees")
    lstm.mode = None
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
    lstm_stacked_cluster.launches = lstm_wavefront_cluster.launches = 0
    pipe = BatchedStreamingPipeline(model, STREAMS, desvel=desvel, fast_percentile=True,
                                    device=dev)
    outs = [pipe.step_frames(frames[s], masks[s]) for s in range(steps)]
    torch.cuda.synchronize()
    counts = {"K4 cluster": lstm_stacked_cluster.launches,
              "K5 cluster": lstm_wavefront_cluster.launches}
    require(sum(counts.values()) > 0, "the batched path launched no cluster LSTM kernel")
    set_fused_lstm(False)
    verr = derr = herr = cerr = 0.0
    for g in range(STREAMS):
        single = StreamingPipeline(model, desvel=desvel[g], fast_percentile=True, device=dev,
                                   graph=False)
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


def _check_graph_run(label, graph_pipe, eager_pipe, step_g, step_e, steps, state_of):
    """Steps ``graph_pipe`` (replaying CUDA graphs) and ``eager_pipe`` (the
    same step run eagerly) through ``steps`` inputs; after each step the
    outputs and every stream's state (``state_of(pipe)``: a list of single
    streams' states) within VEL_ATOL, c relative to max(1, max|c|)."""
    require(graph_pipe.graph and not eager_pipe.graph, f"{label}: graph flags")
    verr = derr = herr = cerr = 0.0
    for inp in steps:
        vg, dg = step_g(inp)
        ve, de = step_e(inp)
        verr = max(verr, (vg - ve).abs().max().item())
        derr = max(derr, (dg - de).abs().max().item())
        require(bool(torch.isfinite(vg).all()) and bool(torch.isfinite(dg).all()),
                f"{label}: output not finite")
        for sg, se in zip(state_of(graph_pipe), state_of(eager_pipe)):
            he, ce = state_errs(sg, se)
            herr, cerr = max(herr, he), max(cerr, ce)
    graphs = len(graph_pipe._steps.slots)
    log(f"graph step {label}: {len(steps)} steps, {graphs} graph(s); max|diff| vs the eager "
        f"step: velocity {verr:.3e}, depth {derr:.3e}, h {herr:.3e}, c/max(1,|c|) {cerr:.3e}")
    require(all(s.graph is not None for s in graph_pipe._steps.slots.values()),
            f"{label}: a step ran without its graph")
    require(max(verr, derr, herr, cerr) <= VEL_ATOL, f"{label}: the graph step disagrees")
    return graphs


def phase_graph_step(dev, model):
    """The streaming steps replayed as CUDA graphs (the default on CUDA)
    against the same steps run eagerly (``graph=False``), state carried:
    ``step_events`` over STREAM_WINDOWS windows, one of them in a second
    event bucket so that two graphs share the state, in both LSTM modes and
    both percentile modes; ``step_frame``; ``step_frames`` with STREAMS
    streams and a reset mask.  Then the kernels of replays, by name."""
    windows = stream_windows(dev, STREAM_WINDOWS)
    windows[SECOND_BUCKET_AT] = tuple(t[:SECOND_BUCKET_EVENTS] for t in windows[SECOND_BUCKET_AT])
    require(event_bucket(SECOND_BUCKET_EVENTS) != event_bucket(N_EVENTS), "one bucket only")
    lstm = model.vitfly_vitlstm.lstm
    set_fused_lstm(True)
    for mode in ("stacked", "wavefront"):
        lstm.mode = mode
        for fast in (False, True):
            g = StreamingPipeline(model, fast_percentile=fast, device=dev)
            e = StreamingPipeline(model, fast_percentile=fast, device=dev, graph=False)
            graphs = _check_graph_run(
                f"step_events ({mode}, fast_percentile={fast})", g, e,
                lambda w: g.step_events(*w), lambda w: e.step_events(*w), windows,
                lambda p: [p.hidden])
            require(graphs == 2, "the second event bucket did not capture its own graph")
    lstm.mode = None
    frames = sparse_frames(8, (4, H, W), dev)
    g = StreamingPipeline(model, device=dev)
    e = StreamingPipeline(model, device=dev, graph=False)
    _check_graph_run("step_frame", g, e, g.step_frame, e.step_frame, list(frames),
                     lambda p: [p.hidden])
    steps = 4
    frames = sparse_frames(9, (steps, STREAMS, H, W), dev)
    masks = [torch.tensor([s == 2 and g_ % 4 == 1 for g_ in range(STREAMS)], device=dev)
             for s in range(steps)]
    desvel = [3.0 + 2.0 * g_ / (STREAMS - 1) for g_ in range(STREAMS)]
    bg = BatchedStreamingPipeline(model, STREAMS, desvel=desvel, fast_percentile=True, device=dev)
    be = BatchedStreamingPipeline(model, STREAMS, desvel=desvel, fast_percentile=True,
                                  device=dev, graph=False)
    _check_graph_run(f"step_frames G={STREAMS}, streams reset before step 3", bg, be,
                     lambda s: bg.step_frames(frames[s], masks[s]),
                     lambda s: be.step_frames(frames[s], masks[s]), list(range(steps)),
                     lambda p: [_one_stream(p.hidden, g_) for g_ in range(STREAMS)])

    # the kernels of replays: the graph step's trace names K1 and K4 (K5)
    names = {"K1": "hist_frame_cluster_kernel", "K4/K5": "lstm_cluster_kernel"}
    for mode in ("stacked", "wavefront"):
        lstm.mode = mode
        pipe = StreamingPipeline(model, fast_percentile=True, device=dev)
        pipe.step_events(*windows[0])
        prof = phase_profile(lambda: pipe.step_events(*windows[0]), names,
                             f"replayed graph ({mode})")
        require(prof is not None, "the profiler saw no device time in replays")
        require(all(prof["by_label"][k] > 0 for k in names),
                f"the replayed graph ({mode}) ran no {names}")
    lstm.mode = None


def _streaming_ms(pipe, windows):
    """(ms per step over CHAINED_STEPS chained steps, the SYNC_STEPS
    synchronized steps' ms) of a streaming pipeline."""
    for w in windows[:3]:
        pipe.step_events(*w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CHAINED_STEPS):
        pipe.step_events(*windows[i % len(windows)])
    torch.cuda.synchronize()
    chained = (time.perf_counter() - t0) / CHAINED_STEPS * 1e3
    samples = []
    for i in range(SYNC_STEPS):
        t0 = time.perf_counter()
        pipe.step_events(*windows[i % len(windows)])
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return chained, samples


def _free_device_memory():
    """Return the memory of freed pipelines and their graphs to the card,
    so that every timed pipeline captures with the same memory free (cuDNN
    picks a convolution's algorithm by the workspace it can allocate)."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_card_numbers(dev, model, windows, smi):
    """tools/torch_latency_bench.py's numbers on the card: ms per streaming
    step over 100 chained steps (one synchronize) and p50 of 20
    synchronized steps, each LSTM mode on both routes in turns, each route
    eagerly and as CUDA graphs; and steps/s of G streams stepped together,
    eager and graph in turns (eager, graph, graph, eager)."""
    numbers = {}
    lstm = model.vitfly_vitlstm.lstm
    with torch.inference_mode():
        for mode in ("stacked", "wavefront"):
            lstm.mode = mode
            for route in TURNS:
                for graph in (False, True):
                    _free_device_memory()
                    pipe = StreamingPipeline(model, fast_percentile=True, device=dev,
                                             graph=graph)
                    with forced_route(route):
                        chained, samples = _streaming_ms(pipe, windows)
                    p50 = statistics.median(samples)
                    numbers.setdefault((mode, route, graph), []).append((chained, p50))
                    log(f"streaming step ({mode}, {route} route, "
                        f"{'graph' if graph else 'eager'}, fast percentile): {chained:.3f} ms "
                        f"per step over {CHAINED_STEPS} chained steps; p50 {p50:.3f} ms of "
                        f"{SYNC_STEPS} synchronized (min {min(samples):.3f}, max "
                        f"{max(samples):.3f}) on {smi}")
        lstm.mode = None
        for G in RATE_STREAMS:
            frames = sparse_frames(5, (G, H, W), dev)
            for graph in GRAPH_TURNS:
                _free_device_memory()
                pipe = BatchedStreamingPipeline(model, G, fast_percentile=True, device=dev,
                                                graph=graph)
                for _ in range(2):
                    pipe.step_frames(frames)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(RATE_STEPS):
                    pipe.step_frames(frames)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                rate = G * RATE_STEPS / dt
                numbers.setdefault((G, graph), []).append(rate)
                log(f"batched G={G} ({'graph' if graph else 'eager'}): {rate:.1f} steps/s "
                    f"({dt / RATE_STEPS * 1e3:.3f} ms per batched step, {int(rate / 15.0)} "
                    f"streams at 15 Hz) on {smi}")
                del pipe
    return numbers


def hil_sensor(pos, t):
    """tests/test_hil.py's sensor: 500 random events at 640x480 that
    depend on t alone, so every tick's frame is the same whatever the
    vehicle does."""
    rng = np.random.default_rng(int(t * 1000) % 2**31)
    n = 500
    return (rng.integers(0, 640, n), rng.integers(0, 480, n), rng.choice([-1, 1], n))


class _Recording:
    """A pipeline that keeps the velocity of each of its steps."""

    def __init__(self, pipe):
        self.pipe, self.input_hw, self.vels = pipe, pipe.input_hw, []

    def step_frame(self, frame):
        vel, depth = self.pipe.step_frame(frame)
        self.vels.append(vel)
        return vel, depth


@contextlib.contextmanager
def timed_ticks(times: list, runners: list):
    """``run_hil_episode``'s DeploymentRunner with each ``tick()`` timed
    (host clock, ms) into ``times`` and each runner kept in ``runners``,
    for reading them in this script."""
    base = hil.DeploymentRunner

    class Timed(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runners.append(self)

        def tick(self):
            t0 = time.perf_counter()
            cmd = super().tick()
            times.append((time.perf_counter() - t0) * 1e3)
            return cmd

    hil.DeploymentRunner = Timed
    try:
        yield
    finally:
        hil.DeploymentRunner = base


def phase_hil(dev, model, smi):
    """The deployment loop: ``run_hil_episode`` flies HIL_SECONDS (30 ticks
    at 15 Hz) on the port's native accumulator and flight-stack core with
    the joint model's ``StreamingPipeline``, as CUDA graphs, eagerly, and
    eagerly on the plain path (``set_fused_lstm(False)``; deploy steps
    frames, so K1 is not on it).  Each tick's velocity of the graph run
    within VEL_ATOL of the plain run's; ms per tick() of each."""
    runs = {}
    for label, graph, fused in (("graph", True, True), ("eager", False, True),
                                ("eager plain", False, False)):
        set_fused_lstm(fused)
        lstm_stacked_cluster.launches = 0
        rec = _Recording(StreamingPipeline(model, device=dev, graph=graph))
        times, runners = [], []
        with timed_ticks(times, runners):
            res = hil.run_hil_episode(rec, hil_sensor, duration=HIL_SECONDS)
        torch.cuda.synchronize()
        runs[label] = (res, rec, times, runners[0].acc.is_native, lstm_stacked_cluster.launches)
    set_fused_lstm(True)
    (res, rec, times, native, n_k4), plain = runs["graph"], runs["eager plain"]
    ticks = len(res.t)
    verr = max((a - b).abs().max().item() for a, b in zip(rec.vels, plain[1].vels))
    cerr = float(np.abs(res.cmd - plain[0].cmd).max())
    for label, (r, _, t, nat, n) in runs.items():
        log(f"HIL {label}: {len(r.t)} ticks, accumulator native {nat}, guard stopped "
            f"{r.guard_stopped}, final position {r.pos[-1].round(3).tolist()}, K4 cluster "
            f"launches {n}; ms per tick(): p50 {statistics.median(t):.3f}, max {max(t):.3f} "
            f"(first {t[0]:.3f}), p50 after the first {statistics.median(t[1:]):.3f} on {smi}")
    log(f"HIL graph vs eager plain path over {ticks} ticks: velocity max|diff| {verr:.3e}, "
        f"guarded command max|diff| {cerr:.3e} (atol {VEL_ATOL})")
    require(ticks == round(HIL_SECONDS * 15) and len(rec.vels) == ticks, "HIL tick count")
    require(all(nat for _, _, _, nat, _ in runs.values()), "the accumulator is not native")
    require(not any(r.guard_stopped for r, *_ in runs.values()), "the safety latch fired")
    require(n_k4 > 0 and plain[4] == 0, "the graph run did not take K4 / the plain run did")
    require(all(bool(torch.isfinite(v).all()) for v in rec.vels), "HIL velocity not finite")
    require(verr <= VEL_ATOL and cerr <= VEL_ATOL, "the HIL graph run disagrees with the plain path")
    return {label: statistics.median(t) for label, (_, _, t, _, _) in runs.items()}


_SERVING_KERNELS = {"K3": "hist_scaled_cluster_kernel", "K4": "lstm_cluster_kernel"}


def phase_profile(step, kernel_names=_SERVING_KERNELS, label="main-path", grad=False):
    """Device time of 3 steps of a path by kernel, under torch.profiler
    (in inference mode unless the steps need autograd, ``grad``);
    ``kernel_names`` maps a label to a substring of a kernel's name.
    Returns the busy and span ms, the idle share, the number of kernels and
    the device ms of each label, or None where the trace has no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if grad else torch.inference_mode():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
    # device events, without the annotations a record_function puts on the
    # device's timeline (Adam's "Optimizer.step#Adam.step"): they overlap
    # the kernels they annotate; their count is logged
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log("profile: the trace has no device time (not measured)")
        return None
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
        + f"; {len(kernels)} kernels, {len(device) - len(kernels)} annotations left out")
    for name, (n, us) in sorted(others.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  other: {us / 1e3:8.3f} ms in {n:5d} launches  {name[:90]}")
    return dict(busy_ms=busy / 1e3, span_ms=span / 1e3, idle_share=1 - busy / span,
                kernels=len(kernels), by_label={k: v / 1e3 for k, v in share.items()})


def phase_precision(dev, model, windows):
    """Fault 1: under PyTorch's default flags (cuDNN TF32 on), the entry
    points still compute in f32: the joint model's streaming step and
    LSTMNetVIT on the card against the CPU plain path within 1e-4, and the
    global flags as they were after every call."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    defaults = (True, False)  # PyTorch's own: TF32 for cuDNN, not for matmuls
    cudnn.allow_tf32, matmul.allow_tf32 = defaults
    cpu = torch.device("cpu")
    try:
        require(get_precision() == "highest", "the port's default precision is not 'highest'")
        pipe = StreamingPipeline(model, fast_percentile=True, device=dev)
        require(pipe.graph, "the streaming step does not replay a graph by default")
        outs = [pipe.step_events(*w) for w in windows[:3]]
        torch.cuda.synchronize()
        require((cudnn.allow_tf32, matmul.allow_tf32) == defaults,
                "the streaming entry point left the global flags changed")
        cpu_model = OrigUNet_w_VITFLY_ViTLSTM(device=cpu, **JOINT_CONFIG).eval()
        cpu_model.load_params(load_state_dict(JOINT_CHECKPOINT))
        cpu_pipe = StreamingPipeline(cpu_model, fast_percentile=True, device=cpu)
        refs = [cpu_pipe.step_events(*(t.cpu() for t in w)) for w in windows[:3]]
        verr = max((v.cpu() - vr).abs().max().item() for (v, _), (vr, _) in zip(outs, refs))
        derr = max((d.cpu() - dr).abs().max().item() for (_, d), (_, dr) in zip(outs, refs))
        hidden = ([(hu.cpu(), cu.cpu()) for hu, cu in pipe.hidden[0][0]], None), \
            tuple(t.cpu() for t in pipe.hidden[1])
        herr, cerr = state_errs(hidden, cpu_pipe.hidden)

        vit = LSTMNetVIT(device=dev).eval().load_params(load_state_dict(CHECKPOINT))
        vit_cpu = LSTMNetVIT(device=cpu).eval().load_params(load_state_dict(CHECKPOINT))
        ex, ey, ep = make_events(2, N_WINDOWS, N_EVENTS, cpu)
        small = event_histogram_scaled_resized(ex, ey, ep, H, W, H_OUT, W_OUT, device=cpu)
        desvel = torch.full((N_WINDOWS, 1), 4.0)
        with torch.inference_mode():
            vel, (h, c) = vit(small[:, None].to(dev), desvel.to(dev))
            vel_c, (h_c, c_c) = vit_cpu(small[:, None], desvel)
            set_precision("tf32")
            try:
                vel_tf32, _ = vit(small[:, None].to(dev), desvel.to(dev))
            finally:
                set_precision("highest")
        torch.cuda.synchronize()
        require((cudnn.allow_tf32, matmul.allow_tf32) == defaults,
                "LSTMNetVIT left the global flags changed")
        vit_err = (vel.cpu() - vel_c).abs().max().item()
        vit_herr = (h.cpu() - h_c).abs().max().item()
        vit_cerr = (c.cpu() - c_c).abs().max().item() / max(1.0, c_c.abs().max().item())
        tf32_err = (vel_tf32.cpu() - vel_c).abs().max().item()
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    log(f"precision, PyTorch's default flags (cudnn.allow_tf32 True): graph streaming step x3 vs "
        f"the CPU: velocity {verr:.3e}, depth {derr:.3e}, h {herr:.3e}, c/max(1,|c|) "
        f"{cerr:.3e}; LSTMNetVIT x {N_WINDOWS} windows vs the CPU: velocity {vit_err:.3e}, "
        f"h {vit_herr:.3e}, c/max(1,|c|) {vit_cerr:.3e} (atol {VEL_ATOL}); with "
        f"set_precision('tf32') the velocity differs by {tf32_err:.3e}")
    require(max(verr, derr, herr, cerr) <= VEL_ATOL,
            "the streaming step under PyTorch's default flags disagrees with the CPU")
    require(max(vit_err, vit_herr, vit_cerr) <= VEL_ATOL,
            "LSTMNetVIT under PyTorch's default flags disagrees with the CPU")


def phase_autograd(dev):
    """Fault 2: LSTMNetVIT.eval()(x, desvel) on the card without no_grad
    takes the plain loop (the kernels have no backward): its velocity and
    the gradient of its sum agree with set_fused_lstm(False)'s, and the
    velocity with the kernel's under no_grad, within 1e-4."""
    model = LSTMNetVIT(device=dev).eval().load_params(load_state_dict(CHECKPOINT))
    frames = sparse_frames(7, (64, 1, H_OUT, W_OUT), dev)
    desvel = torch.full((64, 1), 4.0, device=dev)
    kernels = (lstm_stacked, lstm_wavefront, lstm_stacked_cluster, lstm_wavefront_cluster)

    def run():
        model.zero_grad(set_to_none=True)
        vel, _ = model(frames, desvel)
        vel.sum().backward()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return vel.detach(), grads

    set_fused_lstm(True)
    for k in kernels:
        k.launches = 0
    vel, grads = run()
    launched = sum(k.launches for k in kernels)
    set_fused_lstm(False)
    vel_p, grads_p = run()
    set_fused_lstm(True)
    lstm_stacked_cluster.launches = 0
    with torch.no_grad():
        vel_k, _ = model(frames, desvel)
    torch.cuda.synchronize()
    require(lstm_stacked_cluster.launches > 0, "the no_grad forward did not take the kernel")
    verr = (vel - vel_p).abs().max().item()
    kerr = (vel - vel_k).abs().max().item()
    require(set(grads) == set(grads_p) and "lstm.weight_hh_l0" in grads, "gradients missing")
    gerr = max((grads[n] - grads_p[n]).abs().max().item()
               / max(1.0, grads_p[n].abs().max().item()) for n in grads)
    log(f"eval-mode forward under autograd: {launched} LSTM kernel launches; velocity vs the "
        f"plain loop {verr:.3e}, vs the kernel under no_grad {kerr:.3e}; gradients of "
        f"{len(grads)} parameters, max |diff|/max(1,|g|) {gerr:.3e} (atol {VEL_ATOL})")
    require(launched == 0, "a kernel without backward ran under autograd")
    require(max(verr, kerr, gerr) <= VEL_ATOL, "the forward under autograd disagrees")


def phase_event_cap(dev, flush):
    """Fault 3: CAP_EVENTS events per window through K2's and K3's entry
    points, routed by shape through K1's counts and ``scale_counts`` /
    ``scale_counts_resized``: the quantile equal to the plain version's,
    the frames within 2e-5 and 3e-5; each of the two kernels held against
    its plain version on K1's counts and timed, the cluster size swept."""
    require(scaled_route(CAP_EVENTS, H, W) == "k1"
            and scaled_route(CAP_EVENTS, H, W, (H_OUT, W_OUT)) == "k1",
            "the route of CAP_EVENTS events")
    ex, ey, ep = make_events(12, 2, CAP_EVENTS, dev)
    # window 1: a count past int16 on one pixel (and a zero quantile)
    ex[1, :HOT], ey[1, :HOT], ep[1, :HOT] = 100.5, 130.5, 1
    kernels = (hist_frame_cluster, hist_frame, hist_scaled, hist_scaled_resized,
               scale_counts, scale_counts_resized)
    for k in kernels:
        k.launches = 0
    frame, q = hist_scaled_routed(ex, ey, ep, H, W)
    small, qs = hist_scaled_resized_routed(ex, ey, ep, H, W, H_OUT, W_OUT)
    public = event_histogram_scaled(ex, ey, ep, H, W, device=dev)
    public_small = event_histogram_scaled_resized(ex, ey, ep, H, W, H_OUT, W_OUT, device=dev)
    torch.cuda.synchronize()
    counts = dict(zip(("K1 cluster", "K1 band", "K2", "K3", "scale_counts",
                       "scale_counts_resized"), (k.launches for k in kernels)))
    ref, qref = hist_scaled_plain(ex, ey, ep, H, W)
    sref, qsref = hist_scaled_resized_plain(ex, ey, ep, H, W, H_OUT, W_OUT)
    torch.cuda.synchronize()
    err, serr = (frame - ref).abs().max().item(), (small - sref).abs().max().item()
    q_bad = int((q != qref).sum().item()) + int((qs != qsref).sum().item())
    log(f"{CAP_EVENTS:,} events per window through event_histogram_scaled(_resized): "
        f"launches {counts}; q {q.tolist()} (plain {qref.tolist()}), {q_bad} mismatches; "
        f"frame max|diff| {err:.3e} (atol {K2_ATOL}), resized {serr:.3e} (atol {K3_ATOL})")
    require(counts == {"K1 cluster": 4, "K1 band": 0, "K2": 0, "K3": 0,
                       "scale_counts": 2, "scale_counts_resized": 2},
            "the over-cap batches did not take K1 and the scale kernels")
    require(q_bad == 0 and err <= K2_ATOL and serr <= K3_ATOL,
            "the K1 route disagrees with the plain version")
    require(torch.equal(public, frame) and torch.equal(public_small, small),
            "the entry points disagree with their routes")

    # each kernel on K1's counts against its plain version, and its times;
    # a window of counts whose 97th percentile passes the dense table (the
    # search over the lists), against its plain version
    cnt = hist_frame_routed(ex, ey, ep, H, W, 1.0, 1.0)
    B, HW, HWo = cnt.shape[0], H * W, H_OUT * W_OUT
    rng = np.random.default_rng(21)
    deep = torch.tensor(rng.integers(-400, 401, (1, H, W)), dtype=torch.float32, device=dev)
    entries = {}
    for name, kernel, plain, atol, extra, resize, n_out, per_out in (
            ("scale_counts", scale_counts, scale_counts_plain, K2_ATOL, (), None, HW, 3),
            ("scale_counts_resized", scale_counts_resized, scale_counts_resized_plain, K3_ATOL,
             (H_OUT, W_OUT), (H_OUT, W_OUT, False), HWo, 4 * 3 + 6)):
        kerr = 0.0
        for label, c in (("K1's counts", cnt), ("counts up to +-400", deep)):
            got, gq = kernel(c, *extra)
            want, wq = plain(c, *extra)
            torch.cuda.synchronize()
            kerr = max(kerr, (got - want).abs().max().item())
            log(f"{name} on {label} ({c.shape[0]} x {H}x{W}, max |count| "
                f"{c.abs().max().item():.0f}): max|diff| {kerr:.3e} (atol {atol}), q "
                f"{gq.tolist()} (plain {wq.tolist()})")
            require(bool(torch.isfinite(got).all()) and torch.equal(gq, wq) and kerr <= atol,
                    f"{name} disagrees with its plain version on {label}")
        ms = time_ms(lambda: kernel(cnt, *extra), flush, 20)
        plain_ms = time_ms(lambda: plain(cnt, *extra), flush, 5)
        sweep = {}
        for cluster in SCALE_SWEEP:
            got, gq = _scale_launch(name, cnt, 0.2, 0.97, 18, resize, cluster)
            want, wq = plain(cnt, *extra)
            torch.cuda.synchronize()
            require(torch.equal(gq, wq) and (got - want).abs().max().item() <= atol,
                    f"{name} on {cluster} CTAs disagrees with its plain version")
            sweep[cluster] = time_ms(lambda: _scale_launch(name, cnt, 0.2, 0.97, 18, resize,
                                                           cluster), flush, 20)
        # the counts read once, the output and q written once; per cell
        # |count| and its table entry, then per output its scalings (and the
        # resize's taps)
        n_bytes = 4 * (B * HW + B * n_out + B)
        n_flops = B * HW * 3 + B * n_out * per_out
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        log(f"{name} ({B} x {H}x{W} counts of K1): kernel {ms:.4f} ms on {SCALE_CLUSTER} "
            f"CTAs, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); cluster sizes: "
            + ", ".join(f"{c} CTAs {t:.4f} ms" for c, t in sweep.items())
            + f"; slice kept in shared memory: {resize is None and scale_slice_cached(HW)}")
        entries[name] = dict(max_abs_err=kerr, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
    return counts, entries


def phase_many_windows(dev):
    """Fault 4: K1 with MANY_WINDOWS windows, more than grid.y's 65,535,
    of FEW_EVENTS events at SMALL_H x SMALL_W, through the entry's route
    (the cluster kernel, windows x 8 CTAs on grid.x) and the band kernel:
    exactly equal to plain."""
    ex, ey, ep = make_events(13, MANY_WINDOWS, FEW_EVENTS, dev, SMALL_H, SMALL_W)
    ref = hist_frame_plain(ex, ey, ep, SMALL_H, SMALL_W)
    hist_frame_cluster.launches = 0
    for name, kernel in (("routed", hist_frame_routed), ("band", hist_frame)):
        got = kernel(ex, ey, ep, SMALL_H, SMALL_W)
        torch.cuda.synchronize()
        bad = int((got != ref).sum().item())
        log(f"K1 ({name}) with {MANY_WINDOWS:,} windows of {FEW_EVENTS} events at "
            f"{SMALL_H}x{SMALL_W} ({got.numel() * 4 / 1e9:.2f} GB of frames): {bad} cells "
            f"differ from plain")
        require(got.shape == (MANY_WINDOWS, SMALL_H, SMALL_W) and bad == 0,
                f"K1 ({name}) disagrees with its plain version past 65,535 windows")
        del got
    require(hist_frame_cluster.launches == 1, "the routed K1 did not take its cluster kernel")
    del ref
    torch.cuda.empty_cache()


def synthetic_trajectories(seed: int = 11):
    """TRAIN_TRAJS trajectories of TRAIN_FRAMES frames at 260x346 in
    write_h5_dataset's layout, from a numpy seed: smooth depths in [0, 1],
    sparse signed event counts (the dataloader rescales them by their 97th
    percentile), forward velocity commands with a y command that is 0 on
    some frames and a few nonzero z commands."""
    rng = np.random.default_rng(seed)
    t = np.arange(TRAIN_FRAMES)
    trajs = []
    for i in range(TRAIN_TRAJS):
        meta = np.zeros((TRAIN_FRAMES, 21), np.float32)
        meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 13] = t, t / 30.0, 5.0, 5.0
        meta[:, 14] = np.round(np.sin(t / 7.0 + i) * 2.0) / 2.0
        meta[:, 15] = (rng.random(TRAIN_FRAMES) < 0.2) * 0.5
        coarse = torch.from_numpy(rng.random((TRAIN_FRAMES, 1, 14, 18)).astype(np.float32))
        depths = interpolate_bilinear(coarse, (H, W))[:, 0].clamp(0.0, 1.0).numpy()
        counts = rng.integers(-3, 4, (TRAIN_FRAMES - 1, H, W), dtype=np.int8)
        evs = (counts * (rng.random((TRAIN_FRAMES - 1, H, W)) < 0.08)).astype(np.float32)
        trajs.append({"name": f"traj_{i:03d}", "data": meta, "depths": depths,
                      "ims": rng.random((TRAIN_FRAMES, H, W), dtype=np.float32),
                      "desvel": meta[:, 2], "evs": evs})
    return trajs


LSTM_KERNELS = (lstm_stacked, lstm_wavefront, lstm_stacked_cluster, lstm_wavefront_cluster)
# every kernel wrapper, by the names of the kernels' JSON entries
KERNELS = {"K1 cluster": hist_frame_cluster, "K1 band": hist_frame, "K2": hist_scaled,
           "K3": hist_scaled_resized, "scale_counts": scale_counts,
           "scale_counts_resized": scale_counts_resized, "K4 L2": lstm_stacked,
           "K5 L2": lstm_wavefront, "K4 cluster": lstm_stacked_cluster,
           "K5 cluster": lstm_wavefront_cluster}


def _recording_run_model(learner, records):
    """Wrap learner.run_model: each trajectory's mode, whether it trained,
    loss, terms, frames, synchronized seconds and the launches of each LSTM
    kernel (K4/K5, both routes) during it."""
    inner = learner.run_model

    def run_model(it, starts, lengths, ids, mode, *args, **kwargs):
        before = [k.launches for k in LSTM_KERNELS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(it, starts, lengths, ids, mode, *args, **kwargs)
        torch.cuda.synchronize()
        loss, terms = out[0]
        records.append(dict(
            mode=mode, training=mode == "train" and kwargs.get("do_step", True),
            loss=loss, terms=np.asarray(terms), frames=int(lengths[it]) - 1,
            seconds=time.perf_counter() - t0,
            launches=[k.launches - b for k, b in zip(LSTM_KERNELS, before)]))
        return out

    learner.run_model = run_model
    return inner


def _train_step_once(d, batch):
    """One train step of the joint model from policy_best.pth on device
    ``d``, no augmentation, no dropout: its loss, logged terms, gradient
    norm, gradients and the state before and after, on the CPU."""
    model = OrigUNet_w_VITFLY_ViTLSTM(device=d, **JOINT_CONFIG)
    model.load_params(load_state_dict(JOINT_CHECKPOINT))
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN_CONFIG["lr"], betas=(0.9, 0.999),
                           eps=1e-8)
    step = stepfn.make_train_step(model, "joint_vitlstm", opt, TRAIN_CONFIG["loss_weights"],
                                  TRAIN_CONFIG["optional_loss_param"])
    loss, values, gn = step({k: v.to(d) for k, v in batch.items()}, None)
    return dict(loss=loss.item(), values=values.cpu(), gn=gn.item(), before=before,
                grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                after={k: v.detach().cpu() for k, v in model.state_dict().items()})


def _step_errors(got, ref):
    """The readings of one train step against the CPU's, each over its
    bound (see TRAIN_GRAD_TOL): 1 or less passes.  Also the share of the
    elements whose update is held only to 2 lr, and the worst leaves."""
    lr, ulp = TRAIN_CONFIG["lr"], torch.finfo(torch.float32).eps
    rel = lambda a, b: abs(a - b) / max(1.0, abs(b))
    grad, step, small, n = {}, {}, 0, 0
    for k, g in ref["grads"].items():
        gg = got["grads"][k]
        top, gap = g.abs().max().item(), (gg - g).abs().max().item()
        grad[k] = gap / (TRAIN_GRAD_TOL * top) if top else float("inf") if gap else 0.0
        p0 = ref["before"][k]
        d_got, d_ref = got["after"][k] - p0, ref["after"][k] - p0
        tiny = (g.abs() <= TRAIN_SMALL_G * gap) & ((g != 0) | (gg != 0))
        bound = torch.where(tiny, torch.full_like(p0, 2 * lr), torch.full_like(p0, TRAIN_STEP_ATOL)
                            ) + ulp * p0.abs()
        ratio = ((d_got - d_ref).abs() / bound).flatten()
        i = int(ratio.argmax())
        # the worst element: its reading, gradients and updates (card, CPU)
        step[k] = (ratio[i].item(), gg.flatten()[i].item(), g.flatten()[i].item(),
                   d_got.flatten()[i].item(), d_ref.flatten()[i].item())
        small, n = small + int(tiny.sum()), n + g.numel()
    uv = max((got["after"][k] - v).abs().max().item() for k, v in ref["after"].items()
             if k not in ref["grads"])
    worst = lambda d, key: sorted(d.items(), key=lambda kv: -key(kv[1]))[:3]
    return dict(loss=rel(got["loss"], ref["loss"]) / TRAIN_RTOL,
                terms=max(((got["values"] - ref["values"]).abs()
                           / ref["values"].abs().clamp_min(1.0)).tolist()) / TRAIN_RTOL,
                gradnorm=rel(got["gn"], ref["gn"]) / TRAIN_RTOL,
                grads=max(grad.values()), update=max(v[0] for v in step.values()),
                uv=uv / TRAIN_UV_TOL, small_share=small / n, worst_grads=worst(grad, float),
                worst_update=worst(step, lambda v: v[0]))


def _card_vs_cpu_step(dev, batch):
    """One train step of the joint model on the card and on the CPU, same
    chunk: the card's readings against the CPU's, the same readings of a
    step in TF32 on the card, and the CPU's loss, terms and gradient norm."""
    ref = _train_step_once(torch.device("cpu"), batch)
    errs = _step_errors(_train_step_once(dev, batch), ref)
    saved = get_precision()
    set_precision("tf32")
    try:
        tf32 = _step_errors(_train_step_once(dev, batch), ref)
    finally:
        set_precision(saved)
    return errs, tf32, (ref["loss"], ref["values"].tolist(), ref["gn"])


def phase_training(dev, smi):
    """The training path at full width: the joint configuration of
    tools/train_policy.py from policy_best.pth, Learner(cfg).train_loop()
    for 2 epochs on a synthetic dataset that the port's dataloader
    preprocesses and caches (numpy only: no h5py, no h5 file), then its
    checks and the card's numbers.  The data and checkpoints live under
    build/ and are removed after."""
    root = os.path.join(REPO, "build", f"train_smoke_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    try:
        return _training(dev, smi, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _training(dev, smi, root):
    datadir = os.path.join(root, "data", "datasets")
    cfg = EvflyConfig(basedir=root, logdir="logs", datadir=datadir, dataset=["synthetic"],
                      **TRAIN_CONFIG)
    t0 = time.perf_counter()
    train, val, _ = cache_dataset(os.path.join(datadir, "synthetic"), synthetic_trajectories(),
                                  logger=lambda m: None, **dataloader_kwargs(cfg))
    log(f"training data route: cache_dataset (the port's dataloader preprocessed "
        f"{TRAIN_TRAJS} in-memory trajectories of {TRAIN_FRAMES} frames at {H}x{W} into its "
        f"cache under a .h5.stat.json stamp, no h5py) in {time.perf_counter() - t0:.1f}s: "
        f"train {train.ims.shape[0]} frames, val {val.ims.shape[0]}; event frames in "
        f"[{min(float(e.min()) for e in train.evs):.2f}, "
        f"{max(float(e.max()) for e in train.evs):.2f}]")
    learner = Learner(cfg)
    with open(os.path.join(learner.workspace, "log.txt")) as fh:
        require("Cache hit" in fh.read(), "the Learner's dataloader missed the cache")
    require(learner.device.type == "cuda", "the Learner did not take the card by default")
    records = []
    run_model = _recording_run_model(learner, records)
    for k in KERNELS.values():
        k.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what the earlier phases still hold
    t0 = time.perf_counter()
    learner.train_loop()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()

    trained = [r for r in records if r["training"]]
    validated = [r for r in records if not r["training"]]
    n_train, n_val = learner.num_training_steps, learner.num_val_steps
    chunks = lambda rs: sum(-(-r["frames"] // cfg.batch_size) for r in rs)
    k4_train = [sum(r["launches"]) for r in trained]
    k4_val = sum(r["launches"][2] for r in validated)  # lstm_stacked_cluster
    log(f"train_loop: {len(trained)} trajectories trained ({chunks(trained)} chunks), "
        f"{len(validated)} validated ({chunks(validated)} chunks) in {loop_s:.1f}s; LSTM "
        f"kernel launches (K4 L2, K5 L2, K4 cluster, K5 cluster): train "
        f"{[sum(r['launches'][i] for r in trained) for i in range(4)]}, validation "
        f"{[sum(r['launches'][i] for r in validated) for i in range(4)]}; launches of every "
        f"kernel over train_loop {launches}; losses "
        + ", ".join(f"{r['mode']} {r['loss']:.4f}" for r in records))
    require(len(trained) == cfg.N_eps * n_train and len(validated) == cfg.N_eps * n_val,
            "train_loop ran another number of trajectories")
    require(all(np.isfinite(r["loss"]) and np.isfinite(r["terms"]).all() for r in records),
            "a training or validation loss is not finite")
    require(all(n == 0 for n in k4_train), "an LSTM kernel launched in a train step")
    require(k4_val == chunks(validated) and sum(sum(r["launches"]) for r in validated) == k4_val,
            "validation did not run K4 (cluster route) once per chunk")
    require(launches == {**{name: 0 for name in KERNELS}, "K4 cluster": k4_val},
            "train_loop launched another kernel than K4's cluster route in validation")

    ws = learner.workspace
    files = set(os.listdir(ws))
    require({"args.txt", "log.txt", "train_val_dirs.npy", "model_ep000000.pth",
             "model_ep000001.pth"} <= files, f"missing workspace files: {sorted(files)}")
    for prefix in ("model_best_ep", "model_best0_ep", "model_best1_ep"):
        require(sum(f.startswith(prefix) for f in files) == 1, f"not one {prefix}*.pth")
    final = os.path.join(ws, "model_ep000001.pth")
    saved = load_state_dict(final)
    before = {k: v.detach().clone() for k, v in learner.params.items()}
    learner.load_from_checkpoint(final)
    after = learner.params
    require(learner.num_eps_trained == 1 and all(
        torch.equal(after[k].cpu(), saved[k]) and torch.equal(after[k], before[k])
        for k in saved), "model_ep000001.pth did not reload bit for bit")
    stream_model = OrigUNet_w_VITFLY_ViTLSTM(device=dev, **JOINT_CONFIG).eval()
    stream_model.load_params(saved)
    ex, ey, ep = make_events(21, 1, N_EVENTS, dev)
    vel, depth = StreamingPipeline(stream_model, device=dev).step_events(ex[0], ey[0], ep[0])
    torch.cuda.synchronize()
    require(vel.shape == (3,) and depth.shape == (H, W) and bool(torch.isfinite(vel).all())
            and bool(torch.isfinite(depth).all()), "the trained file does not stream")
    log(f"workspace {sorted(files)}; model_ep000001.pth reloaded bit for bit; one streaming "
        f"step with it: velocity {vel.tolist()}")

    # validation through K4 against the plain loop, and its rate
    starts, lengths = learner.val.traj_starts, learner.val.trajlength
    ids = np.arange(n_val)

    def validate(fused):
        set_fused_lstm(fused)
        for k in LSTM_KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = [run_model(it, starts, lengths, ids, "val", batch_size=cfg.batch_size)
                for it in range(n_val)]
        torch.cuda.synchronize()
        set_fused_lstm(True)
        return outs, lstm_stacked_cluster.launches, time.perf_counter() - t

    validate(True)  # warm-up
    fused, n_fused, val_s = validate(True)
    plain, n_plain, _ = validate(False)
    rel = lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                                    / np.maximum(1.0, np.abs(np.asarray(b)))))
    val_err = max(max(rel(f[0][0], p[0][0]), rel(f[0][1], p[0][1]),
                      rel(f[1][0][0], p[1][0][0]), rel(f[1][0][1], p[1][0][1]))
                  for f, p in zip(fused, plain))
    val_frames = int(np.sum(lengths - 1))
    log(f"validation with K4 ({n_fused} launches) against the plain loop ({n_plain}): max "
        f"|diff| / max(1, |x|) over losses, terms, velocities and depths {val_err:.3e}")
    require(n_fused == chunks(validated) // cfg.N_eps and n_plain == 0,
            "validation's K4 launches")
    require(val_err <= VEL_ATOL, "validation through K4 disagrees with the plain loop")

    # one train step on the card against the CPU
    data, ev_offsets = learner._get_device_data("train", cfg.batch_size)
    batch_fn = stepfn.make_batch_slicer(cfg.batch_size, cfg.num_in_channels,
                                        cfg.num_out_channels)
    idx0 = {"start": int(learner.train.traj_starts[0]) + 1, "ev_start": int(ev_offsets[0]),
            "n_valid": cfg.batch_size}
    t0 = time.perf_counter()
    errs, tf32, cpu_vals = _card_vs_cpu_step(dev, batch_fn(data, idx0))
    checked = ("loss", "terms", "gradnorm", "grads", "update", "uv")
    show = lambda e: ", ".join(f"{k} {e[k]:.3e}" for k in checked) + (
        f"; {e['small_share']:.4f} of the elements held to 2 lr; worst gradient leaves "
        f"{e['worst_grads']}; worst update leaves {e['worst_update']}")
    log(f"train step, card against CPU ({time.perf_counter() - t0:.1f}s; CPU loss, terms, "
        f"gradient norm {cpu_vals}), each reading over its bound (TRAIN_RTOL {TRAIN_RTOL}, "
        f"TRAIN_GRAD_TOL {TRAIN_GRAD_TOL}, TRAIN_STEP_ATOL {TRAIN_STEP_ATOL}, TRAIN_SMALL_G "
        f"{TRAIN_SMALL_G}, TRAIN_UV_TOL {TRAIN_UV_TOL}): {show(errs)}")
    log(f"the same step in TF32 on the card against the CPU: {show(tf32)}")
    require(max(errs[k] for k in ("loss", "terms", "gradnorm")) <= 1,
            "the card's loss, terms or gradient norm disagree with the CPU's")
    require(errs["grads"] <= 1, "the card's gradients disagree with the CPU's")
    require(errs["update"] <= 1 and errs["uv"] <= 1,
            "the card's Adam step or power iteration disagrees with the CPU's")
    require(max(tf32[k] for k in checked) > 1, "a train step in TF32 passes the f32 bounds")

    # the card's numbers: train steps as train_loop runs them
    step = learner._get_step("train", indexed=True, B=cfg.batch_size)
    gen = learner._generator
    idxs = [{"start": int(s) + 1 + c * cfg.batch_size,
             "ev_start": int(o) + c * cfg.batch_size, "n_valid": cfg.batch_size}
            for s, o in zip(learner.train.traj_starts, ev_offsets) for c in range(3)]
    for i in range(2):
        step(data, idxs[i], gen)
    times = []
    for i in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(data, idxs[i % len(idxs)], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    step_s = statistics.median(times)
    prof = phase_profile(lambda: step(data, idxs[0], gen), {"K4": "lstm_cluster_kernel"},
                         "train", grad=True)
    epoch_s = loop_s / cfg.N_eps
    numbers = dict(train_step_ms=step_s * 1e3, train_chunks_per_s=1.0 / step_s,
                   train_frames_per_s=cfg.batch_size / step_s,
                   val_frames_per_s=val_frames / val_s, seconds_per_epoch=epoch_s,
                   max_memory_allocated_gib=peak / 2**30,
                   train_loop_peak_gib=(peak - base) / 2**30,
                   idle_share=None if prof is None else prof["idle_share"])
    log(f"training numbers (card: {smi}; {cfg.batch_size}-frame chunks at {H}x{W}, full f32, "
        f"median of {TRAIN_TIMED} synchronized train steps after 2): "
        + ", ".join(f"{k} {v}" for k, v in numbers.items())
        + f"; train_loop {loop_s:.2f}s for {cfg.N_eps} epochs of {n_train} train and {n_val} "
          f"val trajectories with checkpoints")
    return launches, numbers


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
    with Phase("K4 and K5 on both routes vs plain"):
        lstm_errs = phase_lstm_routes(dev)
    with Phase("K4 and K5 times, routes in turns"):
        lstm_times = phase_lstm_times(dev, flush)
    model = joint_model(dev)
    windows = stream_windows(dev, STREAM_WINDOWS)
    with Phase("fault 1: precision under PyTorch's default flags"):
        phase_precision(dev, model, windows)
    with Phase("fault 2: eval-mode forward under autograd"):
        phase_autograd(dev)
    with Phase(f"fault 3: {CAP_EVENTS:,} events per window through K2's and K3's entry points"):
        cap_launches, cap = phase_event_cap(dev, flush)
    with Phase(f"fault 4: K1 with {MANY_WINDOWS:,} windows"):
        phase_many_windows(dev)
    with Phase("main path"):
        launches, l2_launches, wps, wps_l2, step = phase_main_path(dev, smi)
    with Phase("profile"):
        phase_profile(step)
    with Phase("fused rung"):
        rung_launches = phase_fused_rung(dev)
    with Phase("streaming path"):
        stream_launches, windows = phase_streaming(dev, model)
    with Phase(f"batched streaming, {STREAMS} streams"):
        phase_batched(dev, model)
    with Phase("graph step"):
        phase_graph_step(dev, model)
    with Phase("deployment loop (HIL)"):
        tick_ms = phase_hil(dev, model, smi)
    with Phase("card numbers"):
        numbers = phase_card_numbers(dev, model, windows, smi)
    with Phase("streaming profile, graph and eager"):
        idle = {}
        for graph in (True, False):
            pipe = StreamingPipeline(model, fast_percentile=True, device=dev, graph=graph)
            prof = phase_profile(lambda: pipe.step_events(*windows[0]),
                                 {"K1": "hist_frame_cluster_kernel", "K4": "lstm_cluster_kernel"},
                                 f"streaming ({'graph' if graph else 'eager'})")
            idle["graph" if graph else "eager"] = None if prof is None else prof["idle_share"]
    with Phase(f"batched profile, {STREAMS} streams"):
        bpipe = BatchedStreamingPipeline(model, STREAMS, fast_percentile=True, device=dev)
        bframes = sparse_frames(6, (STREAMS, H, W), dev)
        phase_profile(lambda: bpipe.step_frames(bframes), {"K4": "lstm_cluster_kernel"},
                      f"batched G={STREAMS}")
    with Phase("training: Learner.train_loop, joint model at full width"):
        train_launches, train_numbers = phase_training(dev, smi)
    signal.alarm(0)

    def entry(name, source, replaces, n, key, **times):
        """A kernel's JSON entry; ``key`` names it in KERNELS, for its
        launches over the training phase's train_loop."""
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=n,
                    training_launches=train_launches[key], **times)

    def lstm_entry(mode, route, n):
        """A K4 or K5 route's JSON entry, timed at its path's shape: K4 at
        the serving length, K5 at the streaming step's (one stream, T = 1)."""
        key = (mode, 1, N_WINDOWS) if mode == "stacked" else (mode, 1, 1)
        t = lstm_times[key]
        label, kernel, _ = LSTM_ROUTES[(mode, route)]
        return entry(f"{kernel.__name__} ({label})", lstm_src,
                     "evfly_tpu/ops/lstm_pallas.py:" + ("111" if mode == "stacked" else "203"),
                     n, label, max_abs_err=lstm_errs[(mode, route)], ms=t[route],
                     plain_ms=t[f"plain_{route}"], bound_ms=t["bound_ms"],
                     bound_by=t["bound_by"], library_ms=t["library_ms"])

    vox, lstm_src = "evfly_tpu_torch/csrc/voxelizer.cu", "evfly_tpu_torch/csrc/lstm.cu"
    kernels = [
        entry("hist_frame_cluster (K1, cluster kernel)", vox, "evfly_tpu/ops/voxelizer.py:153",
              stream_launches["K1 cluster"], "K1 cluster", **k1["cluster"]),
        entry("hist_frame (K1, band kernel)", vox, "evfly_tpu/ops/voxelizer.py:153",
              stream_launches["K1 band"], "K1 band", **k1["band"]),
        entry("hist_scaled (K2, cluster kernel)", vox, "evfly_tpu/ops/voxelizer.py:251",
              rung_launches["K2"], "K2", **k2),
        entry("hist_scaled_resized (K3, cluster kernel)", vox,
              "evfly_tpu/ops/voxelizer.py:405", launches["K3"], "K3", **k3),
        entry("scale_counts (K2's function over K1's counts, cluster kernel)", vox,
              "evfly_tpu/ops/voxelizer.py:251", cap_launches["scale_counts"],
              "scale_counts", **cap["scale_counts"]),
        entry("scale_counts_resized (K3's function over K1's counts, cluster kernel)", vox,
              "evfly_tpu/ops/voxelizer.py:405", cap_launches["scale_counts_resized"],
              "scale_counts_resized", **cap["scale_counts_resized"]),
        lstm_entry("stacked", "cluster", launches["K4 cluster"]),
        lstm_entry("wavefront", "cluster", stream_launches["K5 cluster"]),
        lstm_entry("stacked", "l2", l2_launches["K4 L2"]),
        lstm_entry("wavefront", "l2", stream_launches["K5 L2"]),
    ]
    streaming = "; ".join(
        f"{mode} {route} {'graph' if graph else 'eager'} "
        + ", ".join(f"{c:.3f}" for c, _ in numbers[(mode, route, graph)])
        for mode in ("stacked", "wavefront") for route in ("cluster", "l2")
        for graph in (True, False))
    log(f"done in {time.perf_counter() - _T0:.1f}s; main path {wps:.1f} windows/s (L2 route "
        f"{wps_l2:.1f}); streaming ms per chained step: {streaming}; idle share of a "
        f"streaming step {idle}; p50 ms per HIL tick {tick_ms}; steps/s "
        + ", ".join(f"G={G} {'graph' if graph else 'eager'} "
                    + ", ".join(f"{r:.1f}" for r in numbers[(G, graph)])
                    for G in RATE_STREAMS for graph in (True, False))
        + f"; training {train_numbers}")
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
