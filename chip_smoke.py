"""Smoke run of the PyTorch/CUDA port (evfly_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``evfly_tpu_torch/csrc`` (one ``nvcc``
call, cached in ``build/``), holds each of K1-K5 against its plain PyTorch
version on the card (K1 on its three routes: one thread-block cluster of
8 CTAs per window with the frame in the cluster's shared memory, one of 16
where 8 do not hold the frame, and for the frames no cluster holds the band
route, a partition pass that sorts each window's events by band of the
frame and a pass of one block per (window, band); K2 and K3 on their
cluster kernel, with int16 and int32 counts; K4 and K5 on their three
routes: one 8-CTA cluster per stream with the weights in shared memory, one
cooperative grid of H/8 CTAs for all streams with each CTA's gate columns
in its shared memory, and one block per stream reading them from L2), times
each pair in turns, old and new, beside an empty launch, sweeps the cluster
sizes, traps a stalled grid barrier in a child process, checks the
port's repaired faults (precision under PyTorch's default flags, an
eval-mode forward under autograd, more events per window than K2's and
K3's caps through their entry points and ``scale_counts``' cluster kernels,
more than 65,535 windows through every K1 route), then drives the
port's paths through the entry points a user calls, each compared with its
plain path on the card and each with the kernels' launch counts set to 0
just before it and read just after:

- serving: 256 windows x 5,000 raw events -> ``event_histogram_scaled_resized``
  (K3 on clusters) -> ``LSTMNetVIT`` with ``artifacts/pretrain_v_final.pth`` (its LSTM
  through K4 on the cluster route) -> velocity (256, 3), and its launches
  with the LSTM forced onto the L2 route;
- the fused rung of ``bench.py``: the same windows -> ``event_histogram_scaled``
  (K2 on clusters) -> bilinear resize -> ``LSTMNetVIT`` (K4);
- streaming: ``StreamingPipeline.step_events`` with the joint model
  ``OrigUNet_w_VITFLY_ViTLSTM`` and ``artifacts/policy_best.pth`` over 8
  windows of 5,000 events, state carried: ``event_histogram`` (K1 on
  clusters) ->
  97th-percentile scale -> OrigUNet with its ConvLSTM -> LSTMNetVIT through
  K4 (mode "stacked") or K5 (mode "wavefront"), on each route, and once
  with K1's band route;
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
  a step in TF32 must fail the same bounds;
- data parallel: ``Learner(cfg).train_loop()`` of the same configuration
  with ``dp_devices = 1, dp_chunks_per_device = 8`` (G = 8 chunks per Adam
  step in one forward, ``parallel/``) for 2 epochs: finite losses, the LR
  schedule at the sequential path's epoch fractions, K4 once per
  validation chunk and no kernel in a train step; the G = 2 step on the
  card against the CPU (one chunk partial) under the training bounds;
  configuration A's G = 4 step (a padded chunk) against the mean of its
  per-chunk gradients and BatchNorm updates, in f64; the step's ms,
  frames/s and peak memory at G = 1 to 16 in turns against the per-chunk
  step, its idle share, s per epoch; and the dry run
  (``parallel.dryrun_chunked(2)``: two processes sharing the card through
  gloo against one);
- the velocity heads: configuration A (evfly_tpu/configs/files/
  eval_sim_Dtheta_vitlstm.txt: ``OrigUNet`` with the velpred-11 head on its
  68x148 decoder output, 768 features) and B (the same D(theta) with
  ``ConvNet_w_VelPred`` and a 1-layer LSTM of hidden 768) built through
  ``registry.build_model``, D(theta) from ``policy_best.pth``, the heads
  from a seed; K4 and K5 on the grid route at H = 768, L = 1 (and on the
  L2 route of before) against their plain versions and timed in turns
  beside cuDNN's LSTM; B through ``StreamingPipeline.step_events`` in both
  modes (graph against eager, then against the plain path, then its step
  timed on the grid and the forced L2 route in turns) and
  ``BatchedStreamingPipeline`` with 16 streams;
  ``Learner(cfg).train_loop()`` for 2 epochs on A (no kernel launches; the
  BatchNorm counters count the steps; the checkpoint carries the running
  stats and reloads bit for bit), A's step on a padded chunk on the card
  against the CPU in f64 under the training bounds and in f32 under those
  of its loss, terms, gradient norm and BatchNorm state, and B's validation
  through K4's grid route against the plain loop;
- the rest of the model zoo: the serving windows through K3 into
  ``ConvNet``, ``LSTMNet``, ``ViT``, ``UNetConvLSTMNet`` and
  ``LegacyTransformer`` (weights from a seed), each on the card against
  the same model on the CPU, its parameter count, its windows/s and K3's
  launches (K4's and K5's none: hidden 395 and 200 take the plain loop);
- the dataset path: a Prophesee-like 640x480 recording (3 s at 960,000
  events/s, ns epoch stamps, {0, 1} polarity) encoded to EVT3, decoded by the port's native
  decoder and packaged by ``package_real_sequence`` on the card, K1 over
  all its windows in one launch (8 CTAs, and with two thresholds 16), the
  trajectory equal to the CPU's key by key; K1's window launch bit for bit
  against its plain version on a DAVIS-like stream of 2,000,000 events over
  60 windows (sorted, shuffled, overlapping, empty) on each route (at
  260x346, and scaled to 640x480 and 1280x720) and at every alignment,
  timed in turns against the padded (B, N_max) launch at 260x346, and the
  16-CTA route against the band route at 640x480 and 1280x720 (shapes A
  and B), beside the plain version, ``torch.bincount`` (with weights
  +pos/-neg) and the bytes bound, the sort timed alone;
- event generation: a 49-frame trajectory at 260x346 (a texture
  translating with its exact flow, adaptive factors 1 to 16) through
  ``to_events.trajectory_events`` by the esim, esim_flow and difflog
  schemes on the card against the CPU, equal away from quantization
  crossings (``esim_margins``, ``difflog_margins``), ms per trajectory;
- the closed loop: ``sim.run_trials_batched(mode="vision")`` of 16 trials
  in lockstep in forests of 60 trees at 260x346 (render, difflog, the
  joint model from ``policy_best.pth`` in a ``BatchedStreamingPipeline``
  whose CUDA graph runs K4, the dynamics), ticks/s, successes and crashes,
  every kernel's launches over the run (the JSON entries'
  ``closed_loop_launches``), the first ticks' velocities against single
  eager streams on the same frames, one tick's render and difflog against
  the CPU under the render's margin rule, the render's ms and peak memory,
  and a profile of one-tick runs; state-mode trials batched against
  ``run_trial``; ``run_evaluation`` of two vision trials with a
  ``StreamingPipeline`` per trial;
- PPO: ``sim.ppo.train_ppo`` on ``VecVisionEnv`` and on the quadrotor
  env's ``ppo_spec`` at 100 envs x 128 steps (iterations/s, env steps/s),
  and one iteration on the card against the CPU from the same weights,
  states and random draws;
- the drivers (``evfly_tpu_torch/tools``), each through its own functions
  (the JSON entries' ``protocol_launches``, ``e2e_demo_launches`` and
  ``hil_driver_launches``): ``train_policy``'s protocol evaluation at the
  JAX record's settings (``policy_best.pth``, 40 forests of seed 91000 in
  batches of 20, at least 36 successful, the first G = 20 ticks against
  single eager streams in TF32 and, replayed, in f32); ``dagger`` trials,
  ``datagen`` in state mode with the flow of two trajectories, both into
  ``cache_dataset``, and ``e2e_demo`` (data, one epoch, one evaluation
  trial; its Learner reads the cache, K4 in validation); ``train_rl`` for
  each env and its greedy rollout on the card against the CPU; an 8 s
  ``hil_real_model`` episode with ``policy_best.pth``; and the two reports
  at their defaults against the JAX records;
- the probes (the JSON entries' ``probes_launches``), on the DAgger
  trajectories: ``overfit_probe`` at its defaults (150 steps, 192 frames,
  chunks of 32; its final check's K4 output against the plain loop),
  ``openloop_probe`` with ``policy_best.pth`` (joint) and
  ``pretrain_v_final.pth`` (vit_depth) over 64 frames, carried and reset
  every 16 (ms a frame; the first 8 frames against the CPU), and
  ``bf16_accept`` at 256 windows (each arm's K4 output against the plain
  loop; ``overfit_ok`` and ``accept`` reported, not required).

It also times the train step (chunks/s, frames/s, idle share, peak
memory), validation (frames/s) and an epoch, and the velocity heads' train
step, validation and streaming step; the speed of the serving and
streaming paths is the benchmark's (``perfbench/``).  Every phase prints a
flushed line when it starts and when it ends.  The last lines of standard
output are the card's name and power limit, the kernels' JSON line and
the result line ``{"ok": true, "device": {...}}``.

Exits non-zero, and prints no result, when there is no CUDA device, when a
kernel fails to build, launch or agree, or when the run exceeds its budget.
"""

from __future__ import annotations

import argparse
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
from evfly_tpu_torch.graphs import WARMUP_STEPS
from evfly_tpu_torch.data import evt3, realdata, to_events
from evfly_tpu_torch.data.dataloading import cache_dataset
from evfly_tpu_torch.models import port
from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM
from evfly_tpu_torch.models.port import load_state_dict
from evfly_tpu_torch.models.recurrent import lstm_loop, set_fused_lstm
from evfly_tpu_torch.models import legacy_vit, vitfly
from evfly_tpu_torch.models.common import param_count
from evfly_tpu_torch.models.registry import build_model
from evfly_tpu_torch.models.vitfly import LSTMNetVIT
from evfly_tpu_torch.precision import get_precision, set_precision
from evfly_tpu_torch.ops import _build, esim, lstm_fused, upsample, voxelizer
from evfly_tpu_torch.ops.imageops import interpolate_bilinear
from evfly_tpu_torch.ops.lstm_fused import (
    choose_route,
    cluster_fits,
    cluster_occupancy,
    lstm_stacked,
    lstm_stacked_cluster,
    lstm_stacked_cluster_plain,
    lstm_stacked_grid,
    lstm_stacked_grid_plain,
    lstm_stacked_plain,
    lstm_wavefront,
    lstm_wavefront_cluster,
    lstm_wavefront_cluster_plain,
    lstm_wavefront_grid,
    lstm_wavefront_grid_plain,
    lstm_wavefront_plain,
    grid_fits,
    grid_occupancy,
    pack,
    pack_grid,
)
from evfly_tpu_torch.ops.voxelizer import (
    K1_CLUSTER,
    K1_WIDE_CLUSTER,
    K2_CLUSTER,
    K3_CLUSTER,
    SCALE_CLUSTER,
    _frame_cluster_launch,
    _frame_windows_launch,
    _resized_cluster_launch,
    _scale_launch,
    _scaled_cluster_launch,
    bin_events,
    event_frames_from_windows,
    event_histogram,
    event_histogram_scaled,
    event_histogram_scaled_resized,
    BAND_ROUTE,
    K1Route,
    band_route_cells,
    band_route_layout,
    frame_cluster_fits,
    hist_frame,
    hist_frame_cluster,
    hist_frame_plain,
    hist_frame_routed,
    hist_frame_windows,
    hist_frame_windows_plain,
    hist_scaled,
    hist_scaled_plain,
    hist_scaled_resized,
    hist_scaled_resized_plain,
    hist_scaled_resized_routed,
    hist_scaled_routed,
    k1_route,
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
    window_offsets,
)
from evfly_tpu_torch.ops.voxelizer import cluster_occupancy as vox_cluster_occupancy
from evfly_tpu_torch.parallel import dryrun_chunked, make_dp_chunked_train_step
from evfly_tpu_torch.parallel.mesh import Mesh
from evfly_tpu_torch.sim import batched as sim_batched
from evfly_tpu_torch.sim import closed_loop, ppo, quadrotor_env, render, vision_env
from evfly_tpu_torch.sim.launch_evaluation import run_evaluation
from evfly_tpu_torch.sim.obstacles import generate_forest
from evfly_tpu_torch.stream import BatchedStreamingPipeline, StreamingPipeline, hil
from evfly_tpu_torch.stream.pipeline import event_bucket
from evfly_tpu_torch.train import Learner, stepfn
from evfly_tpu_torch.train.learner import dataloader_kwargs
from evfly_tpu_torch.tools import (bf16_accept, datagen, e2e_demo, esim_divergence_report,
                                   hil_real_model, openloop_probe, overfit_probe, train_policy,
                                   train_rl, upsample_report)

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
# the same at the serving LSTM's shape for the kernels alone, with the grid
# route forced there
KERNEL_TURNS = ("l2", "cluster", "grid", "grid", "cluster", "l2")
# (G, T) of the grid route at H = 256, L = 3 (which it took from the L2
# route), timed in turns with L2
GRID_256_TIMED = ((1, 1), (1, 16))
STREAM_WINDOWS, STREAMS = 8, 16         # streaming steps; batched streams
HIL_SECONDS = 2.0                       # 30 ticks of the deployment loop at 15 Hz
# the window of the graph-step phase cut to another event bucket (2,048)
SECOND_BUCKET_AT, SECOND_BUCKET_EVENTS = 5, 1500
# _streaming_ms's chained and synchronized streaming steps
CHAINED_STEPS, SYNC_STEPS = 100, 20

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
# chunk-level data parallelism: train_loop with dp_chunks_per_device =
# DP_CHUNKS; the step timed at each G of DP_SWEEP (DP_TIMED synchronized
# steps after 1, in turns) against the per-chunk step
DP_CHUNKS, DP_SWEEP, DP_TIMED = 8, (1, 2, 4, 8, 16), 3
# device memory reserved after the streaming phases and an empty_cache: the
# G-chunk sweep needs 26 GiB more (an out-of-memory there with 61.7 GiB
# reserved but unallocated, before the pipelines kept one warm-up stream)
RESERVED_AFTER_STREAMING_GIB = 16.0
# the velocity heads, with TRAIN_CONFIG's enc and fc params (those of
# evfly_tpu/configs/files/eval_sim_Dtheta_vitlstm.txt): configuration A is
# that file's model, OrigUNet with the velpred-11 head on its 68x148 decoder
# output (768 features, no head LSTM); B is the same D(theta) with
# ConvNet_w_VelPred and a 1-layer LSTM of hidden 768 on that output.
# D(theta) comes from policy_best.pth, the heads from HEADS_SEED.
CONFIG_A = dict(model_type=["OrigUNet"], velpred=11, num_recurrent=[1, 0], num_outputs=1)
CONFIG_B = dict(model_type=["OrigUNet", "ConvNet_w_VelPred"], velpred=0, num_recurrent=[1, 1],
                num_outputs=1)
HEADS_SEED, HEAD_H = 23, 768
# (G, T) of the head LSTM's checks (streaming: T = 1 at G = 1 and 16;
# validation: a 16-frame chunk; the grid kernel's staged chunks of 8
# streams: a partial one at G = 3, eight at G = 64) and of its timings
HEAD_LSTM_CHECKS = ((1, 16), (1, 1), (16, 1), (16, 16), (3, 2), (64, 2))
HEAD_LSTM_TIMED = ((1, 1), (16, 1), (1, 16), (64, 1))
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
# BatchNorm running stats after a step, card against CPU (the velocity
# heads): within TRAIN_BN_ATOL + TRAIN_BN_RTOL |x|; counters equal
TRAIN_BN_ATOL, TRAIN_BN_RTOL = 1e-6, 1e-5
# Configuration A's step amplifies the card's rounding in its head
# (train-mode BatchNorm over a nearly flat depth map, leaky-ReLU kinks):
# its worst gradient leaf reads 43 times the gradient bound in f32 and
# 3,419 in TF32, the joint model's 0.25 and 30.1 (PERF.md §6).  So its
# step is held to every bound above in f64, card against CPU, and in f32
# to the bounds of the readings that amplification leaves alone (a TF32
# step must fail those); the f32 gradients and updates are logged
HEADS_F32_CHECKED = ("loss", "terms", "gradnorm", "uv", "bn")

# tolerances: the JAX package's own bounds for the TPU kernels
# (tests/test_fused_voxelizer.py:34,68, tests/test_lstm_pallas.py:53,79) and
# the velocity bound of the port's tests; K1's counts are exact
K2_ATOL, K3_ATOL, K4_ATOL, K4_ATOL_CARRIED, VEL_ATOL = 2e-5, 3e-5, 2e-5, 3e-5, 1e-4

# the model zoo served: each model's parameter count
# (evfly_tpu/models/vitfly.py's docstrings; LegacyTransformer's from its
# layers at its defaults), weights from ZOO_SEED + its index
ZOO = {"ConvNet": 235_269, "LSTMNet": 2_949_937, "ViT": 3_101_199,
       "UNetConvLSTMNet": 2_955_822, "LegacyTransformer": 353_283}
ZOO_SEED = 40
# the dataset path: a Prophesee-like recording (640x480, ns epoch
# stamps, {0, 1} polarity) of REC_FRAMES depth frames at 30 Hz (3 s), a
# grating of REC_EDGES edges at REC_SPEED px/s, REC_ROWS events at each
# column an edge crosses: 8 x 300 x 400 = 960,000 events/s; K1 over time
# windows checked and timed on a DAVIS-like stream of DAVIS_EVENTS events
# at 260x346 over DAVIS_WINDOWS windows of 1/30 s
REC_H, REC_W, REC_FRAMES = 480, 640, 91
HD_H, HD_W = 720, 1280  # the 1280x720 Prophesee sensor (IMX636)
REC_EDGES, REC_SPEED, REC_ROWS = 8, 300.0, 400
DAVIS_EVENTS, DAVIS_WINDOWS = 2_000_000, 60
# event generation: one trajectory of GEN_FRAMES frames at 260x346
# (the training phase's length), a texture translating at GEN_SPEEDS px a
# frame, so that adaptive_factor takes every factor from 1 to 16
GEN_FRAMES, GEN_DT = 49, 1.0 / 30.0
GEN_SPEEDS = np.linspace(0.5, 15.9, GEN_FRAMES)
# a frame of ESIM or difflog may differ card against CPU only where the
# CPU's quotient came within GEN_MARGIN of an integer (FLOW_MARGIN on
# flow-upsampled frames), by one quantum, the sums within 1e-5 + a quantum
GEN_MARGIN, FLOW_MARGIN = 1e-5, 1e-3
# the closed loop: CL_STREAMS trials in lockstep in forests of
# generate_forest's 60 trees (seeds CL_SEED + g), the policy every 6 sim
# steps, at most CL_MAX_STEPS sim steps (24 s: 60 m at 2.5 m/s); the first
# CL_CHECK_TICKS ticks held against single eager streams, CL_RENDER_VIEWS
# views of one tick held against the CPU; STATE_TRIALS state-mode trials of
# STATE_STEPS steps; EVAL_TRIALS vision trials of run_evaluation
CL_STREAMS, CL_SEED, CL_POLICY_EVERY, CL_MAX_STEPS = 16, 60, 6, 2400
CL_CHECK_TICKS, CL_RENDER_VIEWS = 4, 4
STATE_TRIALS, STATE_STEPS = 3, 2000
EVAL_TRIALS, EVAL_STEPS = 2, 2000
# PPO at tools/train_rl.py's scale: 100 envs, rollouts of 128, PPO_ITERS
# timed iterations after one; one iteration held card against CPU, with
# the quadrotor's rollout cut to 32 steps: its attitude under random thrusts
# is chaotic (a 1e-6 change of the weights moves its states by 6.5e-4 over
# 128 steps, by 2.6e-5 over 32; the VisionEnv's by 1.2e-5 over 128)
PPO_ENVS, PPO_ROLLOUT, PPO_ITERS = 100, 128, 3
PPO_HOLD_ROLLOUT = {"vision": 128, "quadrotor": 32}

# the drivers (evfly_tpu_torch/tools), each through its own functions:
# the protocol evaluation at the JAX record's settings
# (artifacts/eval_final_v2.json: policy_best.pth, 40 trials in batches of
# 20, seed 91000, desvel 4, first-order dynamics; 40 of 40 successful):
# at least PROTOCOL_MIN_SUCCESS (a true rate of 0.975 falls below 36 of 40
# with a chance of about 0.3%, a broken policy path crashes most trials);
# the first CL_CHECK_TICKS ticks of the first batch (G = 20: 160 CTAs of
# K4's cluster route in waves over 132 SMs) held against single eager
# streams in the driver's TF32 within PROTOCOL_TF32_ATOL, and a G = 20 graph
# replay of the same frames in f32 against f32 single streams within VEL_ATOL
PROTOCOL_TRIALS, PROTOCOL_BATCH, PROTOCOL_SEED, PROTOCOL_MIN_SUCCESS = 40, 20, 91000, 36
# TF32 rounds a product's inputs to 10 mantissa bits (2^-11 relative): the
# batched and single convolutions may take other cuDNN algorithms, each
# rounding on its own, through the UNet and the ViT to a tanh-bounded
# velocity (x desvel 4); 2.75e-4 measured on an H100 (f32: 5.2e-7)
PROTOCOL_TF32_ATOL = 2e-3
# DAgger at DAGGER_TRIALS in one batch, datagen in state mode at
# DATAGEN_TRIALS in one batch with the flow of FLOW_TRAJS trajectories,
# all handed to cache_dataset with the joint configuration's dataloader
# arguments; e2e_demo at E2E_ARGS (its data through cache_dataset)
DAGGER_TRIALS, DATAGEN_TRIALS, FLOW_TRAJS = 4, 8, 2
E2E_ARGS = ["--trials", "2", "--epochs", "1", "--eval_trials", "1"]
# train_rl at RL_ITERS iterations of 100 envs x 128; greedy_rollout of
# RL_HOLD_ENVS envs on the card against the CPU from the same weights and
# starts, VisionEnv over the driver's horizon, QuadrotorEnv cut to 32 steps
# (PPO_HOLD_ROLLOUT): positions and returns within RL_ATOL
# (tests/test_torch_tools_rl.py's bound), alive equal
RL_ITERS, RL_HOLD_ENVS, RL_ATOL = 2, 16, 1e-4
# hil_real_model with policy_best.pth (the record's joint_final.pth does
# not ship): HIL_DRIVER_SECONDS at seed 77; no collision, no guard stop,
# past HIL_MIN_X metres (the JAX record reached 29.2 m with its checkpoint)
HIL_DRIVER_SECONDS, HIL_SEED, HIL_MIN_X = 8.0, 77, 20.0
# the two reports at their defaults against the JAX records
# (artifacts/esim_divergence.json, upsample_report.json, made by the JAX
# package on the CPU): the CPU test holds each metric within 4 s max(|m|,
# 1), s the share of pixel-windows whose counts differ between the
# packages (all at render edges or quantization crossings), 0.019 at 48x64
# over 10 frames; render edges flag 0.2-2% of a 260x346 frame (PERF.md §6), so
# at full size REPORT_SHARE; quantiles and maxima of counts, adaptive
# factors within one step
REPORT_SHARE = 0.02

# the probes (overfit_probe, openloop_probe, bf16_accept) on the DAgger
# trajectories of the DAgger -> data -> training phase: the open-loop probe
# over a trajectory's first PROBE_FRAMES frames, carried and reset every
# PROBE_CHUNK, its first PROBE_HELD frames held against the CPU (1e-4 at
# full f32, PROBE_TF32_ATOL at the tool's TF32, PROTOCOL_TF32_ATOL's
# reasoning); the bf16 A/B at the tool's 256 windows
PROBE_FRAMES, PROBE_CHUNK, PROBE_HELD = 64, 16, 8
OVERFIT_STEPS = 150  # the overfit probe's defaults: 150 steps, 192 frames, chunks of 32
PROBE_TF32_ATOL = 2e-3

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
    name = next((n for n in ("lstm_cluster_kernel", "lstm_grid_kernel", "lstm_stacked_kernel",
                             "lstm_wavefront_kernel", "hist_scaled_cluster_kernel",
                             "hist_frame_cluster_kernel", "hist_band_partition_kernel",
                             "hist_band_kernel",
                             "scale_counts_cluster_kernel", "empty_kernel")
                 if n in mangled), mangled)
    m = re.search(r"ILi(\d+)ELb([01])E", mangled)
    if m:
        name += f"<H={m.group(1)}, {'wavefront' if m.group(2) == '1' else 'stacked'}>"
    elif (m := re.search(r"lstm_grid_kernelILb([01])E", mangled)):
        name += "<wavefront>" if m.group(1) == "1" else "<stacked>"
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
    shapes = [(h, w) for h in (1, 7, 64, 260, 480, 720, 1080) for w in (1, 86, 346, 640, 1280,
                                                                       1920)]
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
        # K1's route and its cluster size, and the band route's band
        for two_pass in (False, True):
            if k1_route(h, w, two_pass).cluster != lib.evfly_hist_frame_route(h, w, int(two_pass)):
                differ.append(("K1 route", h, w, two_pass))
            if band_route_cells(h, w, two_pass) != \
                    lib.evfly_hist_band_cells(h, w, int(two_pass)):
                differ.append(("K1 band", h, w, two_pass))
    n_cases = len(shapes) * (5 * 6 + 4)
    log(f"cluster route rules: Python and csrc/voxelizer.cu agree on "
        f"{n_cases - len(differ)} of {n_cases} cases; K3's cap at {H}x{W} -> {H_OUT}x{W_OUT}: "
        f"{resized_cluster_cap(H, W, H_OUT, W_OUT)} events per window on {K3_CLUSTER} CTAs; "
        f"K2's at {H}x{W}: {scaled_cluster_cap(H, W)} on {K2_CLUSTER} CTAs; K1's routes: "
        + ", ".join(f"{h}x{w} {'two' if tp else 'one'} threshold(s) {k1_route(h, w, tp)}"
                    for h, w in ((260, 346), (480, 640), (720, 1280), (1080, 1920))
                    for tp in (False, True)))
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


def _k1_cases(dev, h, w):
    """(label, events, thresholds) of K1's checks at h x w."""
    cases = []
    ex, ey, ep = make_events(10, 1, N_EVENTS, dev, h, w)
    cases.append(("5,000 uniform events", (ex, ey, ep), (0.2, 0.2)))
    cases.append(("pos 0.2 / neg 0.3", (ex, ey, ep), (0.2, 0.3)))
    bx, by, bp = make_events(11, 1, BIG_EVENTS, dev, h, w)
    bx[:, :HOT_EVENTS], by[:, :HOT_EVENTS], bp[:, :HOT_EVENTS] = 100.5, 130.5, 1
    cases.append((f"{BIG_EVENTS:,} events, {HOT_EVENTS:,} on one pixel", (bx, by, bp),
                  (0.2, 0.2)))
    cases.append((f"{BIG_EVENTS:,} events, two-pass", (bx, by, bp), (0.2, 0.3)))
    mx, my, mp = make_events(14, N_WINDOWS, N_EVENTS, dev, h, w)
    cases.append((f"{N_WINDOWS} windows x {N_EVENTS:,} events", (mx, my, mp), (0.2, 0.2)))
    # a window of 4,999 events: the slices of the windows after the first
    # start off 16-byte alignment
    ox, oy, op = make_events(17, 3, N_EVENTS - 1, dev, h, w)
    cases.append((f"3 windows x {N_EVENTS - 1:,} events, two-pass", (ox, oy, op), (0.2, 0.3)))
    return cases


def _k1_bincount(x, y, p, h, w, thresholds):
    """torch.bincount over the (B, N) events' (window, cell) keys, weights
    +pos/-neg (the sign times pos with one threshold): one library call
    computing K1's frame, its f32 sums in another order."""
    xi, yi, sign = bin_events(x, y, p, h, w)
    keys = (torch.arange(x.shape[0], device=x.device)[:, None] * (h * w) + yi * w + xi).ravel()
    weights = (sign * torch.where(sign > 0, thresholds[0], thresholds[1])).ravel()
    return lambda: torch.bincount(keys, weights, minlength=x.shape[0] * h * w)


def phase_k1(dev, flush):
    """K1 on each route exactly equal to its plain version in every case:
    at 260x346 the 8-CTA cluster kernel and the band route, at 640x480 and
    1280x720 the route each shape takes (16 CTAs with two thresholds at
    640x480 and one at 1280x720, the band route with two at 1280x720) and
    the band route; old and new timed in turns at the streaming path's
    shape (1 x 5,000) and the batch shape (256 x 5,000), beside the
    empty-launch floor; the cluster size swept.  Shape C (one window of
    5,000 events, two thresholds, through ``event_histogram``) at 640x480
    and 1280x720 on each route, in turns, beside torch.bincount and the
    bound; each route's launches through the entry point; the 16-CTA
    clusters resident at once."""
    errs = {"cluster8": 0.0, "cluster16": 0.0, "band": 0.0}
    for h, w in ((H, W), (REC_H, REC_W), (HD_H, HD_W)):
        for label, events, thresholds in _k1_cases(dev, h, w):
            ref = hist_frame_plain(*events, h, w, *thresholds)
            route = str(k1_route(h, w, thresholds[0] != thresholds[1]))
            bad = {}
            for name, kernel in ((route, hist_frame_routed), ("band", hist_frame)):
                got = kernel(*events, h, w, *thresholds)
                torch.cuda.synchronize()
                bad[name] = int((got != ref).sum().item())
                errs[name] = max(errs[name], (got - ref).abs().max().item())
                require(got.shape == ref.shape and bool(torch.isfinite(got).all()), "K1 output")
            log(f"K1 {h}x{w} {label}: cells that differ from plain, of {ref.numel()}: {bad}; "
                f"max|frame| {ref.abs().max().item():.1f}")
            require(not any(bad.values()), f"K1 disagrees with its plain version ({label})")
    ex, ey, ep = make_events(10, 1, N_EVENTS, dev)
    mx, my, mp = make_events(14, N_WINDOWS, N_EVENTS, dev)

    lib, stream = _build.library(), _build.stream_of(dev)
    empty = {c: time_ms(lambda: _build.check("evfly_empty", lib.evfly_empty(c, stream)), flush,
                        20) for c in (1, K1_CLUSTER, K1_WIDE_CLUSTER)}
    log(f"empty kernel, the floor of one launch: {empty[1]:.4f} ms (1 block), "
        f"{empty[K1_CLUSTER]:.4f} ms (a cluster of {K1_CLUSTER} CTAs), "
        f"{empty[K1_WIDE_CLUSTER]:.4f} ms ({K1_WIDE_CLUSTER} CTAs)")
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
        log(f"K1 times {B} x {N_EVENTS} events at {H}x{W}, in turns band, cluster, cluster, "
            f"band: band route {turns['band'][0]:.4f} / {turns['band'][1]:.4f} ms, cluster "
            f"{turns['cluster'][0]:.4f} / {turns['cluster'][1]:.4f} ms; bound {b_ms:.6f} ms "
            f"({b_by}); cluster sizes: "
            + ", ".join(f"{c} CTAs {t:.4f} ms" for c, t in sweep.items()))
        results[B] = dict(turns=turns, bound_ms=b_ms, bound_by=b_by)
    for kind in ("k1", "k1_two_pass"):
        log(f"K1 cluster kernel ({kind}) at {H}x{W}: {vox_cluster_occupancy(kind, H, W)} "
            f"clusters of {K1_CLUSTER} CTAs resident at once")
    # the 16-CTA route's shapes: a non-portable cluster, one CTA per SM
    for kind, h, w in (("k1_two_pass", REC_H, REC_W), ("k1", HD_H, HD_W)):
        resident = vox_cluster_occupancy(kind, h, w, cluster=K1_WIDE_CLUSTER)
        log(f"K1 cluster kernel ({kind}) at {h}x{w}: {resident} clusters of "
            f"{K1_WIDE_CLUSTER} CTAs resident at once")
        require(resident > 0, f"no {K1_WIDE_CLUSTER}-CTA cluster of K1 ({kind}) at {h}x{w} "
                              f"fits the card")

    xi, yi, sign = bin_events(ex, ey, ep, H, W)
    idx = (yi * W + xi)[0]
    plain_ms = time_ms(lambda: hist_frame_plain(ex, ey, ep, H, W), flush, 10)
    library_ms = time_ms(lambda: torch.bincount(idx, weights=sign[0], minlength=H * W),
                         flush, 10)
    log(f"K1 at 1 x {N_EVENTS}: plain {plain_ms:.4f} ms, torch.bincount {library_ms:.4f} ms")
    one = results[1]
    entries = {"cluster8": dict(max_abs_err=errs["cluster8"],
                                ms=statistics.mean(one["turns"]["cluster"]), plain_ms=plain_ms,
                                bound_ms=one["bound_ms"], bound_by=one["bound_by"],
                                library_ms=library_ms)}

    # shape C: one window of 5,000 events, two thresholds, each route in
    # turns, and each route's launches through event_histogram
    launches = {}
    for h, w, thresholds, turns_of in (
            (REC_H, REC_W, (0.2, 0.3), ("cluster16", "band", "band", "cluster16")),
            (HD_H, HD_W, (0.2, 0.3), ("band", "cluster16", "cluster16", "band"))):
        cx, cy, cp = make_events(10, 1, N_EVENTS, dev, h, w)
        # at 1280x720 the 16-CTA route holds one threshold only
        forced = {"cluster16": (0.2, 0.2) if h == HD_H else thresholds, "band": thresholds}
        fns = {"cluster16": lambda t=forced["cluster16"]: _frame_cluster_launch(
                   cx, cy, cp, h, w, *t, K1_WIDE_CLUSTER),
               "band": lambda: hist_frame(cx, cy, cp, h, w, *thresholds)}
        turns = in_turns(fns, turns_of, flush)
        route = str(k1_route(h, w, True))
        hist_frame.launches = hist_frame_cluster.launches = 0
        hist_frame_cluster.by_route.clear()
        for t in {thresholds, (0.2, 0.2)}:
            frame = event_histogram(cx[0], cy[0], cp[0], h, w, *t, device=dev)
            torch.cuda.synchronize()
            require(torch.equal(frame, hist_frame_plain(cx, cy, cp, h, w, *t)[0]),
                    f"event_histogram at {h}x{w}, thresholds {t}, disagrees with plain")
        launches[(h, w)] = {"band": hist_frame.launches, **hist_frame_cluster.by_route}
        plain_c = time_ms(lambda: hist_frame_plain(cx, cy, cp, h, w, *thresholds), flush, 10)
        lib_c = time_ms(_k1_bincount(cx, cy, cp, h, w, thresholds), flush, 10)
        # each event read once, the frame written once; per event one add,
        # per cell two multiplies and a subtract
        b_c, by_c = bound_ms(12 * N_EVENTS + 4 * h * w, N_EVENTS + 3 * h * w)
        log(f"K1 shape C, 1 x {N_EVENTS} events at {h}x{w}, thresholds {thresholds} (route "
            f"{route}), in turns {', '.join(turns_of)}: "
            + "; ".join(f"{r} " + " / ".join(f"{v:.4f}" for v in turns[r]) + " ms"
                        + (" (one threshold)" if forced[r] != thresholds else "")
                        for r in dict.fromkeys(turns_of))
            + f"; plain {plain_c:.4f} ms; torch.bincount with weights +pos/-neg {lib_c:.4f} ms; "
            f"bound {b_c:.6f} ms ({by_c}); launches through event_histogram "
            f"{launches[(h, w)]}")
        entries[route] = dict(max_abs_err=errs[route], ms=statistics.mean(turns[route]),
                              plain_ms=plain_c, bound_ms=b_c, bound_by=by_c, library_ms=lib_c)
    require(launches[(REC_H, REC_W)] == {"band": 0, "cluster16": 1, "cluster8": 1}
            and launches[(HD_H, HD_W)] == {"band": 1, "cluster16": 1},
            f"event_histogram did not take the routes of its shapes: {launches}")
    entries["cluster16"]["launches"] = launches[(REC_H, REC_W)].get("cluster16", 0)
    entries["band"]["launches"] = launches[(HD_H, HD_W)]["band"]
    return entries


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
    ("stacked", "grid"): ("K4 grid", lstm_stacked_grid, lstm_stacked_grid_plain),
    ("wavefront", "grid"): ("K5 grid", lstm_wavefront_grid, lstm_wavefront_grid_plain),
}


def _route_weights(packed, route):
    """A route's weight arguments from ``lstm_fused.pack``'s result."""
    if route in ("cluster", "grid"):
        return getattr(packed, route), packed.bias
    return packed.whh_t, packed.wih_t, packed.bias


@contextlib.contextmanager
def forced_voxel_routes():
    """K1 takes its band route where the shape would pick its cluster
    kernel, for driving a path through it in this script; the port itself
    always routes by shape."""
    k1 = voxelizer.k1_route
    voxelizer.k1_route = lambda h, w, two_pass: BAND_ROUTE
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


def _lstm_problem(dev, seed, G, T, hidden=HID, layers=L, inputs=IN):
    """cuDNN's LSTM (the yardstick only) and, from its weights, the kernels'
    packed layouts (the grid layout wherever the grid kernel takes the
    shape, for forcing it), layer-0 gates (G, T, 4H) and a carried state
    (G, L, H)."""
    gen = torch.Generator().manual_seed(seed)
    b = 1.0 / hidden ** 0.5
    lstm = torch.nn.LSTM(inputs, hidden, layers)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.empty_like(p).uniform_(-b, b, generator=gen))
    lstm = lstm.to(dev)
    params = {k: v.detach() for k, v in lstm.named_parameters()}
    x = torch.randn(G, T, inputs, generator=gen).to(dev)
    h0 = (torch.randn(G, layers, hidden, generator=gen) * 0.5).to(dev)
    c0 = (torch.randn(G, layers, hidden, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        xp0 = x @ params["weight_ih_l0"].T + params["bias_ih_l0"] + params["bias_hh_l0"]
    packed = pack(params, layers, hidden)
    if packed.grid is None and grid_fits(hidden, layers):
        packed = packed._replace(grid=pack_grid(packed.whh_t, packed.wih_t, hidden, layers))
    return lstm, x, xp0, packed, h0, c0


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


_STALLED_BARRIER = """
import sys, torch
sys.path.insert(0, {repo!r})
from evfly_tpu_torch.ops import _build
H, L, G, T = 768, 1, 1, 2
dev = torch.device("cuda")
z = lambda *s: torch.zeros(*s, device=dev)
wgr, xp0, h0 = z(H // 8, 1, 32 * H), z(G, T, 4 * H), z(G, L, H)
out, hn, cn, hx = z(G, T, H), z(G, L, H), z(G, L, H), z(2, G, L, H)
# the barrier's count starts 2**31 behind the arrivals it waits for
arrivals = torch.tensor([-2**31], dtype=torch.int32, device=dev)
status = _build.library().evfly_lstm_grid(
    xp0.data_ptr(), wgr.data_ptr(), 0, h0.data_ptr(), h0.data_ptr(), out.data_ptr(),
    hn.data_ptr(), cn.data_ptr(), hx.data_ptr(), arrivals.data_ptr(), G, T, H, L, 0,
    torch.cuda.current_stream().cuda_stream)
print("launch status", status, flush=True)
torch.cuda.synchronize()
print("NO TRAP", flush=True)
"""


def stalled_barrier_run(timeout: float = 120.0):
    """The grid kernel (K4, H = 768, T = 2: one barrier) launched in a child
    process with a barrier that never opens: (exit code, output, seconds).
    Its spin-wait must end in __trap(), which the child's synchronize
    reports; the trap leaves that process's CUDA context unusable, hence the
    child.  The library is built first, here."""
    _build.library()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _STALLED_BARRIER.format(repo=REPO)],
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


def phase_lstm_routes(dev):
    """K4 and K5 on their three routes against their plain versions, at the
    serving length, the wavefront's short corners and 16 streams; the route
    each other shape takes, the Python rules against the library's; how many
    clusters and grid CTAs fit the card."""
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
        # layer, the grid with three; with four it takes the L2 route
        for hidden, layers, route in ((256, 1, "cluster"), (256, 3, "grid"), (256, 4, "l2")):
            require(choose_route(hidden, layers) == route, f"route of H={hidden} L={layers}")
            _, _, xp0, packed, h0, c0 = _lstm_problem(dev, 30 + layers, 3, 5, hidden, layers)
            for mode in ("stacked", "wavefront"):
                name, kernel, plain = LSTM_ROUTES[(mode, route)]
                err = _check_lstm(name, kernel, plain, xp0, _route_weights(packed, route),
                                  h0, c0)
                errs[(mode, route)] = max(errs[(mode, route)], err)
    # the route rules of lstm_fused against the library's own (csrc/lstm.cu)
    lib = _build.library()
    shapes = [(h, l) for h in (64, 128, 192, 256, 384, 512, 640, 768, 1024, 1152)
              for l in range(1, 9)]
    routes = ("l2", "cluster", "grid")
    differ = [s for s in shapes
              if cluster_fits(*s) != bool(lib.evfly_lstm_cluster_fits(*s))
              or grid_fits(*s) != bool(lib.evfly_lstm_grid_fits(*s))
              or choose_route(*s) != routes[lib.evfly_lstm_route(*s)]]
    log(f"route rules: Python and csrc/lstm.cu agree on {len(shapes) - len(differ)} "
        f"of {len(shapes)} (H, L) shapes; cluster route: "
        f"{[s for s in shapes if choose_route(*s) == 'cluster']}; grid route: "
        f"{[s for s in shapes if choose_route(*s) == 'grid']}")
    require(not differ, f"the route rules disagree with csrc/lstm.cu at {differ}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for hidden, layers in ((HID, L), (256, 3), (HEAD_H, 1)):
        for mode in ("stacked", "wavefront"):
            per_sm = grid_occupancy(hidden, layers, mode)
            log(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor, grid {mode} H={hidden} "
                f"L={layers}: {per_sm} CTAs per SM x {sms} SMs for {hidden // 8} CTAs")
            require(per_sm * sms >= hidden // 8, f"the {mode} grid at H={hidden} is not resident")
    rc, text, secs = stalled_barrier_run()
    log(f"grid kernel with a barrier that never opens, in a child process: exit code {rc} "
        f"after {secs:.1f}s; its last words: {text.strip().splitlines()[-1][:160]!r}")
    require(rc != 0 and "launch status 0" in text and "NO TRAP" not in text,
            "a stalled grid barrier did not trap")
    for hidden, layers in ((HID, L), (256, 1)):
        for mode in ("stacked", "wavefront"):
            clusters = cluster_occupancy(hidden, layers, mode)
            log(f"cudaOccupancyMaxActiveClusters, {mode} H={hidden} L={layers}: "
                f"{clusters} clusters of 8 CTAs")
            require(clusters > 0, f"no cluster of the {mode} kernel fits the card")
    return errs


def _lstm_times(dev, flush, seed, G, T_, hidden, layers, inputs, order, plain_routes=()):
    """K4 and K5 at (G, T, H, L) on the routes of ``order`` (e.g. old, new,
    new, old) timed in its turns, beside cuDNN's LSTM, the bound and the
    plain versions of ``plain_routes``: mode -> {route: mean ms, "turns":
    {route: [ms, ...]}, "library_ms", "bound_ms", "bound_by",
    "plain_<route>"}."""
    lstm, x, xp0, packed, h0, c0 = _lstm_problem(dev, seed, G, T_, hidden, layers, inputs)
    # cuDNN's LSTM takes (T, G, in) with (L, G, H) states
    xs, hs, cs = (t.transpose(0, 1).contiguous() for t in (x, h0, c0))
    library_ms = time_ms(lambda: lstm(xs, (hs, cs)), flush, 10)
    # each input read once (the weights in the L2 layout), each output written once
    n_bytes = sum(t.numel() * 4 for t in (xp0, packed.whh_t, packed.wih_t, packed.bias, h0,
                                           c0)) + (G * T_ * hidden + 2 * G * layers * hidden) * 4
    n_flops = 2 * G * T_ * hidden * 4 * hidden * (2 * layers - 1)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    times = {}
    for mode in ("stacked", "wavefront"):
        turns = {route: [] for route in order}
        for route in order:
            _, kernel, _ = LSTM_ROUTES[(mode, route)]
            w = _route_weights(packed, route)
            turns[route].append(time_ms(lambda: kernel(xp0, *w, h0, c0), flush, 10))
        entry = dict(library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, turns=turns,
                     **{r: statistics.mean(v) for r, v in turns.items()})
        for route in plain_routes:
            _, _, plain = LSTM_ROUTES[(mode, route)]
            w = _route_weights(packed, route)
            entry[f"plain_{route}"] = time_ms(lambda: plain(xp0, *w, h0, c0), flush,
                                              3 if T_ > 1 else 10, warmup=1)
        times[mode] = entry
        log(f"{'K4' if mode == 'stacked' else 'K5'} times H={hidden} L={layers} G={G} T={T_}, "
            f"in turns {', '.join(order)}: "
            + "; ".join(f"{r} " + " / ".join(f"{v:.4f}" for v in turns[r]) + " ms"
                        for r in dict.fromkeys(order))
            + f"; torch.nn.LSTM {library_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by}, {n_bytes} "
            f"bytes)" + "".join(f"; plain ({r}) {entry[f'plain_{r}']:.4f} ms"
                                for r in plain_routes))
    return times


def phase_lstm_times(dev, flush):
    """K4 and K5 timed in turns (L2, cluster, grid, grid, cluster, L2) at
    the serving LSTM's shape (H = 128, L = 3: the grid route forced there)
    at each (G, T) of LSTM_TIMED, and at H = 256, L = 3 (L2, grid, grid,
    L2) at GRID_256_TIMED, beside cuDNN's LSTM and the bound; the plain
    versions (of each route's layout) at the shapes of the kernels' JSON
    entries."""
    times = {}
    with torch.no_grad():
        for G, T_ in LSTM_TIMED:
            entry_shape = (G, T_) in ((1, N_WINDOWS), (1, 1))
            by_mode = _lstm_times(dev, flush, 40 + G + T_, G, T_, HID, L, IN, KERNEL_TURNS,
                                  ("l2", "cluster", "grid") if entry_shape else ())
            times.update({(mode, G, T_): t for mode, t in by_mode.items()})
        for G, T_ in GRID_256_TIMED:
            by_mode = _lstm_times(dev, flush, 50 + G + T_, G, T_, 256, 3, 256,
                                  ("l2", "grid", "grid", "l2"), ("grid",))
            times.update({(mode, G, T_, 256): t for mode, t in by_mode.items()})
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


def phase_main_path(dev):
    """The serving path through K3 and K4 on the cluster route, against its
    plain path; its launches, and the L2 route's with its LSTM forced there."""
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

        # the same path with its LSTM forced onto the L2 route: its launches
        with forced_route("l2"):
            lstm_stacked.launches = lstm_stacked_cluster.launches = 0
            step()
            torch.cuda.synchronize()
        l2_launches = {"K4 L2": lstm_stacked.launches}
        require(lstm_stacked.launches > 0 and lstm_stacked_cluster.launches == 0,
                "the L2 route did not run")
    return launches, l2_launches


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
    carried, in each LSTM mode, its route (cluster) and the L2 route forced,
    and each percentile mode, against the plain path (plain K1,
    set_fused_lstm(False)) on the same model."""
    windows = stream_windows(dev, STREAM_WINDOWS)
    launches = {}
    lstm = model.vitfly_vitlstm.lstm
    kernels = LSTM_KERNELS
    for (mode, route), (key, kernel, _) in LSTM_ROUTES.items():
        if route == "grid":  # the joint model's (128, 3) packs no grid layout
            continue
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
    # once more with K1's band route: its launches, the outputs as the
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
    log(f"streaming with K1's band route: {hist_frame.launches} launches (cluster kernel "
        f"{n_cluster} in the run beside it); velocity and depth max|diff| vs the cluster "
        f"kernel's {berr:.3e}")
    require(hist_frame.launches > 0 and n_cluster == hist_frame.launches,
            "K1's band route did not run")
    require(berr <= VEL_ATOL, "the streaming path through K1's band route disagrees")
    lstm.mode = None
    return launches


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


def phase_profile(step, kernel_names, label, grad=False):
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
    of FEW_EVENTS events at SMALL_H x SMALL_W, through every K1 route:
    (B, N) windows through the entry's route (the 8-CTA cluster kernel,
    windows x 8 CTAs on grid.x), on 16 CTAs and on the band route, and the
    same windows as offsets into one stream through the window launch on
    each route: exactly equal to plain."""
    ex, ey, ep = make_events(13, MANY_WINDOWS, FEW_EVENTS, dev, SMALL_H, SMALL_W)
    ref = hist_frame_plain(ex, ey, ep, SMALL_H, SMALL_W)
    hist_frame_cluster.launches = 0
    begin = torch.arange(MANY_WINDOWS, device=dev, dtype=torch.int64) * FEW_EVENTS
    stream = tuple(t.reshape(-1) for t in (ex, ey, ep))
    runs = [("routed", lambda: hist_frame_routed(ex, ey, ep, SMALL_H, SMALL_W)),
            ("cluster16", lambda: _frame_cluster_launch(ex, ey, ep, SMALL_H, SMALL_W, 0.2, 0.2,
                                                        K1_WIDE_CLUSTER)),
            ("band", lambda: hist_frame(ex, ey, ep, SMALL_H, SMALL_W))]
    runs += [(f"windows {r}", lambda r=r: _frame_windows_launch(
                 *stream, begin, begin + FEW_EVENTS, SMALL_H, SMALL_W, 0.2, 0.2, r))
             for r in (K1Route("cluster", K1_CLUSTER), K1Route("cluster", K1_WIDE_CLUSTER),
                       BAND_ROUTE)]
    for name, run in runs:
        got = run()
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


class RouteLaunches:
    """One K1 route's launches through a wrapper that takes several (its
    ``by_route`` counter), read and set as ``launches``, as a wrapper's."""

    def __init__(self, wrapper, route: str):
        self.wrapper, self.route = wrapper, route

    @property
    def launches(self) -> int:
        return self.wrapper.by_route[self.route]

    @launches.setter
    def launches(self, n: int) -> None:
        self.wrapper.by_route[self.route] = n


LSTM_KERNELS = tuple(kernel for _, kernel, _ in LSTM_ROUTES.values())
# every kernel wrapper, and every K1 route of a wrapper that takes several,
# by the names of the kernels' JSON entries
KERNELS = {"K1 cluster": hist_frame_cluster, "K1 band": hist_frame,
           "K1 cluster8": RouteLaunches(hist_frame_cluster, "cluster8"),
           "K1 cluster16": RouteLaunches(hist_frame_cluster, "cluster16"),
           "K1 windows": hist_frame_windows,
           **{f"K1 windows {r}": RouteLaunches(hist_frame_windows, r)
              for r in ("cluster8", "cluster16", "band")},
           "K2": hist_scaled,
           "K3": hist_scaled_resized, "scale_counts": scale_counts,
           "scale_counts_resized": scale_counts_resized, "K4 L2": lstm_stacked,
           "K5 L2": lstm_wavefront, "K4 cluster": lstm_stacked_cluster,
           "K5 cluster": lstm_wavefront_cluster, "K4 grid": lstm_stacked_grid,
           "K5 grid": lstm_wavefront_grid}


def _served(head, calls: int, k4: int) -> bool:
    """Whether V(phi) (``head``, an ``LSTMNetVIT``) served ``calls`` forwards
    by its CUDA graphs and K4's ``k4`` launches are those of its captures:
    WARMUP_STEPS + 1 each, none at a replay."""
    stats = head.serve_stats
    return (sum(stats.steps.values()) == calls
            and k4 == (WARMUP_STEPS + 1) * sum(stats.captures.values()))


def _recording_run_model(learner, records):
    """Wrap learner.run_model: each trajectory's mode, whether it trained,
    loss, terms, frames, synchronized seconds and the launches of each LSTM
    kernel (K4/K5, every route) during it."""
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


def _joint_from_policy_best(d):
    model = OrigUNet_w_VITFLY_ViTLSTM(device=d, **JOINT_CONFIG)
    return model.load_params(load_state_dict(JOINT_CHECKPOINT))


def _train_step_once(d, batch, make_model=_joint_from_policy_best, kind="joint_vitlstm",
                     dtype=torch.float32):
    """One train step of ``make_model(d)`` (the joint model from
    policy_best.pth) on device ``d`` in ``dtype``, no augmentation, no
    dropout: its loss, logged terms, gradient norm, gradients and the state
    before and after, on the CPU."""
    model = make_model(d).to(dtype)
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN_CONFIG["lr"], betas=(0.9, 0.999),
                           eps=1e-8)
    step = stepfn.make_train_step(model, kind, opt, TRAIN_CONFIG["loss_weights"],
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
    is_bn = lambda k: k.endswith(("running_mean", "running_var", "num_batches_tracked"))
    uv = max([(got["after"][k] - v).abs().max().item() for k, v in ref["after"].items()
              if k not in ref["grads"] and not is_bn(k)], default=0.0)

    def bn_reading(a, v):
        """A BatchNorm buffer over its bound: the running stats within
        TRAIN_BN_ATOL + TRAIN_BN_RTOL |x|, the counter exactly."""
        if not v.is_floating_point():
            return 0.0 if torch.equal(a, v) else float("inf")
        return ((a - v).abs() / (TRAIN_BN_ATOL + TRAIN_BN_RTOL * v.abs())).max().item()

    bn = max([bn_reading(got["after"][k], v) for k, v in ref["after"].items() if is_bn(k)],
             default=0.0)
    worst = lambda d, key: sorted(d.items(), key=lambda kv: -key(kv[1]))[:3]
    return dict(loss=rel(got["loss"], ref["loss"]) / TRAIN_RTOL,
                terms=max(((got["values"] - ref["values"]).abs()
                           / ref["values"].abs().clamp_min(1.0)).tolist()) / TRAIN_RTOL,
                gradnorm=rel(got["gn"], ref["gn"]) / TRAIN_RTOL,
                grads=max(grad.values()), update=max(v[0] for v in step.values()),
                uv=uv / TRAIN_UV_TOL, bn=bn, small_share=small / n,
                worst_grads=worst(grad, float),
                worst_update=worst(step, lambda v: v[0]))


def _card_vs_cpu_step(dev, batch, *model_and_kind):
    """One train step (of the joint model, or ``make_model`` and ``kind``)
    on the card and on the CPU, same chunk: the card's readings against the
    CPU's, the same readings of a step in TF32 on the card, and the CPU's
    step (``_train_step_once``)."""
    ref = _train_step_once(torch.device("cpu"), batch, *model_and_kind)
    errs = _step_errors(_train_step_once(dev, batch, *model_and_kind), ref)
    saved = get_precision()
    set_precision("tf32")
    try:
        tf32 = _step_errors(_train_step_once(dev, batch, *model_and_kind), ref)
    finally:
        set_precision(saved)
    return errs, tf32, ref


def _validation_vs_plain(learner, run_model, kernel):
    """The Learner's validation pass over its val trajectories with the
    fused LSTM (after one warm-up pass) and with the plain loop: the max
    |diff| / max(1, |x|) over losses, terms, velocities and depths, the
    launches of ``kernel`` in each pass, the fused pass's seconds and the
    frames validated."""
    cfg, n_val = learner.cfg, learner.num_val_steps
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
        return outs, kernel.launches, time.perf_counter() - t

    validate(True)  # warm-up
    fused, n_fused, val_s = validate(True)
    plain, n_plain, _ = validate(False)
    rel = lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                                    / np.maximum(1.0, np.abs(np.asarray(b)))))
    val_err = max(max(rel(f[0][0], p[0][0]), rel(f[0][1], p[0][1]),
                      rel(f[1][0][0], p[1][0][0]), rel(f[1][0][1], p[1][0][1]))
                  for f, p in zip(fused, plain))
    return val_err, n_fused, n_plain, val_s, int(np.sum(lengths - 1))


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
    k4_val = sum(r["launches"][LSTM_KERNELS.index(lstm_stacked_cluster)] for r in validated)
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
    require(_served(learner.model.vitfly_vitlstm, chunks(validated), k4_val)
            and sum(sum(r["launches"]) for r in validated) == k4_val,
            "validation did not serve V(phi) (K4, cluster route) once per chunk")
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

    # validation through K4 against the plain loop, and its rate: V(phi)
    # serves every chunk by its graphs, the reloaded weights' captured in the
    # warm-up pass, so the timed pass replays them and launches no K4 itself
    stats = learner.model.vitfly_vitlstm.serve_stats
    served = sum(stats.steps.values())
    val_err, n_fused, n_plain, val_s, val_frames = _validation_vs_plain(
        learner, run_model, lstm_stacked_cluster)
    served = sum(stats.steps.values()) - served
    log(f"validation with K4 ({n_fused} launches outside V(phi)'s graphs; {served} served "
        f"calls over three passes) against the plain loop ({n_plain}): max |diff| / max(1, "
        f"|x|) over losses, terms, velocities and depths {val_err:.3e}")
    require(n_fused == 0 and n_plain == 0 and served == 3 * (chunks(validated) // cfg.N_eps),
            "validation's K4 launches")
    require(val_err <= VEL_ATOL, "validation through K4 disagrees with the plain loop")

    # one train step on the card against the CPU
    data, ev_offsets = learner._get_device_data("train", cfg.batch_size)
    batch_fn = stepfn.make_batch_slicer(cfg.batch_size, cfg.num_in_channels,
                                        cfg.num_out_channels)
    idx0 = {"start": int(learner.train.traj_starts[0]) + 1, "ev_start": int(ev_offsets[0]),
            "n_valid": cfg.batch_size}
    t0 = time.perf_counter()
    errs, tf32, ref = _card_vs_cpu_step(dev, batch_fn(data, idx0))
    cpu_vals = (ref["loss"], ref["values"].tolist(), ref["gn"])
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


# ------------------------------------------------------------ data parallel

def _dp_data(data, dev, dtype):
    """The resident split on ``dev``, decoded to ``dtype`` unless f32 (the
    step decodes int8/uint8 itself)."""
    data = {k: v.to(dev) for k, v in data.items()}
    if dtype != torch.float32:
        data = {k: stepfn._decode(v).to(dtype) for k, v in data.items()}
    return data


@contextlib.contextmanager
def _split_read_as(dtype):
    """The step's gathers reading a split already decoded to ``dtype`` as
    it is, where their decode casts to f32: the f64 check's split."""
    decode = stepfn._decode
    stepfn._decode = lambda a: a if a.dtype == dtype else decode(a)
    try:
        yield
    finally:
        stepfn._decode = decode


def _dp_step_once(d, data, idxs, make_model=_joint_from_policy_best, kind="joint_vitlstm",
                  dtype=torch.float32):
    """One chunk-DP step (``make_dp_chunked_train_step``, no augmentation,
    no dropout) of ``make_model(d)`` in ``dtype`` on the chunks ``idxs`` of
    the resident split: as ``_train_step_once`` (its gradients the mean
    over the real chunks), with n_real."""
    model = make_model(d).to(dtype)
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN_CONFIG["lr"], betas=(0.9, 0.999),
                           eps=1e-8)
    step = make_dp_chunked_train_step(model, kind, opt, Mesh(1, 0, d), TRAIN_CONFIG["batch_size"],
                                      2, 1, TRAIN_CONFIG["loss_weights"],
                                      TRAIN_CONFIG["optional_loss_param"])
    with _split_read_as(dtype):
        loss, values, gn, n_real = step(_dp_data(data, d, dtype), idxs, None)
    return dict(loss=loss.item(), values=values.cpu(), gn=gn.item(), n_real=n_real.item(),
                before=before,
                grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                after={k: v.detach().cpu() for k, v in model.state_dict().items()})


def _chunk_mean(d, data, idxs, make_model, kind, dtype):
    """The mean over the real chunks of ``idxs`` of each chunk's own
    gradient (after one power iteration, each from the same state) and
    BatchNorm update: {'grads', 'bn'}."""
    B = TRAIN_CONFIG["batch_size"]
    slicer = stepfn.make_batch_slicer(B, 2, 1)
    data = _dp_data(data, d, dtype)
    grads, bn, n = {}, {}, 0
    for g in range(len(idxs["n_valid"])):
        if idxs["n_valid"][g] == 0:
            continue
        model = make_model(d).to(dtype).train()
        stepfn.spectral_update_(model)
        forward = stepfn.make_forward_loss(model, kind, TRAIN_CONFIG["loss_weights"],
                                           TRAIN_CONFIG["optional_loss_param"])
        with _split_read_as(dtype):
            batch = slicer(data, {k: int(v[g]) for k, v in idxs.items()})
        loss = forward(batch, None)[0]
        loss.backward()
        for name, p in model.named_parameters():
            gr = (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
            grads[name] = grads.get(name, 0) + gr
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                bn[k] = bn.get(k, 0) + v.detach().cpu()
        n += 1
    return {"grads": {k: v / n for k, v in grads.items()}, "bn": {k: v / n for k, v in bn.items()}}


def phase_data_parallel(dev, smi, seq_numbers):
    """Chunk-level data parallelism on the card: the joint configuration of
    tools/train_policy.py from policy_best.pth with ``dp_devices = 1,
    dp_chunks_per_device = DP_CHUNKS`` through ``Learner.train_loop()``,
    the G-chunk step against the CPU and against the per-chunk mean, the
    step's numbers over G, the dry run.  Data and workspace under build/,
    removed after."""
    root = os.path.join(REPO, "build", f"dp_smoke_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    try:
        return _data_parallel(dev, smi, root, seq_numbers)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _data_parallel(dev, smi, root, seq_numbers):
    datadir = os.path.join(root, "data", "datasets")
    cfg = EvflyConfig(basedir=root, logdir="logs", datadir=datadir, dataset=["synthetic"],
                      **{**TRAIN_CONFIG, "dp_devices": 1, "dp_chunks_per_device": DP_CHUNKS})
    cache_dataset(os.path.join(datadir, "synthetic"), synthetic_trajectories(),
                  logger=lambda m: None, **dataloader_kwargs(cfg))
    learner = Learner(cfg)
    require(learner.device.type == "cuda", "the DP Learner did not take the card by default")
    B, S = cfg.batch_size, learner.num_training_steps

    # (c) train_loop: 2 epochs of G = DP_CHUNKS chunks per Adam step
    calls, epochs, losses = [], [], []
    sched, dp_epoch, log_line = learner.lr_scheduler, learner._dp_train_epoch, learner.mylogger
    learner.lr_scheduler = lambda it: (calls.append(it), sched(it))[1]

    def recorded_epoch(*args, **kwargs):
        before = _launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = dp_epoch(*args, **kwargs)
        torch.cuda.synchronize()
        epochs.append((time.perf_counter() - t,
                       {k: n - before[k] for k, n in _launches().items()}))
        return out

    def logged(msg):
        log_line(msg)
        if "ep_loss = " in msg or msg.startswith("[VAL] Validated"):
            losses.append(msg)

    learner._dp_train_epoch, learner.mylogger = recorded_epoch, logged
    records = []
    _recording_run_model(learner, records)
    _zero_launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    learner.train_loop()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = _launches()
    loop_peak = torch.cuda.max_memory_allocated() - base
    learner._dp_train_epoch, learner.lr_scheduler = dp_epoch, sched
    n_chunks = sum(-(-(int(n) - 1) // B) for n in learner.train.trajlength)
    val_chunks = sum(-(-r["frames"] // B) for r in records)
    ep_loss = [float(m.split("ep_loss = ")[1].split(",")[0]) for m in losses if "ep_loss" in m]
    log(f"DP train_loop (G = {DP_CHUNKS}): {S} train trajectories, {n_chunks} chunks an epoch "
        f"in {-(-n_chunks // DP_CHUNKS)} steps, {len(records)} validations ({val_chunks} "
        f"chunks) in {loop_s:.1f}s; epochs {[round(t, 3) for t, _ in epochs]} s; LR schedule "
        f"calls {calls}; launches over train_loop {launches}; per DP epoch "
        f"{[{k: n for k, n in e.items() if n} for _, e in epochs]}; {losses}")
    require(len(epochs) == cfg.N_eps and len(ep_loss) == cfg.N_eps
            and all(np.isfinite(ep_loss)), "the DP epochs' losses")
    require(all(np.isfinite(r["loss"]) for r in records), "a DP validation loss is not finite")
    require(calls[0] == 0 and S in calls and calls[-1] == 2 * S
            and all(b >= a for a, b in zip(calls, calls[1:])),
            "the LR schedule did not land at the epoch fractions")
    require(all(n == 0 for _, e in epochs for n in e.values()),
            "a kernel launched in a DP train step")
    require(_served(learner.model.vitfly_vitlstm, val_chunks, launches["K4 cluster"])
            and launches == {**{name: 0 for name in KERNELS},
                             "K4 cluster": launches["K4 cluster"]},
            "DP train_loop: not V(phi) (K4, cluster) once per validation chunk and nothing else")

    data, ev_offsets = learner._get_device_data("train", B)
    starts = [int(s) + 1 for s in learner.train.traj_starts]
    ev0 = [int(o) for o in ev_offsets]

    # (a) the G = 2 step on the card against the CPU, one chunk partial
    idxs2 = {"start": [starts[0], starts[1] + B], "ev_start": [ev0[0], ev0[1] + B],
             "n_valid": [B, B - 5]}
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    ref = _dp_step_once(cpu, data, idxs2)
    errs = _step_errors(_dp_step_once(dev, data, idxs2), ref)
    checked = ("loss", "terms", "gradnorm", "grads", "update", "uv")
    show = lambda e, keys: ", ".join(f"{k} {e[k]:.3e}" for k in keys) + (
        f"; worst gradient leaves {e['worst_grads']}")
    log(f"G = 2 chunk-DP step (one chunk of {B - 5} frames), card against CPU "
        f"({time.perf_counter() - t0:.1f}s; CPU loss {ref['loss']:.6f}, n_real "
        f"{ref['n_real']}), each reading over its training bound: {show(errs, checked)}")
    require(max(errs[k] for k in checked) <= 1,
            "the G-chunk step on the card disagrees with the CPU's")

    # (b) G = 4 with a padded chunk against the mean of the per-chunk
    # gradients and BatchNorm updates: configuration A's BatchNorm head, f64
    cfg_a = heads_config(**CONFIG_A)
    model_a = lambda d: heads_model(d, cfg_a)
    idxs4 = {"start": [starts[0], starts[1], starts[2] + B, starts[0]],
             "ev_start": [ev0[0], ev0[1], ev0[2] + B, ev0[0]], "n_valid": [B, B - 3, B, 0]}
    readings = {}
    for dtype in (torch.float64, torch.float32):
        t0 = time.perf_counter()
        got = _dp_step_once(dev, data, idxs4, model_a, "origunet", dtype)
        want = _chunk_mean(dev, data, idxs4, model_a, "origunet", dtype)
        grad = max(((got["grads"][k] - g).abs().max() / (TRAIN_GRAD_TOL * g.abs().max())).item()
                   for k, g in want["grads"].items() if g.abs().max() > 0)
        bn = max(((got["after"][k] - v).abs() / (TRAIN_BN_ATOL + TRAIN_BN_RTOL * v.abs()))
                 .max().item() for k, v in want["bn"].items())
        counts = {k: int(v) - int(got["before"][k]) for k, v in got["after"].items()
                  if k.endswith("num_batches_tracked")}
        readings[str(dtype)] = dict(grads=grad, bn=bn, n_real=got["n_real"], counters=counts,
                                    seconds=time.perf_counter() - t0)
    log(f"G = 4 chunk-DP step of configuration A (chunks of {B}, {B - 3}, {B}, 0 valid frames) "
        f"on the card against the mean of its per-chunk steps, gradients over TRAIN_GRAD_TOL x "
        f"the leaf's largest and BatchNorm running stats over TRAIN_BN_ATOL + TRAIN_BN_RTOL |x|: "
        f"{readings}")
    f64 = readings[str(torch.float64)]
    require(f64["n_real"] == 3 and len(f64["counters"]) == 2
            and all(n == 1 for n in f64["counters"].values()),
            "configuration A's G-chunk step: n_real or the BatchNorm counters")
    require(f64["grads"] <= 1 and f64["bn"] <= 1,
            "the G-chunk step is not the mean of its chunks' gradients and BatchNorm updates")

    # (d) ms per step at each G in turns, against the per-chunk step
    gen = learner._generator
    dp_step = learner._get_dp_step(B)
    seq_step = learner._get_step("train", indexed=True, B=B)
    pool = [(s + c * B, o + c * B) for s, o in zip(starts, ev0) for c in range(3)]

    def idxs_of(G):
        picks = [pool[i % len(pool)] for i in range(G)]
        return {"start": [p[0] for p in picks], "ev_start": [p[1] for p in picks],
                "n_valid": [B] * G}

    total = torch.cuda.get_device_properties(dev).total_memory
    peaks, times = {}, {}

    def timed(G):
        if G == "per-chunk":
            fn = lambda: seq_step(data, {"start": pool[0][0], "ev_start": pool[0][1],
                                         "n_valid": B}, gen)
        else:
            idxs = idxs_of(G)
            fn = lambda: dp_step(data, idxs, gen)
        _free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        fn()
        ts = []
        for _ in range(DP_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        peaks[G] = max(peaks.get(G, 0.0), torch.cuda.max_memory_allocated() / 2**30)
        times.setdefault(G, []).append(statistics.median(ts) * 1e3)

    swept = []
    for G in DP_SWEEP:
        # a larger G only while twice the last peak fits the card
        if swept and 2 * peaks[swept[-1]] * 2**30 > 0.9 * total:
            log(f"G = {G} left out: G = {swept[-1]} peaked at {peaks[swept[-1]]:.2f} GiB")
            break
        timed(G)
        swept.append(G)
    for G in ["per-chunk"] + swept[::-1] + ["per-chunk"]:
        timed(G)
    profiles = {}
    for G in ["per-chunk", DP_CHUNKS, swept[-1]]:
        idxs = idxs_of(1 if G == "per-chunk" else G)
        fn = ((lambda: seq_step(data, {k: v[0] for k, v in idxs.items()}, gen))
              if G == "per-chunk" else (lambda: dp_step(data, idxs, gen)))
        prof = phase_profile(fn, {}, f"train step ({G if G == 'per-chunk' else f'G = {G}'})",
                             grad=True)
        profiles[str(G)] = None if prof is None else dict(
            idle_share=prof["idle_share"], kernels_per_step=prof["kernels"] / 3,
            busy_ms_per_step=prof["busy_ms"] / 3)
    frames = lambda G: B * (1 if G == "per-chunk" else G)
    sweep = {str(G): dict(ms=[round(t, 2) for t in ts],
                          frames_per_s=[round(frames(G) / t * 1e3, 1) for t in ts],
                          peak_gib=round(peaks[G], 3)) for G, ts in times.items()}
    dp_epoch_s = [t for t, _ in epochs]
    numbers = dict(sweep=sweep, profiles=profiles, dp_train_seconds_per_epoch=dp_epoch_s,
                   dp_seconds_per_epoch=loop_s / cfg.N_eps,
                   seq_seconds_per_epoch=seq_numbers["seconds_per_epoch"],
                   dp_train_loop_peak_gib=loop_peak / 2**30)
    log(f"chunk-DP numbers (card: {smi}; {B}-frame chunks at {H}x{W}, full f32, medians of "
        f"{DP_TIMED} synchronized steps after 1, in turns per-chunk, G ascending, G "
        f"descending, per-chunk): {numbers}")
    del learner, dp_step, seq_step, data
    _free_device_memory()

    # (e) the dry run: two processes sharing the card (gloo) against one
    dry = dryrun_chunked(2, device=dev)
    return launches, numbers, dry


# ------------------------------------------------------------ velocity heads

def heads_config(root=None, **keys) -> EvflyConfig:
    """TRAIN_CONFIG with ``keys`` (CONFIG_A or CONFIG_B), its workspace and
    data under ``root``."""
    where = {} if root is None else dict(basedir=root, logdir="logs", dataset=["synthetic"],
                                          datadir=os.path.join(root, "data", "datasets"))
    return EvflyConfig(**{**TRAIN_CONFIG, **keys, **where})


def d_theta_weights():
    """D(theta)'s weights of policy_best.pth, keyed as OrigUNet's own."""
    return {k[len("origunet."):]: v for k, v in load_state_dict(JOINT_CHECKPOINT).items()
            if k.startswith("origunet.")}


def heads_model(dev, cfg: EvflyConfig):
    """``registry.build_model(cfg)`` on ``dev``, its heads drawn from
    HEADS_SEED, D(theta) from policy_best.pth through ``port.load_into``
    (strict=False: the heads keep their draws)."""
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(HEADS_SEED))
    prefix = "origunet." if isinstance(cfg.model_type_norm, list) else ""
    d_theta = {prefix + k: v for k, v in d_theta_weights().items()}
    state = port.load_into(model.state_dict(), d_theta, strict=False)
    require(all(torch.equal(state[k].cpu(), v) for k, v in d_theta.items()),
            "D(theta) did not load from policy_best.pth")
    model.load_state_dict(state)
    return model.eval()


# the head LSTM's route in each mode (the grid route by shape; the L2 route
# of before, forced, for comparing): (label, kernel wrapper, plain version)
HEAD_ROUTES = {mode: LSTM_ROUTES[(mode, "grid")] for mode in ("stacked", "wavefront")}
HEAD_L2_ROUTES = {mode: LSTM_ROUTES[(mode, "l2")] for mode in ("stacked", "wavefront")}


def phase_head_lstm(dev, flush):
    """K4 and K5 on the grid route at the head LSTM's shape (H = 768, L = 1:
    empty layer-1 weights), and on the L2 route of before, against their
    plain versions at HEAD_LSTM_CHECKS, zero and carried state; then timed
    in turns (L2, grid, grid, L2) at HEAD_LSTM_TIMED beside cuDNN's
    LSTM(768, 768, 1), the plain versions and the bound, L2 flushed.
    Returns the errors by (mode, route) and the times by (mode, G, T)."""
    require(choose_route(HEAD_H, 1) == "grid", "the head's LSTM does not take the grid route")
    errs, times = {}, {}
    with torch.no_grad():
        for G, T_ in HEAD_LSTM_CHECKS:
            _, _, xp0, packed, h0, c0 = _lstm_problem(dev, 60 + G + T_, G, T_, HEAD_H, 1, HEAD_H)
            require(packed.wih_t.shape == (HEAD_H, 0) and packed.bias.shape == (0,)
                    and packed.grid is not None, "L = 1 packs empty layer-1 weights and the grid")
            for (mode, route), (name, kernel, plain) in LSTM_ROUTES.items():
                if route == "cluster":
                    continue
                err = _check_lstm(f"{name} H={HEAD_H}", kernel, plain, xp0,
                                  _route_weights(packed, route), h0, c0)
                errs[(mode, route)] = max(errs.get((mode, route), 0.0), err)
        for G, T_ in HEAD_LSTM_TIMED:
            by_mode = _lstm_times(dev, flush, 70 + G + T_, G, T_, HEAD_H, 1, HEAD_H,
                                  ("l2", "grid", "grid", "l2"), ("grid", "l2"))
            times.update({(mode, G, T_): t for mode, t in by_mode.items()})
    return errs, times


def phase_heads_streaming(dev, model_b):
    """Configuration B through StreamingPipeline.step_events over
    STREAM_WINDOWS windows in both LSTM modes, the graph step against the
    eager one, and after them one more step against the plain path (K1's
    plain version, set_fused_lstm(False)); the graph step's ms per step
    (``_streaming_ms``) with the head LSTM on its grid route and forced onto
    the L2 route, in turns (L2, grid, grid, L2), and a profile of graph
    replays that names the grid kernel; then BatchedStreamingPipeline with
    STREAMS streams over 4 steps, streams reset before the third, graph
    against eager.  Every kernel's launches over each run (the L2 route's
    over its forced timed runs)."""
    windows = stream_windows(dev, STREAM_WINDOWS)
    lstm = model_b.convnet_w_velpred.lstm
    require(lstm.hidden_size == HEAD_H and lstm.num_layers == 1, "the head LSTM's shape")
    lstm_names = [LSTM_ROUTES[key][0] for key in LSTM_ROUTES]
    launches, stream_ms = {}, {}
    set_fused_lstm(True)
    for mode, (name, kernel, _) in HEAD_ROUTES.items():
        lstm.mode = mode
        for k in KERNELS.values():
            k.launches = 0
        g = StreamingPipeline(model_b, device=dev)
        e = StreamingPipeline(model_b, device=dev, graph=False)
        _check_graph_run(f"configuration B, step_events ({mode})", g, e,
                         lambda w: g.step_events(*w), lambda w: e.step_events(*w), windows,
                         lambda p: [p.hidden])
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in KERNELS.items()}
        launches[mode] = counts
        log(f"configuration B streaming ({mode}): launches {counts}")
        require(counts["K1 cluster"] > 0 and counts[name] > 0,
                f"a kernel of configuration B's streaming path ({mode}) never launched")
        require(sum(counts[n] for n in lstm_names) == counts[name],
                f"configuration B's streaming ({mode}) ran another LSTM kernel")
        set_fused_lstm(False)
        plain = StreamingPipeline(model_b, device=dev, graph=False)
        for ex, ey, ep in windows + windows[:1]:
            vr, dr = plain.step_frame(hist_frame_plain(ex[None], ey[None], ep[None], H, W)[0])
        set_fused_lstm(True)
        v, d = g.step_events(*windows[0])
        torch.cuda.synchronize()
        herr, cerr = state_errs(g.hidden, plain.hidden)
        verr, derr = (v - vr).abs().max().item(), (d - dr).abs().max().item()
        log(f"configuration B ({mode}) after {STREAM_WINDOWS + 1} steps, graph against the "
            f"plain path: velocity {verr:.3e}, depth {derr:.3e}, h {herr:.3e}, c/max(1,|c|) "
            f"{cerr:.3e}; velocity {v.tolist()}")
        require(v.shape == (3,) and d.shape == (H, W), "configuration B's shapes")
        require(max(verr, derr, herr, cerr) <= VEL_ATOL,
                f"configuration B ({mode}) disagrees with the plain path")
        prof = phase_profile(lambda: g.step_events(*windows[0]), {name: "lstm_grid_kernel"},
                             f"configuration B graph ({mode})")
        require(prof is None or prof["by_label"][name] > 0,
                f"configuration B's replayed graph ({mode}) ran no grid kernel")
        del g, e, plain
        _free_device_memory()
        # the graph step on each route, in turns; the L2 kernel's launches
        # over its forced runs
        l2_name, l2_kernel, _ = HEAD_L2_ROUTES[mode]
        l2_kernel.launches = 0
        ms = {"l2": [], "grid": []}
        for route in ("l2", "grid", "grid", "l2"):
            with forced_route(route):
                chained, samples = _streaming_ms(StreamingPipeline(model_b, device=dev), windows)
            _free_device_memory()
            ms[route].append((chained, statistics.median(samples)))
        launches[f"{mode} forced l2"] = {l2_name: l2_kernel.launches}
        stream_ms[mode] = {route: statistics.mean(c for c, _ in v) for route, v in ms.items()}
        log(f"configuration B streaming step ({mode}, graph) in turns L2, grid, grid, L2: ms per "
            f"step over {CHAINED_STEPS} chained steps " + "; ".join(
                f"{r} " + " / ".join(f"{c:.3f}" for c, _ in v) for r, v in ms.items())
            + f"; p50 of {SYNC_STEPS} synchronized " + "; ".join(
                f"{r} " + " / ".join(f"{p:.3f}" for _, p in v) for r, v in ms.items())
            + f"; {l2_name} launches over the L2 runs {l2_kernel.launches}")
        require(l2_kernel.launches > 0, f"the forced L2 route ({mode}) did not run")
    lstm.mode = None
    steps = 4
    frames = sparse_frames(12, (steps, STREAMS, H, W), dev)
    masks = [torch.tensor([s == 2 and g_ % 4 == 1 for g_ in range(STREAMS)], device=dev)
             for s in range(steps)]
    desvel = [3.0 + 2.0 * g_ / (STREAMS - 1) for g_ in range(STREAMS)]
    for k in KERNELS.values():
        k.launches = 0
    bg = BatchedStreamingPipeline(model_b, STREAMS, desvel=desvel, fast_percentile=True,
                                  device=dev)
    be = BatchedStreamingPipeline(model_b, STREAMS, desvel=desvel, fast_percentile=True,
                                  device=dev, graph=False)
    _check_graph_run(f"configuration B, step_frames G={STREAMS}, streams reset before step 3",
                     bg, be, lambda s: bg.step_frames(frames[s], masks[s]),
                     lambda s: be.step_frames(frames[s], masks[s]), list(range(steps)),
                     lambda p: [_one_stream(p.hidden, g_) for g_ in range(STREAMS)])
    torch.cuda.synchronize()
    launches["batched"] = {n: k.launches for n, k in KERNELS.items()}
    log(f"configuration B batched G={STREAMS}: launches {launches['batched']}")
    require(launches["batched"]["K4 grid"] > 0
            and sum(launches["batched"][n] for n in lstm_names) == launches["batched"]["K4 grid"],
            "the batched heads path did not run K4 grid alone")
    return launches, stream_ms


def phase_heads_training(dev, smi):
    """Configuration A through Learner(cfg).train_loop() for 2 epochs on
    the training phase's synthetic dataset, D(theta) from policy_best.pth
    (a checkpoint of its weights alone, loaded with strict=False), the head
    drawn from the config's seed; configuration B validated on the same data through K4
    (grid route, H = 768) against the plain loop.  Data and checkpoints live
    under build/ and are removed after."""
    root = os.path.join(REPO, "build", f"heads_smoke_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    try:
        return _heads_training(dev, smi, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _heads_training(dev, smi, root):
    os.makedirs(root)
    d_theta_file = os.path.join(root, "d_theta.pth")
    port.save_state_dict(d_theta_weights(), d_theta_file)
    cfg = heads_config(root, **{**CONFIG_A, "checkpoint_path": [d_theta_file]})
    cache_dataset(os.path.join(cfg.datadir, "synthetic"), synthetic_trajectories(),
                  logger=lambda m: None, **dataloader_kwargs(cfg))
    learner = Learner(cfg)
    require(learner.device.type == "cuda" and learner.model.velpred == 11
            and learner.model.velpred_lstm_size == HEAD_H, "configuration A's model")
    bn_keys = [k for k in learner.params if k.endswith("num_batches_tracked")]
    require(len(bn_keys) == 2, "configuration A's head has not two BatchNorms")
    start = {k: v.detach().cpu().clone() for k, v in learner.params.items()}
    require(all(torch.equal(start[k], v) for k, v in d_theta_weights().items()),
            "the Learner did not load D(theta)")
    records = []
    run_model = _recording_run_model(learner, records)
    for k in KERNELS.values():
        k.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    learner.train_loop()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    trained = [r for r in records if r["training"]]
    chunks = lambda rs: sum(-(-r["frames"] // cfg.batch_size) for r in rs)
    counters = {k: int(learner.params[k]) for k in bn_keys}
    log(f"configuration A train_loop: {len(trained)} trajectories trained ({chunks(trained)} "
        f"chunks), {len(records) - len(trained)} validated in {loop_s:.1f}s; launches of every "
        f"kernel {launches}; BatchNorm counters {counters}; losses "
        + ", ".join(f"{r['mode']} {r['loss']:.4f}" for r in records))
    require(len(trained) == cfg.N_eps * learner.num_training_steps, "trajectories trained")
    require(all(np.isfinite(r["loss"]) and np.isfinite(r["terms"]).all() for r in records),
            "a training or validation loss of configuration A is not finite")
    require(all(n == 0 for n in launches.values()), "configuration A's train_loop ran a kernel")
    require(all(n == chunks(trained) for n in counters.values()),
            "the BatchNorm counters do not count the train steps")
    final = os.path.join(learner.workspace, "model_ep000001.pth")
    saved = load_state_dict(final)
    require(all(saved[k].dtype == torch.int64 and int(saved[k]) == counters[k] for k in bn_keys),
            "model_ep000001.pth does not carry the BatchNorm counters")
    before = {k: v.detach().clone() for k, v in learner.params.items()}
    learner.load_from_checkpoint(final)
    require(all(torch.equal(learner.params[k].cpu(), saved[k])
                and torch.equal(learner.params[k], before[k]) for k in saved),
            "model_ep000001.pth (with its running stats) did not reload bit for bit")

    # one train step on the card against the CPU, from the state before training
    data, ev_offsets = learner._get_device_data("train", cfg.batch_size)
    batch_fn = stepfn.make_batch_slicer(cfg.batch_size, cfg.num_in_channels,
                                        cfg.num_out_channels)
    idx0 = {"start": int(learner.train.traj_starts[0]) + 1, "ev_start": int(ev_offsets[0]),
            "n_valid": cfg.batch_size - 3}

    def model_a(d):
        m = build_model(cfg, device=d)
        m.load_state_dict(start)
        return m

    t0 = time.perf_counter()
    batch = batch_fn(data, idx0)
    cpu = torch.device("cpu")
    errs, tf32, ref = _card_vs_cpu_step(dev, batch, model_a, "origunet")
    cpu_vals = (ref["loss"], ref["values"].tolist(), ref["gn"])

    f64 = torch.float64
    errs64 = _step_errors(_train_step_once(dev, batch, model_a, "origunet", f64),
                          _train_step_once(cpu, batch, model_a, "origunet", f64))
    checked = ("loss", "terms", "gradnorm", "grads", "update", "uv", "bn")
    show = lambda e: ", ".join(f"{k} {e[k]:.3e}" for k in checked) + (
        f"; worst gradient leaves {e['worst_grads']}; worst update leaves {e['worst_update']}")
    log(f"configuration A train step on a padded chunk ({cfg.batch_size - 3} of "
        f"{cfg.batch_size} frames valid), card against CPU ({time.perf_counter() - t0:.1f}s; "
        f"CPU loss, terms, gradient norm {cpu_vals}), each reading over its bound (bn: "
        f"TRAIN_BN_ATOL {TRAIN_BN_ATOL} + TRAIN_BN_RTOL {TRAIN_BN_RTOL} |x|), in f32: "
        f"{show(errs)}")
    log(f"the same step in f64, card against CPU: {show(errs64)}")
    log(f"the same step in TF32 on the card against the CPU's f32: {show(tf32)}")
    require(max(errs64[k] for k in checked) <= 1,
            "configuration A's train step in f64 on the card disagrees with the CPU's")
    require(max(errs[k] for k in HEADS_F32_CHECKED) <= 1,
            "configuration A's f32 train step on the card disagrees with the CPU's")
    require(max(tf32[k] for k in HEADS_F32_CHECKED) > 1,
            "a train step in TF32 passes the f32 bounds")

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
    step_ms = statistics.median(times) * 1e3
    prof = phase_profile(lambda: step(data, idxs[0], gen), {}, "configuration A train",
                         grad=True)
    del learner, run_model, step, data
    gc.collect()
    torch.cuda.empty_cache()

    # configuration B: its validation through K4 on the grid route at H = 768
    cfg_b = heads_config(root, **{**CONFIG_B, "checkpoint_path": [JOINT_CHECKPOINT]})
    learner_b = Learner(cfg_b)
    require(all(torch.equal(learner_b.params["origunet." + k].cpu(), v)
                for k, v in d_theta_weights().items()), "B's Learner did not load D(theta)")
    val_err, n_fused, n_plain, val_s, val_frames = _validation_vs_plain(
        learner_b, learner_b.run_model, lstm_stacked_grid)
    n_chunks = sum(-(-(int(n) - 1) // cfg_b.batch_size) for n in learner_b.val.trajlength)
    log(f"configuration B validation with K4 grid at H={HEAD_H} ({n_fused} launches) against "
        f"the plain loop ({n_plain}): max |diff| / max(1, |x|) over losses, terms, velocities "
        f"and depths {val_err:.3e}")
    require(n_fused == n_chunks and n_plain == 0, "configuration B's validation K4 launches")
    require(val_err <= VEL_ATOL, "configuration B's validation through K4 disagrees")
    numbers = dict(a_train_step_ms=step_ms, a_train_frames_per_s=cfg.batch_size / step_ms * 1e3,
                   a_seconds_per_epoch=loop_s / cfg.N_eps, a_train_loop_peak_gib=(peak - base)
                   / 2**30, a_idle_share=None if prof is None else prof["idle_share"],
                   b_val_frames_per_s=val_frames / val_s)
    log(f"velocity-head training numbers (card: {smi}; {cfg.batch_size}-frame chunks at "
        f"{H}x{W}, full f32, median of {TRAIN_TIMED} synchronized train steps after 2): "
        + ", ".join(f"{k} {v}" for k, v in numbers.items()))
    return launches, n_fused, numbers


def phase_velocity_heads(dev, flush, smi):
    """Configurations A and B built through registry.build_model on the
    card; the head LSTM's kernels at H = 768; B streamed; A trained and B
    validated.  Returns the head LSTM's errors and times, the streaming
    launches, A's train_loop launches, B's validation launches and the
    training numbers."""
    errs, times = phase_head_lstm(dev, flush)
    model_a = heads_model(dev, heads_config(**CONFIG_A))
    frames = sparse_frames(13, (2, 1, H, W), dev)
    with torch.inference_mode():
        vel, (depth, upconv, _) = model_a(frames)
    require(vel.shape == (2, 3) and depth.shape == (2, 1, H, W) and upconv.shape == (2, 1, 68, 148)
            and bool(torch.isfinite(vel).all()), "configuration A's forward")
    log(f"configuration A on the card: velocities {vel.tolist()}")
    del model_a
    model_b = heads_model(dev, heads_config(**CONFIG_B))
    stream_launches, stream_ms = phase_heads_streaming(dev, model_b)
    del model_b
    _free_device_memory()
    train_launches, val_launches, numbers = phase_heads_training(dev, smi)
    numbers.update({f"b_streaming_ms_{mode}": ms for mode, ms in stream_ms.items()})
    return errs, times, stream_launches, train_launches, val_launches, numbers


# ------------------------------------ the model zoo and the dataset path

def _zoo_model(name: str, i: int, dev):
    """(card model, CPU model) of the zoo with the same weights from a seed."""
    module = legacy_vit if name == "LegacyTransformer" else vitfly
    cpu = getattr(module, name)(generator=torch.Generator().manual_seed(ZOO_SEED + i),
                                device="cpu").eval()
    card = getattr(module, name)(device=dev).eval()
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def phase_zoo(dev, smi):
    """The rest of the model zoo served: 256 windows x 5,000 events ->
    K3 -> 60x90 -> each model, on the card against the same model on the
    CPU (velocity and (h, c) within VEL_ATOL x max(1, |x|)); parameter
    counts; windows/s (median of 5 reps x 10 steps); K3's launches per
    step, and none of K4's or K5's (LSTMNet's hidden 395 and
    UNetConvLSTMNet's 200 take the plain loop)."""
    ex, ey, ep = make_events(21, N_WINDOWS, N_EVENTS, dev)
    desvel = torch.full((N_WINDOWS, 1), 4.0, device=dev)
    out = {}
    for i, (name, count) in enumerate(ZOO.items()):
        card, cpu = _zoo_model(name, i, dev)
        n = param_count(card.state_dict())
        require(n == count, f"{name}: {n} parameters, expected {count}")

        def step(card=card, name=name):
            small = event_histogram_scaled_resized(ex, ey, ep, H, W, H_OUT, W_OUT, device=dev)
            if name == "LegacyTransformer":
                return small, (card(small[:, None]), None)
            return small, card(small[:, None], desvel)

        with torch.inference_mode():
            for k in (hist_scaled_resized, *LSTM_KERNELS):
                k.launches = 0
            small, (vel, hidden) = step()
            torch.cuda.synchronize()
            launches = {"K3": hist_scaled_resized.launches,
                        "K4/K5": sum(k.launches for k in LSTM_KERNELS)}
            require(launches["K3"] == 1 and launches["K4/K5"] == 0,
                    f"{name}: launches {launches}")
            if name == "LegacyTransformer":
                ref, ref_hidden = cpu(small.cpu()[:, None]), None
            else:
                ref, ref_hidden = cpu(small.cpu()[:, None], desvel.cpu())
            errs = {"velocity": (vel.cpu() - ref).abs().max().item()}
            bounds = {"velocity": VEL_ATOL * max(1.0, ref.abs().max().item())}
            if ref_hidden is not None:
                for key, g, r in zip(("h", "c"), hidden, ref_hidden):
                    errs[key] = (g.cpu() - r).abs().max().item()
                    bounds[key] = VEL_ATOL * max(1.0, r.abs().max().item())
            require(bool(torch.isfinite(vel).all()) and vel.shape[-1] == 3,
                    f"{name}: velocity {tuple(vel.shape)} not finite")
            require(all(errs[k] <= bounds[k] for k in errs),
                    f"{name}: card against CPU {errs} past {bounds}")
            rates = serving_rate(lambda: step()[1])
        out[name] = statistics.median(rates)
        log(f"zoo {name}: {n:,} params; card vs CPU max|diff| "
            + ", ".join(f"{k} {v:.2e} (bound {bounds[k]:.2e})" for k, v in errs.items())
            + f"; launches per step {launches}; windows/s median {out[name]:.1f} (5 reps x 10 "
            f"steps: {', '.join(f'{r:.1f}' for r in rates)}) on {smi}, f32, TF32 off")
        del card, cpu
    return out


def prophesee_recording(rng, H=REC_H, W=REC_W, fps=30.0):
    """A grating of REC_EDGES vertical edges, W / REC_EDGES px apart,
    moving at REC_SPEED px/s and wrapping round a 640x480 sensor: each
    column an edge crosses fires REC_ROWS events at distinct rows at the
    moment it is crossed (ns since the UNIX epoch, polarity {0, 1}); depth
    frames from the distance to the grating's first edge.  This is
    tests/test_realdata_e2e.py's generator (one edge, 160 rows) with more
    edges and rows, so that the stream runs at about 1 M events/s."""
    t0_ns, n_frames = 1_700_000_000_000_000_000, REC_FRAMES
    depth_ts = t0_ns + (np.arange(n_frames) / fps * 1e9).astype(np.int64)
    edge0, span = 40.0, (n_frames - 1) / fps  # px, s
    # the grating's unwrapped offset passes each integer u at (u - edge0) / speed
    u = np.arange(int(np.ceil(edge0)), int(edge0 + REC_SPEED * span) + 1)
    cross_t = np.repeat((u - edge0) / REC_SPEED, REC_EDGES)
    cross_c = ((u[:, None] + np.arange(REC_EDGES) * (W // REC_EDGES)) % W).reshape(-1)
    rows = np.argsort(rng.random((len(cross_c), H)), axis=1)[:, :REC_ROWS]
    ts = np.repeat(t0_ns + cross_t * 1e9, REC_ROWS)
    order = np.argsort(ts, kind="stable")
    events = (ts[order], np.repeat(cross_c, REC_ROWS).astype(np.int32)[order],
              rows.reshape(-1).astype(np.int32)[order],
              rng.integers(0, 2, size=len(ts)).astype(np.int8)[order])
    xx = np.arange(W)
    depths = np.stack([np.broadcast_to(np.clip(
        np.abs(xx - (edge0 + REC_SPEED * (t - t0_ns) / 1e9)) / W, 0, 1), (H, W))
        for t in depth_ts]).astype(np.float32)
    return events, depths, depth_ts.astype(np.float64), t0_ns


def encode_evt3(t_us, x, y, p) -> bytes:
    """Prophesee EVT 3.0 words for each event: TIME_HIGH, TIME_LOW, ADDR_Y,
    ADDR_X (a copy of tests/test_evt3.py's independent encoder, vectorized
    with numpy)."""
    t = np.asarray(t_us, np.int64)
    words = np.empty((len(t), 4), np.uint16)
    words[:, 0] = (0x8 << 12) | ((t >> 12) & 0x0FFF)
    words[:, 1] = (0x6 << 12) | (t & 0x0FFF)
    words[:, 2] = (0x0 << 12) | (np.asarray(y, np.int64) & 0x0FFF)
    words[:, 3] = (0x2 << 12) | np.where(np.asarray(p) > 0, 0x0800, 0) | np.asarray(x, np.int64)
    return words.astype("<u2").tobytes()


def davis_stream(seed, dev):
    """(t, x, y, p) sorted by time on the card: DAVIS_EVENTS uniform events
    at 260x346 over DAVIS_WINDOWS / 30 s, and the window edges
    (DAVIS_WINDOWS + 1,)."""
    n, windows = DAVIS_EVENTS, DAVIS_WINDOWS
    rng = np.random.default_rng(seed)
    span = windows / 30.0
    t = np.sort(rng.uniform(0, span, n)).astype(np.float32)
    x, y, p = make_events(seed, 1, n, dev)
    edges = torch.tensor(np.arange(windows + 1) / 30.0, dtype=torch.float32, device=dev)
    return torch.tensor(t, device=dev), x[0], y[0], p[0], edges


def _windows_check(label, t, x, y, p, starts, ends, h, w, thresholds, errs):
    """K1's window launch (through its wrapper: one launch, on the route of
    the shape or the one ``forced_voxel_routes`` gives) on a stream cut by
    window_offsets against hist_frame_windows_plain, bit for bit."""
    order, begin, end = window_offsets(t, starts, ends)
    args = (x[order], y[order], p[order], begin, end, h, w, *thresholds)
    n0 = hist_frame_windows.launches
    got = hist_frame_windows(*args)
    torch.cuda.synchronize()
    ref = hist_frame_windows_plain(*args)
    bad = int((got != ref).sum().item())
    route = str(voxelizer.k1_route(h, w, thresholds[0] != thresholds[1]))
    errs[route] = max(errs.get(route, 0.0), (got - ref).abs().max().item())
    log(f"K1 windows ({route}) {label}: {len(starts)} windows, "
        f"{int((end - begin).clamp_min(0).sum().item()):,} window events, {bad} cells differ "
        f"from plain of {ref.numel():,}; max|frame| {ref.abs().max().item():.1f}")
    require(hist_frame_windows.launches == n0 + 1, "K1 windows: not one launch per call")
    require(bad == 0, f"K1 windows disagrees with its plain version ({label})")


def _window_bincount(x, y, p, begin, end, h, w, thresholds):
    """torch.bincount over the (window, cell) keys of contiguous windows
    [begin[0], end[-1]), weights +pos/-neg (the sign times pos with one
    threshold): one library call computing K1's frames, and the bound
    n * eps * sum |w| of its f32 sums' distance from the kernel's exact
    counts at a cell of n events."""
    xi, yi, sign = bin_events(x, y, p, h, w)
    win = torch.repeat_interleave(torch.arange(len(begin), device=x.device), end - begin)
    keys = win * (h * w) + (yi * w + xi)[begin[0]:end[-1]]
    sign = sign[begin[0]:end[-1]]
    weights = sign * torch.where(sign > 0, thresholds[0], thresholds[1])
    n_cells = len(begin) * h * w
    tol = (torch.bincount(keys, minlength=n_cells)
           * torch.bincount(keys, weights.abs(), minlength=n_cells).double()
           * float(np.finfo(np.float32).eps)).reshape(-1, h, w)
    return (lambda: torch.bincount(keys, weights, minlength=n_cells)), tol


def _windows_timed(label, fns, order, plain, x, y, p, begin, end, h, w, thresholds, flush):
    """Routes of K1's window launch (name -> call) timed in the turns of
    ``order``, each torch.equal to the plain version first, beside the
    plain version, torch.bincount and the bytes bound: name -> mean ms,
    with "plain_ms", "library_ms", "bound_ms", "bound_by"."""
    ref = plain()
    for name, fn in fns.items():
        require(torch.equal(fn(), ref), f"K1 windows ({name}, {label}) disagrees with plain")
    lib_fn, tol = _window_bincount(x, y, p, begin, end, h, w, thresholds)
    lib_err = (lib_fn().float().reshape(ref.shape) - ref).abs()
    require(bool((lib_err <= tol).all()),
            f"torch.bincount with weights +pos/-neg disagrees with K1 windows ({label})")
    turns = in_turns(fns, order, flush, 10)
    plain_ms = time_ms(plain, flush, 3, warmup=1)
    library_ms = time_ms(lib_fn, flush, 10)
    n_win = int((end - begin).sum().item())
    two = thresholds[0] != thresholds[1]
    # each window's events read once (12 bytes), its frame written once; an
    # add per event, per cell a multiply (two and a subtract)
    b_ms, b_by = bound_ms(12 * n_win + 4 * len(begin) * h * w,
                          n_win + (3 if two else 1) * len(begin) * h * w)
    log(f"K1 windows {label}, {len(begin)} windows, {n_win:,} events at {w}x{h}, thresholds "
        f"{thresholds}, in turns {', '.join(order)}: "
        + "; ".join(f"{r} " + " / ".join(f"{v:.4f}" for v in turns[r]) + " ms"
                    for r in dict.fromkeys(order))
        + f"; plain {plain_ms:.4f} ms; torch.bincount {library_ms:.4f} ms (max|diff| "
        f"{lib_err.max().item():.2e}); bound {b_ms:.6f} ms ({b_by})")
    return {**{r: statistics.mean(v) for r, v in turns.items()}, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_dataset(dev, flush, smi):
    """A real recording to a training trajectory: a Prophesee-like 640x480
    recording encoded to EVT3, decoded, and packaged on the card
    (package_real_sequence: K1 over all windows in one launch), the dict
    equal to the CPU path's key by key, with one threshold (the 8-CTA
    cluster route) and two (the 16-CTA route); K1's window launch against
    its plain version on a DAVIS-like stream on each route (sorted,
    shuffled, overlapping and empty windows at 260x346 on 8 CTAs, at 640x480
    with two thresholds on 16, at 1280x720 with two on the band route, and
    windows at every alignment); timed in turns against today's (B, N_max)
    padded launch at 260x346, and at shape A (the stream at 640x480, two
    thresholds: 16 CTAs and the band route forced) and shape B (at 1280x720:
    one threshold on 16 CTAs, two on the band route, one on the band route
    forced), each beside the plain version, torch.bincount over (window,
    cell) keys and the bytes bound; the sort timed alone."""
    rng = np.random.default_rng(31)
    (et, ex, ey, ep), depths, dts, t0_ns = prophesee_recording(rng)
    t_us = np.round((et - t0_ns) / 1e3).astype(np.int64)
    raw = encode_evt3(t_us, ex, ey, ep)
    evt3.decode_evt3_bytes(raw[:8])  # builds the decoder's library (first use) outside the timing
    t0 = time.perf_counter()
    ev = evt3.decode_evt3_bytes(raw)
    decode_s = time.perf_counter() - t0
    require(np.array_equal(ev["t"], t_us) and np.array_equal(ev["x"], ex)
            and np.array_equal(ev["y"], ey) and np.array_equal(ev["p"], ep * 2 - 1),
            "EVT3 decode differs from the encoded events")
    # the decoder's us since the recording's start, back on the epoch's ns
    event_ns = t0_ns + ev["t"].astype(np.float64) * 1e3
    p01 = (ev["p"] > 0).astype(np.int8)  # the camera's {0, 1} polarity
    launches = {}
    for thresholds, route in (((0.2, 0.2), "cluster8"), ((0.2, 0.3), "cluster16")):
        require(str(voxelizer.k1_route(REC_H, REC_W, thresholds[0] != thresholds[1])) == route,
                f"K1 at {REC_H}x{REC_W}, thresholds {thresholds}: not the {route} route")
        args = ("real_000", event_ns, ev["x"], ev["y"], p01, depths, dts)
        kw = dict(pos_thresh=thresholds[0], neg_thresh=thresholds[1])
        hist_frame_windows.launches = 0
        hist_frame_windows.by_route.clear()
        t0 = time.perf_counter()
        traj = realdata.package_real_sequence(*args, **kw, device=dev)
        card_s = time.perf_counter() - t0
        launches[route] = hist_frame_windows.by_route[route]
        ref = realdata.package_real_sequence(*args, **kw, device="cpu")
        same = {k: bool(np.array_equal(np.asarray(traj[k]), np.asarray(ref[k]))
                        and np.asarray(traj[k]).dtype == np.asarray(ref[k]).dtype)
                for k in ref}
        log(f"recording -> trajectory ({route}, thresholds {thresholds}): {len(t_us):,} events "
            f"({len(raw) / 1e6:.2f} MB of EVT3, decoded in {decode_s:.3f} s), evs "
            f"{traj['evs'].shape}, K1 windows launches {dict(hist_frame_windows.by_route)}, "
            f"equal to the CPU's {same}; packaged in {card_s:.3f} s on the card (host clock)")
        require(all(same.values()), f"the card's trajectory differs from the CPU's: {same}")
        require(hist_frame_windows.launches == 1 and launches[route] == 1,
                f"package_real_sequence: not one K1 launch on the {route} route")
        require(traj["evs"].shape == (REC_FRAMES - 1, REC_H, REC_W)
                and bool(np.isfinite(traj["evs"]).all())
                and (np.abs(traj["evs"]).sum(axis=(1, 2)) > 0).all(),
                "the trajectory's event frames")

    t, x, y, p, edges = davis_stream(33, dev)
    errs = {}
    starts, ends = edges[:-1], edges[1:]
    perm = torch.randperm(DAVIS_EVENTS, device=dev, generator=torch.Generator(dev).manual_seed(3))
    lap = torch.tensor([0.0, 0.5, 0.25, 1.0, 1.9], device=dev)
    empty = torch.tensor([0.3, 0.7, 1.5, 2.5, -1.0], device=dev)
    empty_ends = torch.tensor([0.3, 0.6, 1.6, 3.0, 0.0], device=dev)
    # the stream scaled to each frame, each on its route: 8 CTAs at
    # 260x346, 16 at 640x480 with two thresholds, the band route at
    # 1280x720 with two
    rx, ry = x * (REC_W / W), y * (REC_H / H)
    hx, hy = x * (HD_W / W), y * (HD_H / H)
    for h, w, sx, sy, thresholds in ((H, W, x, y, (0.2, 0.2)), (H, W, x, y, (0.2, 0.3)),
                                     (REC_H, REC_W, rx, ry, (0.2, 0.3)),
                                     (HD_H, HD_W, hx, hy, (0.2, 0.2)),
                                     (HD_H, HD_W, hx, hy, (0.2, 0.3))):
        at = f"{DAVIS_EVENTS:,} events at {w}x{h}, thresholds {thresholds}"
        _windows_check(at, t, sx, sy, p, starts, ends, h, w, thresholds, errs)
        _windows_check(f"{at}, shuffled", t[perm], sx[perm], sy[perm], p[perm], starts, ends, h,
                       w, thresholds, errs)
        _windows_check(f"{at}, overlapping and nested", t, sx, sy, p, lap, lap + 0.5, h, w,
                       thresholds, errs)
        _windows_check(f"{at}, empty (t1 <= t0, after and before the stream)", t, sx, sy, p,
                       empty, empty_ends, h, w, thresholds, errs)
    # windows starting at every offset mod 4 and of 0 to 9 events, each route
    off_begin = torch.arange(200, device=dev, dtype=torch.int64)
    off_end = off_begin + torch.arange(200, device=dev) % 10
    for route, thresholds in ((K1Route("cluster", K1_CLUSTER), (0.2, 0.3)),
                              (K1Route("cluster", K1_WIDE_CLUSTER), (0.2, 0.3)),
                              (BAND_ROUTE, (0.2, 0.3))):
        got = _frame_windows_launch(x, y, p, off_begin, off_end, H, W, *thresholds, route)
        require(torch.equal(got, hist_frame_windows_plain(x, y, p, off_begin, off_end, H, W,
                                                          *thresholds)),
                f"K1 windows ({route}) at every alignment disagrees with plain")
    log("K1 windows at every alignment (offsets 0-199, 0-9 events), each route: equal to plain")

    # timings, in turns, on the sorted stream (its window offsets found once)
    torch.cuda.synchronize()
    sort_ms = time_ms(lambda: window_offsets(t[perm], starts, ends), flush, 10)
    order, begin, end = window_offsets(t, starts, ends)
    counts = (end - begin).tolist()
    n_max = max(counts)
    pad = lambda a, fill: torch.stack([torch.cat([a[b:e], a.new_full((n_max - (e - b),), fill)])
                                       for b, e in zip(begin.tolist(), end.tolist())])
    px, py, pp = pad(x, 0.0), pad(y, 0.0), pad(p, 0)
    require(torch.equal(hist_frame_routed(px, py, pp, H, W),
                        _frame_windows_launch(x, y, p, begin, end, H, W, 0.2, 0.2)),
            "the padded (B, N_max) K1 launch and the window launch disagree")
    # the band route's layout read to the host once, as hist_frame_windows
    # reads it with its offset check, so that the timed calls do not wait
    # for the host
    layout = band_route_layout(begin, end)
    layout_ms = time_ms(lambda: band_route_layout(begin, end), flush, 10)
    win = lambda h_, w_, sx, sy, th, r=None: (
        lambda: _frame_windows_launch(sx, sy, p, begin, end, h_, w_, *th, r, layout))
    plain = lambda h_, w_, sx, sy, th: (
        lambda: hist_frame_windows_plain(sx, sy, p, begin, end, h_, w_, *th))
    davis = _windows_timed(f"at {W}x{H}", {"windows": win(H, W, x, y, (0.2, 0.2)),
                                            "padded": lambda: hist_frame_routed(px, py, pp, H, W)},
                           ("padded", "windows", "windows", "padded"),
                           plain(H, W, x, y, (0.2, 0.2)), x, y, p, begin, end, H, W, (0.2, 0.2),
                           flush)
    two = (0.2, 0.3)
    shape_a = _windows_timed("shape A", {"cluster16": win(REC_H, REC_W, rx, ry, two),
                                         "band": win(REC_H, REC_W, rx, ry, two, BAND_ROUTE)},
                             ("cluster16", "band", "band", "cluster16"),
                             plain(REC_H, REC_W, rx, ry, two), rx, ry, p, begin, end, REC_H,
                             REC_W, two, flush)
    shape_b1 = _windows_timed("shape B, one threshold",
                              {"cluster16": win(HD_H, HD_W, hx, hy, (0.2, 0.2)),
                               "band": win(HD_H, HD_W, hx, hy, (0.2, 0.2), BAND_ROUTE)},
                              ("cluster16", "band", "band", "cluster16"),
                              plain(HD_H, HD_W, hx, hy, (0.2, 0.2)), hx, hy, p, begin, end, HD_H,
                              HD_W, (0.2, 0.2), flush)
    shape_b2 = _windows_timed("shape B, two thresholds", {"band": win(HD_H, HD_W, hx, hy, two)},
                              ("band", "band"), plain(HD_H, HD_W, hx, hy, two), hx, hy, p, begin,
                              end, HD_H, HD_W, two, flush)
    # the band route's band pass alone: the same windows with no events (no
    # partition block; every band zeroed and written)
    no_events = band_route_layout(begin, begin)
    none = _frame_windows_launch(hx, hy, p, begin, begin, HD_H, HD_W, *two, None, no_events)
    require(not none.any(), "K1 windows on empty windows: frames not zero")
    del none
    band_pass_ms = time_ms(lambda: _frame_windows_launch(hx, hy, p, begin, begin, HD_H, HD_W,
                                                         *two, None, no_events), flush, 10)
    log(f"K1 windows shape B, two thresholds, the band pass alone (every window empty): "
        f"{band_pass_ms:.4f} ms")
    # the band route's two kernels at shape B by device time (3 calls, L2
    # not flushed between them)
    prof = phase_profile(win(HD_H, HD_W, hx, hy, two),
                         {"partition": "hist_band_partition_kernel", "band": "hist_band_kernel"},
                         "band-route calls at shape B")
    split = None if prof is None else {k: v / 3 for k, v in prof["by_label"].items()}
    # the band route's launches through the entry point at shape B
    hist_frame_windows.launches = 0
    hist_frame_windows.by_route.clear()
    frames = event_frames_from_windows(t, hx, hy, p, starts, ends, HD_H, HD_W, *two, device=dev)
    torch.cuda.synchronize()
    launches["band"] = hist_frame_windows.by_route["band"]
    require(hist_frame_windows.launches == 1 and launches["band"] == 1
            and torch.equal(frames, plain(HD_H, HD_W, hx, hy, two)()),
            "event_frames_from_windows at 1280x720 did not take one launch of the band route")
    del frames
    log(f"K1 windows at {H}x{W}: the stable sort and searchsorted of {DAVIS_EVENTS:,} times "
        f"{sort_ms:.4f} ms; the band route's layout of {DAVIS_WINDOWS} windows with its read "
        f"to the host {layout_ms:.4f} ms; launches on the dataset path {launches}; on {smi}")

    def entry(t_, route, **extra):
        return dict(max_abs_err=errs[route], ms=t_[route], plain_ms=t_["plain_ms"],
                    bound_ms=t_["bound_ms"], bound_by=t_["bound_by"],
                    library_ms=t_["library_ms"], **extra)

    return launches, {
        "cluster8": entry({**davis, "cluster8": davis["windows"]}, "cluster8",
                          padded_ms=davis["padded"], sort_ms=sort_ms),
        "cluster16": entry(shape_a, "cluster16", band_forced_ms=shape_a["band"]),
        "band": entry(shape_b2, "band", shape_b_one_threshold=shape_b1, layout_ms=layout_ms,
                      band_pass_ms=band_pass_ms, profiled_ms_per_call=split)}


def texture_trajectory(n=GEN_FRAMES, h=H, w=W, dt=GEN_DT, speeds=GEN_SPEEDS, seed=41):
    """A smooth texture translating along x by ``speeds`` px a frame with
    its exact flow field: (frames (n, h, w) in [0.05, 0.95], flows (n, h, w,
    2) px/s, times (n,) s)."""
    rng = np.random.default_rng(seed)
    shift = np.concatenate([[0.0], np.cumsum(speeds[1:])])
    a, b, c = rng.uniform(0.1, 0.3, 3)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    frames = np.stack([
        0.5 + 0.3 * np.sin(a * (xx - s)) * np.cos(b * yy) + 0.15 * np.sin(c * (xx - s + yy))
        for s in shift]).astype(np.float32)
    flows = np.zeros((n, h, w, 2), np.float32)
    flows[..., 0] = (speeds / dt)[:, None, None]
    return frames, flows, np.arange(n) * dt


def _quantized_diff(got, ref, margins, quantum, margin):
    """(differing pixels, pixels that differ away from a crossing, max |diff|,
    max |sum diff|) of card against CPU event frames."""
    diff = got != ref
    return (int(diff.sum()), int((diff & (margins >= margin)).sum()),
            float(np.abs(got - ref).max(initial=0.0)),
            float(np.abs(got.sum(0) - ref.sum(0)).max(initial=0.0)))


def phase_event_generation(dev, smi):
    """One 49-frame trajectory at 260x346 through to_events.trajectory_events
    by each scheme on the card against the CPU: equal wherever the CPU's
    quotient lay farther than GEN_MARGIN from an integer (FLOW_MARGIN on
    upsampled frames), each differing pixel within one quantum, per-pixel
    sums within 1e-5 + a quantum; ms per trajectory (host clock, median of
    3 after one)."""
    frames, flows, ts = texture_trajectory()
    factors = [upsample.adaptive_factor(flows[i - 1], flows[i], ts[i] - ts[i - 1])
               for i in range(1, GEN_FRAMES)]
    require(min(factors) == 1 and max(factors) == 16 and len(set(factors)) == 16,
            f"adaptive factors {factors} do not span 1-16")
    fine, _, ks = upsample.upsample_sequence(frames, flows, ts, return_factors=True,
                                             device="cpu")
    margins = {
        "esim": esim.esim_margins(frames, device="cpu").numpy(),
        "esim_flow": esim.esim_margins(fine, device="cpu").numpy()[np.cumsum(ks) - 1],
        "difflog": voxelizer.difflog_margins(frames[1:], frames[:-1], device="cpu").numpy(),
    }
    ms = {}
    for scheme in to_events.SCHEMES:
        run = lambda d: to_events.trajectory_events(frames, scheme, 0.2, flows, ts, device=d)
        got = run(dev).cpu().numpy()
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[scheme] = statistics.median(times[1:])
        ref = run("cpu").numpy()
        margin = FLOW_MARGIN if scheme == "esim_flow" else GEN_MARGIN
        n_diff, n_far, dmax, smax = _quantized_diff(got, ref, margins[scheme], 0.2, margin)
        log(f"event generation {scheme}: {got.shape}, {int((got != 0).sum()):,} nonzero "
            f"pixels; card vs CPU: {n_diff} pixels differ ({n_far} away from a crossing), max "
            f"|diff| {dmax:.3g}, max |sum diff| {smax:.3g}; {ms[scheme]:.2f} ms per trajectory "
            f"({', '.join(f'{t:.2f}' for t in times)}) on {smi}")
        require(got.shape == (GEN_FRAMES - 1, H, W) and bool(np.isfinite(got).all())
                and (got != 0).any(), f"{scheme}: event frames")
        require(n_far == 0 and dmax <= 0.2 + 1e-6 and smax <= 1e-5 + 0.2,
                f"{scheme}: the card disagrees with the CPU past the crossings' bound")
    return ms

class _TickRecorder:
    """A batched policy that keeps the frames, reset masks and velocities of
    its first ``keep`` ticks and counts them all."""

    def __init__(self, pipe, keep: int):
        self.pipe, self.keep, self.ticks, self.kept = pipe, keep, 0, []

    def reset(self):
        self.pipe.reset()

    def step_frames(self, frames, reset_mask=None):
        vels, depths = self.pipe.step_frames(frames, reset_mask=reset_mask)
        if self.ticks < self.keep:
            self.kept.append((frames.clone(), np.array(reset_mask), vels.clone()))
        self.ticks += 1
        return vels, depths


def closed_loop_fields():
    return [generate_forest(np.random.default_rng(CL_SEED + g)) for g in range(CL_STREAMS)]


def _render_vs_cpu(dev, fields, logs, tick):
    """One lockstep tick of _render_tick (render + difflog against the tick
    before) at the logged positions of CL_RENDER_VIEWS trials, on the card
    against the CPU under the margin rule: away from RENDER_MARGIN depth
    within 5e-5 (the nearer root's cancellation in b^2 - 4ac, which nvcc
    contracts into an fma: 3.3e-5 measured on an H100) with a mean
    below 1e-6, intensity within 5e-6; events equal away from it and from
    difflog's crossings.  Returns the flagged pixels' count."""
    views = fields[:CL_RENDER_VIEWS]
    pos = [np.stack([log[t, 7:10] for log in logs[:CL_RENDER_VIEWS]]) for t in (tick - 1, tick)]
    outs = []
    for d in (dev, torch.device("cpu")):
        centers, radii = sim_batched.pad_fields(views, device=d)
        _, prev, _ = sim_batched._render_tick(pos[0], centers, radii, torch.zeros(
            len(views), H, W, device=d), False, H, W, True)
        depth, inten, events = sim_batched._render_tick(pos[1], centers, radii, prev, True,
                                                        H, W, True)
        outs.append([t.cpu() for t in (depth, inten, events, prev)])
        if d.type == "cpu":
            margins = [render.render_margins(p, centers, radii, H=H, W=W, is_trees=True,
                                             device=d) for p in pos]
            dmargin = voxelizer.difflog_margins(inten, prev, device=d)
    (cd, ci, ce, _), (rd, ri, re_, _) = outs
    ok = (margins[0] >= render.RENDER_MARGIN) & (margins[1] >= render.RENDER_MARGIN)
    eok = ok & (dmargin >= GEN_MARGIN)
    flagged = int((~ok).sum())
    derr, ierr = ((a - b).abs()[ok].max().item() for a, b in ((cd, rd), (ci, ri)))
    dmean = (cd - rd).abs()[ok].mean().item()
    n_ev = int((ce != re_)[eok].sum())
    log(f"closed-loop render tick {tick}, {len(views)} views at {H}x{W}, card vs CPU: "
        f"{flagged} of {ok.numel()} pixels within the render's margin; away from it max "
        f"|depth diff| {derr:.3g} (mean {dmean:.3g}), max |intensity diff| {ierr:.3g}, {n_ev} "
        f"event pixels differ ({int((ce != re_).sum())} in all, {int((ce != 0).sum())} nonzero)")
    require(flagged < ok.numel() // 20 and derr <= 5e-5 and dmean <= 1e-6 and ierr <= 5e-6
            and n_ev == 0,
            "the card's render or difflog disagrees with the CPU's past the margin rule")
    return flagged


def phase_closed_loop_vision(dev, model, smi):
    """run_trials_batched(mode="vision") of CL_STREAMS trials with the joint
    model in a BatchedStreamingPipeline (CUDA graph): ticks/s, sim steps/s,
    success and crashes, every kernel's launches over the run; the first
    ticks' velocities against single eager streams on the same frames; one
    tick's render and difflog against the CPU; the render's peak memory and
    time; a profile of 3 one-tick runs."""
    fields = closed_loop_fields()
    _free_device_memory()
    pipe = BatchedStreamingPipeline(model, CL_STREAMS, desvel=4.0, device=dev)
    policy = _TickRecorder(pipe, CL_CHECK_TICKS)
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = sim_batched.run_trials_batched(
        fields, mode="vision", policy=policy, policy_every=CL_POLICY_EVERY,
        max_steps=CL_MAX_STEPS, log_images=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    ticks = policy.ticks
    summaries = [r["summary"] for r in results]
    success = sum(bool(s.get("Success")) for s in summaries)
    crashes = sum(int(s.get("number_crashes", 0)) for s in summaries)
    lstm = {n: launches[n] for n in ("K4 cluster", "K5 cluster", "K4 L2", "K5 L2",
                                     "K4 grid", "K5 grid")}
    log(f"closed loop, vision, G={CL_STREAMS} at {H}x{W}, {len(fields[0])} trees a forest: "
        f"{ticks} ticks in {wall:.2f} s = {ticks / wall:.2f} ticks/s, "
        f"{CL_STREAMS * ticks * CL_POLICY_EVERY / wall:.1f} quad sim steps/s; {success} of "
        f"{CL_STREAMS} trials successful, {crashes} crashes; LSTM launches {lstm} (at the "
        f"graph's warm-up and capture); other launches "
        f"{ {n: c for n, c in launches.items() if c and n not in lstm} } on {smi}")
    require(all(r["log"].shape[1] == 21 and np.isfinite(r["log"]).all() for r in results)
            and ticks > 0, "closed-loop logs")
    require(sum(lstm.values()) > 0 and launches["K4 cluster"] + launches["K5 cluster"] > 0,
            "the closed loop launched no K4/K5 kernel")
    require(pipe.graph, "the closed loop's pipeline does not replay CUDA graphs")

    # the first ticks against single eager streams on the same frames
    err = 0.0
    for g in range(CL_STREAMS):
        single = StreamingPipeline(model, desvel=4.0, device=dev, graph=False)
        for frames, mask, vels in policy.kept:
            if mask[g]:
                single.reset()
            v, _ = single.step_frame(frames[g])
            err = max(err, (v - vels[g]).abs().max().item())
    log(f"closed loop: velocities of the first {len(policy.kept)} ticks against "
        f"{CL_STREAMS} single eager streams on the same frames: max |diff| {err:.3e}")
    require(err <= VEL_ATOL, "the closed loop's batched policy disagrees with single streams")

    flagged = _render_vs_cpu(dev, fields, [r["log"] for r in results], 3)

    # the render's peak memory and time at G = CL_STREAMS
    centers, radii = sim_batched.pad_fields(fields, device=dev)
    pos = torch.tensor(np.stack([r["log"][2, 7:10] for r in results]), device=dev)
    prev = torch.rand(CL_STREAMS, H, W, device=dev)
    tick = lambda: sim_batched._render_tick_quantized(pos, centers, radii, prev, True, H, W,
                                                      True)
    del pipe, policy
    _free_device_memory()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tick()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    render_ms = time_ms(tick, L2Flush(dev), reps=10)
    log(f"render + difflog + quantization of one tick, G={CL_STREAMS}, K={centers.shape[1]}, "
        f"{H}x{W}: {render_ms:.3f} ms, peak memory {peak:.1f} MiB above the inputs on {smi}")

    ppipe = BatchedStreamingPipeline(model, CL_STREAMS, desvel=4.0, device=dev)
    one_tick = lambda: sim_batched.run_trials_batched(
        fields, mode="vision", policy=ppipe, policy_every=CL_POLICY_EVERY,
        max_steps=CL_POLICY_EVERY, log_images=False, device=dev)
    prof = phase_profile(one_tick, {"K4/K5": "lstm_cluster_kernel"},
                         f"closed-loop one-tick runs G={CL_STREAMS}")
    del ppipe
    return dict(launches=launches, ticks_per_s=ticks / wall,
                sim_steps_per_s=CL_STREAMS * ticks * CL_POLICY_EVERY / wall, success=success,
                crashes=crashes, vel_err=err, render_flagged=flagged, render_ms=render_ms,
                render_peak_mib=peak,
                idle_share=None if prof is None else prof["idle_share"])


def phase_closed_loop_state(dev, smi):
    """STATE_TRIALS state-mode trials batched on the card against run_trial
    for each on the card: summaries equal, logs within 1e-6."""
    fields = closed_loop_fields()[:STATE_TRIALS]
    t0 = time.perf_counter()
    batched = sim_batched.run_trials_batched(fields, mode="state", policy_every=6,
                                             max_steps=STATE_STEPS, seed=5, log_images=False,
                                             device=dev)
    wall = time.perf_counter() - t0
    err = 0.0
    for g, field in enumerate(fields):
        single = closed_loop.run_trial(field, mode="state", policy_every=6,
                                       max_steps=STATE_STEPS, rng=np.random.default_rng(
                                           5 + 977 * g), log_images=False, device=dev)
        require(batched[g]["summary"] == single["summary"],
                f"state trial {g}: batched summary {batched[g]['summary']} != "
                f"{single['summary']}")
        require(batched[g]["log"].shape == single["log"].shape, f"state trial {g}: log shape")
        err = max(err, float(np.abs(batched[g]["log"] - single["log"])[:, 1:].max()))
    log(f"closed loop, state, {STATE_TRIALS} trials: batched {wall:.2f} s on {smi}; summaries "
        f"equal, max |log diff| {err:.3g} against run_trial; successes "
        f"{[r['summary'].get('Success') for r in batched]}")
    require(err <= 1e-6, "batched state trials disagree with run_trial")


def phase_evaluation(dev, model, smi):
    """run_evaluation of EVAL_TRIALS vision trials, a StreamingPipeline per
    trial, into a directory under build/ that is removed after."""
    out = os.path.join(REPO, "build", f"eval_smoke_{os.getpid()}")
    try:
        t0 = time.perf_counter()
        summaries = run_evaluation(
            EVAL_TRIALS, mode="vision",
            policy_factory=lambda: StreamingPipeline(model, desvel=4.0, device=dev),
            out_dir=out, max_steps=EVAL_STEPS, make_plots=False, device=dev)
        wall = time.perf_counter() - t0
        names = sorted(os.listdir(out))
        log(f"run_evaluation, {EVAL_TRIALS} vision trials in {wall:.2f} s on {smi}: {names}; "
            f"{json.dumps(summaries, default=float)}")
        for trial in summaries:
            for f in ("path.csv", "dist.csv", "scalarMetrics.dat", "static_obstacles.csv"):
                require(os.path.getsize(os.path.join(out, trial, f)) > 0,
                        f"run_evaluation wrote no {trial}/{f}")
        require(len(summaries) == EVAL_TRIALS
                and ("evaluation.json" in names or "evaluation.yaml" in names),
                "run_evaluation's summary")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return summaries


class _RecordingAdam(torch.optim.Adam):
    """Adam that keeps the gradients of its first step."""

    first_grads = None

    def step(self, *args, **kwargs):
        if self.first_grads is None:
            self.first_grads = [p.grad.clone() for p in self.param_groups[0]["params"]]
        return super().step(*args, **kwargs)


def rl_env_params():
    """tools/train_rl.py's VisionEnv: a 40-tree forest, goal 4 m/s, the
    world box, 20 s episodes."""
    field = generate_forest(np.random.default_rng(0), num_obstacles=40)
    return vision_env.EnvParams(
        obstacle_pos=torch.tensor(field.positions, dtype=torch.float32),
        obstacle_radius=torch.tensor(field.radii, dtype=torch.float32),
        goal_vel=torch.tensor([4.0, 0.0, 0.0]),
        world_box=torch.tensor([[-5.0, -20.0, 0.0], [65.0, 20.0, 20.0]]), max_t=20.0)


def _ppo_iteration_card_vs_cpu(dev, spec_of, label, rollout):
    """One iteration from the same weights, states, noise and resets (drawn
    on the CPU) on the card and on the CPU: env states, metrics and the
    parameters whose first gradient exceeds 1e-4 of its tensor's largest
    within 1e-4 (below it Adam scales rounding to a step of up to lr: held
    within 2 lr per epoch, tests/test_torch_rl.py)."""
    cfg = ppo.PPOConfig(num_envs=PPO_ENVS, rollout_len=rollout, lr=3e-4)
    cpu = torch.device("cpu")
    spec_c = spec_of(cpu)
    gen = torch.Generator().manual_seed(3)
    ac_c = ppo.init_actor_critic(gen, act_dim=spec_c.act_dim, obs_dim=spec_c.obs_dim,
                                 device=cpu)
    states_c = spec_c.reset(gen, PPO_ENVS)
    noise = torch.randn(rollout, PPO_ENVS, spec_c.act_dim, generator=gen)
    resets = [spec_c.reset(gen, PPO_ENVS) for _ in range(rollout)]
    to = lambda st, d: type(st)(*(x.to(d) for x in st))
    out = []
    for d, spec in ((dev, spec_of(dev)), (cpu, spec_c)):
        ac = ppo.ActorCritic(act_dim=spec.act_dim, obs_dim=spec.obs_dim, device=d)
        ac.load_state_dict(ac_c.state_dict())
        opt = _RecordingAdam(ac.parameters(), lr=cfg.lr)
        it = ppo.make_ppo_iteration(None, cfg, spec)
        ac, _, st, metrics = it(ac, opt, to(states_c, d), noise=noise.to(d),
                                resets=[to(r, d) for r in resets])
        out.append((ac, st, metrics, opt.first_grads))
    (ac_g, st_g, m_g, _), (ac_r, st_r, m_r, grads) = out
    serr = max((a.cpu() - b).abs().max().item() for a, b in zip(st_g, st_r)
               if a.dtype != torch.bool)
    dones_equal = all(torch.equal(a.cpu(), b) for a, b in zip(st_g, st_r)
                      if a.dtype == torch.bool)
    merr = max(abs(float(m_g[k]) - float(m_r[k])) / max(1.0, abs(float(m_r[k]))) for k in m_r)
    perr, rounding, pmax = 0.0, 0, 0.0
    for a, b, g in zip(ac_g.parameters(), ac_r.parameters(), grads):
        dd = (a.detach().cpu() - b.detach()).abs()
        held = g.abs() > 1e-4 * g.abs().max()
        perr = max(perr, dd[held].max().item() if held.any() else 0.0)
        pmax = max(pmax, dd.max().item())
        rounding += int((~held).sum())
    log(f"PPO {label}: one iteration ({PPO_ENVS} envs x {rollout}) card vs CPU from the "
        f"same weights, states and draws: max |state diff| {serr:.3g}, max metric diff "
        f"{merr:.3g}, max |param diff| {perr:.3g} where the first gradient is past 1e-4 of "
        f"its tensor's largest ({rounding} parameters below it, max {pmax:.3g})")
    require(serr <= 1e-4 and dones_equal and merr <= 1e-4 and perr <= 1e-4
            and pmax <= 2 * cfg.lr * cfg.epochs_per_iter,
            f"PPO {label}: the card's iteration disagrees with the CPU's")
    return dict(state_err=serr, metric_err=merr, param_err=perr)


def phase_ppo(dev, smi):
    """train_ppo at 100 envs, rollouts of 128 on VecVisionEnv and on the
    quadrotor env's ppo_spec: one iteration, then PPO_ITERS timed
    (iterations/s, env steps/s), each iteration's metrics finite; one
    iteration held card against CPU for each env."""
    params = rl_env_params()
    specs = {
        "vision": lambda d: ppo.vision_env_spec(params, 5.0, device=d),
        "quadrotor": lambda d: quadrotor_env.ppo_spec(device=d),
    }
    numbers = {}
    for label, spec_of in specs.items():
        cfg = ppo.PPOConfig(num_envs=PPO_ENVS, rollout_len=PPO_ROLLOUT, lr=3e-4)
        ppo.train_ppo(None, cfg, n_iters=1, spec=spec_of(dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = ppo.train_ppo(None, cfg, n_iters=PPO_ITERS, seed=1, spec=spec_of(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        its = PPO_ITERS / wall
        log(f"PPO {label}: {PPO_ITERS} iterations of {PPO_ENVS} envs x {PPO_ROLLOUT} steps, "
            f"{cfg.epochs_per_iter} epochs, in {wall:.2f} s = {its:.3f} iterations/s, "
            f"{its * PPO_ENVS * PPO_ROLLOUT:.0f} env steps/s; last metrics {hist[-1]} on {smi}")
        require(len(hist) == PPO_ITERS and all(np.isfinite(v) for h in hist for v in h.values()),
                f"PPO {label}: metrics")
        numbers[label] = dict(iterations_per_s=its, env_steps_per_s=its * PPO_ENVS * PPO_ROLLOUT,
                              **_ppo_iteration_card_vs_cpu(dev, spec_of, label,
                                                           PPO_HOLD_ROLLOUT[label]))
    return numbers



@contextlib.contextmanager
def driver_precision():
    """The drivers set the port's precision to TF32 (the JAX drivers'
    "default"), as a driver's process keeps it; put it back after."""
    saved = get_precision()
    try:
        yield
    finally:
        set_precision(saved)


def _launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def _zero_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _singles_err(model, kept, dev, G) -> float:
    """Max |velocity diff| of the kept batched ticks against G single eager
    streams on the same frames and resets."""
    err = 0.0
    for g in range(G):
        single = StreamingPipeline(model, desvel=4.0, device=dev, graph=False)
        for frames, mask, vels in kept:
            if mask[g]:
                single.reset()
            v, _ = single.step_frame(frames[g])
            err = max(err, (v - vels[g]).abs().max().item())
    return err


def phase_protocol(dev, smi):
    """train_policy's protocol evaluation at the JAX record's settings
    through the driver's own _protocol_trials and eval_report, its
    pipelines recorded: success, crashes, finish times, |vy|, ticks/s,
    quad sim steps/s, launches; the first batch's first ticks against
    single eager streams (TF32, as flown) and, replayed in f32 through a
    G = 20 graph, against f32 single streams."""
    recorders = []
    build = train_policy._build_pipeline

    def recorded(ckpt, G, desvels, device=None):
        rec = _TickRecorder(build(ckpt, G, desvels, device), 0 if recorders else CL_CHECK_TICKS)
        recorders.append(rec)
        return rec

    _free_device_memory()
    train_policy._build_pipeline = recorded
    try:
        with driver_precision():
            _zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = train_policy._protocol_trials(JOINT_CHECKPOINT, PROTOCOL_TRIALS,
                                                    PROTOCOL_BATCH, PROTOCOL_SEED, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
            require(get_precision() == "tf32", "the protocol did not fly in TF32")
            first = recorders[0]
            tf32_err = _singles_err(first.pipe.model, first.kept, dev, PROTOCOL_BATCH)
    finally:
        train_policy._build_pipeline = build
    report = train_policy.eval_report(results, JOINT_CHECKPOINT, 4.0, "first_order")
    ticks = [r.ticks for r in recorders]
    sim_steps = sum(t * r.pipe.G * 6 for t, r in zip(ticks, recorders))
    success = round(report["success_rate"] * PROTOCOL_TRIALS)
    finish = [t for t in report["time_to_finish"] if t is not None]

    # the same first ticks in f32: a G = 20 graph replay against f32 singles
    model = first.pipe.model
    f32 = BatchedStreamingPipeline(model, PROTOCOL_BATCH, desvel=4.0, device=dev)
    replay = []
    for frames, mask, _ in first.kept:
        vels, _ = f32.step_frames(frames, reset_mask=mask)
        replay.append((frames, mask, vels.clone()))
    f32_err = _singles_err(model, replay, dev, PROTOCOL_BATCH)
    del f32, recorders, first
    lstm = {n: launches[n] for n in ("K4 cluster", "K5 cluster", "K4 L2", "K5 L2",
                                     "K4 grid", "K5 grid")}
    log(f"protocol evaluation (train_policy eval), {PROTOCOL_TRIALS} trials in batches of "
        f"{PROTOCOL_BATCH}, seed {PROTOCOL_SEED}, policy_best.pth, TF32: {success} of "
        f"{PROTOCOL_TRIALS} successful (JAX record: 40 of 40), crashes {report['crashes']}, "
        f"finish times {min(finish) if finish else None}-{max(finish) if finish else None} s, "
        f"mean |vy| {report['mean_abs_vy_cmd']}, p95 |vy| {report['p95_abs_vy_cmd']}; "
        f"{sum(ticks)} ticks ({ticks}) in {wall:.2f} s = {sum(ticks) / wall:.2f} ticks/s, "
        f"{sim_steps / wall:.1f} quad sim steps/s; LSTM launches {lstm}; other launches "
        f"{ {n: c for n, c in launches.items() if c and n not in lstm} }; first "
        f"{CL_CHECK_TICKS} ticks of G={PROTOCOL_BATCH} against single eager streams: TF32 max "
        f"|diff| {tf32_err:.3e}, f32 replay {f32_err:.3e} on {smi}")
    require(all(np.isfinite(r["log"]).all() and r["log"].shape[1] == 21 for r in results)
            and len(results) == PROTOCOL_TRIALS, "protocol logs")
    require(launches["K4 cluster"] > 0, "the protocol's policy launched no K4 (cluster route)")
    require(tf32_err <= PROTOCOL_TF32_ATOL and f32_err <= VEL_ATOL,
            "the G=20 batched policy disagrees with single streams")
    require(success >= PROTOCOL_MIN_SUCCESS,
            f"{success} of {PROTOCOL_TRIALS} protocol trials successful")
    return dict(launches=launches, success=success, crashes=sum(report["crashes"]),
                finish_min=min(finish) if finish else None,
                finish_max=max(finish) if finish else None,
                mean_abs_vy=report["mean_abs_vy_cmd"], p95_abs_vy=report["p95_abs_vy_cmd"],
                ticks_per_s=sum(ticks) / wall, sim_steps_per_s=sim_steps / wall,
                tf32_err=tf32_err, f32_err=f32_err)


def _forest_fields(seed, n):
    """The fields datagen.generate_trajectories draws for one batch of n
    from ``seed``."""
    rng = np.random.default_rng(seed)
    return [generate_forest(rng, num_obstacles=int(rng.integers(25, 41)), trees=True)
            for _ in range(n)]


def _log_losses(workspace):
    """Every epoch's train and validation loss in a Learner's log.txt."""
    with open(os.path.join(workspace, "log.txt")) as fh:
        text = fh.read()
    return ([float(x) for x in re.findall(r"\] Completed epoch .*?ep_loss = ([^,]+),", text)],
            [float(x) for x in re.findall(r"\] Validated epoch .*?val_loss = ([^,]+),", text)])


def phase_driver_data(dev, smi):
    """DAgger -> data -> training through the drivers: train_policy's
    dagger trials and dagger_trajectories, datagen's
    generate_trajectories (state mode) and traj_flows, both handed to
    cache_dataset with the joint configuration's dataloader arguments; then
    e2e_demo.main, whose Learner reads its data phase's cache: losses
    finite, a checkpoint written, K4 launched in validation."""
    root = os.path.join(REPO, "build", f"drivers_smoke_{os.getpid()}")
    out = train_policy.OUT
    try:
        train_policy.OUT = root
        with driver_precision():
            t0 = time.perf_counter()
            results = train_policy._protocol_trials(JOINT_CHECKPOINT, DAGGER_TRIALS,
                                                    DAGGER_TRIALS, 50000, mode="dagger",
                                                    device=dev)
            dagger_s = time.perf_counter() - t0
        dagger = train_policy.dagger_trajectories(results)
        require(len(dagger) > 0 and all((t["data"][:, -1] == 0).all() and t["evs"] is not None
                                        for t in dagger), "dagger trajectories")
        _free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        states = datagen.generate_trajectories(DATAGEN_TRIALS, DATAGEN_TRIALS, mode="state",
                                               seed=0, device=dev)
        torch.cuda.synchronize()
        datagen_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        fields = _forest_fields(0, DATAGEN_TRIALS)
        t0 = time.perf_counter()
        for traj in states[:FLOW_TRAJS]:
            i = int(traj["name"].rsplit("_", 1)[1])
            traj["flows"] = datagen.traj_flows(traj, fields[i], device=dev)
            require(traj["flows"].shape == traj["ims"].shape + (2,)
                    and np.isfinite(traj["flows"].astype(np.float32)).all()
                    and np.abs(traj["flows"].astype(np.float32)).max() > 1.0, "flows")
        flow_s = time.perf_counter() - t0
        cfg = train_policy._joint_cfg(argparse.Namespace(extra_data=None, epochs=1, lr=None,
                                                         logsub="joint"))
        t0 = time.perf_counter()
        train, val, _ = cache_dataset(os.path.join(cfg.datadir, "drivers"), dagger + states,
                                      logger=lambda m: None, **dataloader_kwargs(cfg))
        cache_s = time.perf_counter() - t0
        frames = sum(len(t["ims"]) for t in dagger + states)
        log(f"dagger: {DAGGER_TRIALS} trials in {dagger_s:.1f} s, {len(dagger)} trajectories; "
            f"datagen (state): {DATAGEN_TRIALS} trials in {datagen_s:.1f} s = "
            f"{DATAGEN_TRIALS / datagen_s * 60:.1f} trials/min, peak memory {peak:.2f} GiB above "
            f"the inputs, {len(states)} trajectories; flow of {FLOW_TRAJS} in {flow_s:.2f} s; "
            f"cache_dataset of {frames} frames with the joint configuration's dataloader "
            f"arguments in {cache_s:.1f} s: train {train.ims.shape}, val {val.ims.shape} on {smi}")
        require(train.ims.shape[0] > 0 and val.ims.shape[0] > 0
                and all(np.isfinite(e).all() for e in train.evs), "cached splits")

        _free_device_memory()
        _zero_launches()
        t0 = time.perf_counter()
        with driver_precision():
            e2e = e2e_demo.main(["--out", os.path.join(root, "e2e"), *E2E_ARGS, "--device",
                                 str(dev)])
        e2e_s = time.perf_counter() - t0
        launches = _launches()
        ws = os.path.dirname(e2e["checkpoint"])
        train_losses, val_losses = _log_losses(ws)
        with open(os.path.join(ws, "log.txt")) as fh:
            cache_hit = "Cache hit" in fh.read()
        log(f"e2e_demo {' '.join(E2E_ARGS)} in {e2e_s:.1f} s (data {e2e['data_s']:.1f}, train "
            f"{e2e['train_s']:.1f}, eval {e2e['eval_s']:.1f}): checkpoint "
            f"{os.path.basename(e2e['checkpoint'])}, train losses {train_losses}, validation "
            f"losses {val_losses}, the Learner's cache hit {cache_hit}, vision "
            f"{e2e['summaries']}; launches {({n: c for n, c in launches.items() if c})}")
        require(cache_hit, "e2e_demo's Learner missed its data phase's cache")
        require(os.path.exists(e2e["checkpoint"]) and train_losses and val_losses
                and np.isfinite(train_losses + val_losses).all(), "e2e_demo's training")
        require(launches["K4 cluster"] > 0, "e2e_demo launched no K4 (validation, evaluation)")
        return dict(launches=launches, datagen_trials_per_min=DATAGEN_TRIALS / datagen_s * 60,
                    datagen_peak_gib=peak, e2e_s=e2e_s, dagger_s=dagger_s,
                    trajectories=dagger)
    finally:
        train_policy.OUT = out
        shutil.rmtree(root, ignore_errors=True)


def _zero_state(model):
    """V(phi)'s zero (h, c) on ``model``'s device: given to a forward, it
    runs eagerly (its serving graph takes only a state of None)."""
    dev = model.nn_fc2.weight_orig.device
    return torch.zeros(3, 128, device=dev), torch.zeros(3, 128, device=dev)


def _k4_vs_plain(lstm, run):
    """``run()`` (a forward through the LSTM module ``lstm`` on the card) at
    full f32, K4's input and output recorded, then the plain loop on that
    input: (max |diff| of the output and h, of c over max(1, max|c|)).
    Requires that the run launched K4 once, on the cluster route."""
    seen = {}
    hook = lstm.register_forward_hook(
        lambda m, args, out: seen.update(x=args[0], hidden=args[1] if len(args) > 1 else None,
                                         out=out))
    saved = get_precision()
    set_precision("highest")
    try:
        lstm_stacked_cluster.launches = 0
        with torch.inference_mode():
            run()
        torch.cuda.synchronize()
        require(lstm_stacked_cluster.launches == 1, "the probe's LSTM did not launch K4 once")
        with torch.inference_mode():
            ref, (h, c) = lstm_loop(dict(lstm.named_parameters()), seen["x"], seen["hidden"],
                                    lstm.num_layers, lstm.hidden_size)
    finally:
        hook.remove()
        set_precision(saved)
    out, (hk, ck) = seen["out"]
    return (max((out - ref).abs().max().item(), (hk - h).abs().max().item()),
            (ck - c).abs().max().item() / max(1.0, c.abs().max().item()))


def _probe_held(dev, label, model_of, kind, traj, tf32_vels):
    """The open-loop probe's first PROBE_HELD frames on the card against the
    CPU (``model_of(device)`` builds the model): at full f32 within 1e-4,
    and the card's run at the tool's TF32 (``tf32_vels``) within
    PROBE_TF32_ATOL."""
    frames, _gt, dv, _ = openloop_probe.probe_inputs(traj, kind, PROBE_HELD)
    cpu, card = model_of(torch.device("cpu")), model_of(dev)
    saved = get_precision()
    set_precision("highest")  # after the builds, which set the drivers' TF32
    try:
        rv, rd = openloop_probe.run_traj(cpu, frames, dv, kind=kind)
        gv, gd = openloop_probe.run_traj(card, frames, dv, kind=kind)
    finally:
        set_precision(saved)
    err = max(np.abs(gv - rv).max(), np.abs(gd - rd).max())
    tf32 = np.abs(tf32_vels[:PROBE_HELD] - rv).max()
    log(f"{label}: first {PROBE_HELD} frames card against CPU, f32 max|diff| {err:.3e} (atol "
        f"{VEL_ATOL}); the tool's TF32 run against the CPU {tf32:.3e} (atol {PROBE_TF32_ATOL})")
    require(err <= VEL_ATOL, f"{label}: the card's f32 probe disagrees with the CPU's")
    require(tf32 <= PROBE_TF32_ATOL, f"{label}: the card's TF32 probe disagrees with the CPU's")


def phase_probes(dev, smi, trajs):
    """The three probes of evfly_tpu_torch/tools on the DAgger trajectories,
    each through its own functions with the kernels' launches counted:
    overfit_probe at its defaults on the longest trajectory (its final
    check's K4 output against the plain loop); openloop_probe's two kinds
    over PROBE_FRAMES frames, carried and reset (ms a frame; the first
    frames against the CPU); bf16_accept at 256 windows (each arm's K4
    output against the plain loop).  Reports are printed, and must be
    finite; ``overfit_ok`` and ``accept`` are reported, not required."""
    traj = max(trajs, key=lambda t: len(t["depths"]))
    launches = {k: 0 for k in KERNELS}

    def counted(fn):
        _zero_launches()
        out = fn()
        torch.cuda.synchronize()
        for k, n in _launches().items():
            launches[k] += n
        return out

    numbers = {}
    with driver_precision():
        # stamped at each log line: the header, then after steps 0, 10, ..., 140, 149
        stamps = []
        t0 = time.perf_counter()
        out = counted(lambda: overfit_probe.overfit(
            traj, steps=OVERFIT_STEPS, device=dev,
            log=lambda m: (stamps.append(time.perf_counter()), log(m))))
        total = time.perf_counter() - t0
        n_frames = out["vel"].shape[0]
        rep = overfit_probe.report(out)
        s_step = (stamps[-1] - stamps[1]) / (OVERFIT_STEPS - 1)
        log(f"overfit_probe on {traj['name']} ({n_frames} frames, {OVERFIT_STEPS} steps, chunk "
            f"32, lr 1e-3) in {total:.1f} s, {s_step:.4f} s a step (steps 1-{OVERFIT_STEPS - 1}) "
            f"on {smi}, TF32: {json.dumps(rep)}")
        require(all(np.isfinite(rep[k]) for k in ("floor_mse", "final_vel_mse", "pred_vy_std",
                                                    "corr_vy")), "overfit_probe's report")
        if not rep["overfit_ok"]:
            log("overfit_probe: overfit_ok is false (a finding, not a failure)")
        model = out["model"]
        x, _gt, dv, _nvy, _floor = overfit_probe.probe_frames(traj, n_frames)
        inp = torch.clamp(torch.as_tensor(x, device=dev) * 2.0, 0.0, 1.0)
        dv = torch.as_tensor(dv, device=dev)
        err, cerr = _k4_vs_plain(model.lstm, lambda: model(inp, dv, None, _zero_state(model)))
        log(f"overfit_probe's final check (T = {n_frames}): K4 against the plain loop, out and h "
            f"max|diff| {err:.3e}, c {cerr:.3e} relative (atol {K4_ATOL})")
        require(err <= K4_ATOL and cerr <= K4_ATOL, "overfit_probe's K4 disagrees with the plain loop")
        numbers["overfit_s_per_step"] = s_step
        numbers["overfit"] = rep
        del model, out
        _free_device_memory()

        for kind, ckpt in (("joint", JOINT_CHECKPOINT), ("vit_depth", CHECKPOINT)):
            model = openloop_probe.build(ckpt, kind, dev)
            frames, _gt, dvs, _ = openloop_probe.probe_inputs(traj, kind, PROBE_FRAMES)
            openloop_probe.run_traj(model, frames[:2], dvs[:2], kind=kind)  # warm-up
            t0 = time.perf_counter()
            tf32_vels, _ = counted(lambda: openloop_probe.run_traj(model, frames, dvs, kind=kind))
            ms = (time.perf_counter() - t0) / len(frames) * 1e3
            rep = counted(lambda: openloop_probe.probe_trajectory(
                model, traj, traj["name"], kind, PROBE_FRAMES, PROBE_CHUNK))
            log(f"openloop_probe {kind} over {len(frames)} frames: {ms:.2f} ms a frame eager "
                f"(carried, TF32) on {smi}; report {json.dumps(rep)}")
            require(np.isfinite(rep["carried"]["mean_abs_vy_pred"])
                    and np.isfinite(rep["chunk_reset"]["mean_abs_vy_pred"])
                    and rep["carried"]["frames"] == len(frames), f"openloop_probe {kind}'s report")
            _probe_held(dev, f"openloop_probe {kind}", lambda d: openloop_probe.build(ckpt, kind, d),
                        kind, traj, tf32_vels)
            numbers[f"openloop_{kind}_ms_per_frame"] = ms
            ol_frames = len(frames)
            del model

        set_precision(train_policy.PRECISION)
        model = LSTMNetVIT(device=dev).eval()
        small, desvel = bf16_accept.inputs(bf16_accept.WINDOWS, dev)
        vf, vb = counted(lambda: bf16_accept.arms(model, small, desvel))
        rep = bf16_accept.accept_report(vf, vb)
        print(json.dumps(rep), flush=True)
        log(f"bf16_accept on {smi}, both arms TF32: {json.dumps(rep)} (accept is reported, "
            "not required)")
        require(np.isfinite(rep["max_abs_dvel_normalized"])
                and rep["windows"] == bf16_accept.WINDOWS,
                "bf16_accept's report")
        b16 = bf16_accept.bf16enc(model)
        for arm, m, x in (("f32", model, small), ("bf16", b16, small.to(torch.bfloat16))):
            err, cerr = _k4_vs_plain(m.lstm, lambda: m(x, desvel, None, _zero_state(m)))
            log(f"bf16_accept's {arm} arm (T = {bf16_accept.WINDOWS}): K4 against the plain "
                f"loop, out and h "
                f"max|diff| {err:.3e}, c {cerr:.3e} relative (atol {K4_ATOL})")
            require(err <= K4_ATOL and cerr <= K4_ATOL,
                    f"bf16_accept's {arm} arm: K4 disagrees with the plain loop")
        numbers["bf16"] = rep
    log(f"probes' launches: {({n: c for n, c in launches.items() if c})}")
    # one a frame of three runs of PROBE_FRAMES frames a kind (timed, carried,
    # reset; each from a given zero state, so eager); the overfit check and
    # the two arms are served by V(phi)'s graphs: WARMUP_STEPS + 1 each
    require(launches["K4 cluster"] == 3 * (WARMUP_STEPS + 1) + 2 * 3 * ol_frames,
            "the probes' K4 launches")
    return dict(launches=launches, **numbers)


def phase_driver_rl(dev, smi):
    """train_rl.main at RL_ITERS iterations for each env (the artifact's
    keys, finite), and greedy_rollout on the card against the CPU from the
    same weights and starts."""
    numbers = {}
    args = argparse.Namespace(seed=0, obstacles=40, horizon_s=20.0)
    cpu = torch.device("cpu")
    for env in ("vision", "quadrotor"):
        t0 = time.perf_counter()
        result, ac = train_rl.main(["--env", env, "--iters", str(RL_ITERS), "--device",
                                    str(dev)])
        wall = time.perf_counter() - t0
        require(all(np.isfinite(v) for v in result.values() if isinstance(v, float))
                and len(result["history"]) == RL_ITERS, f"train_rl {env}: artifact")
        specs = [train_rl.build_vision(args, d)[1] if env == "vision"
                 else train_rl.build_quadrotor(args, d)[0] for d in (dev, cpu)]
        ac_cpu = ppo.ActorCritic(act_dim=specs[1].act_dim, obs_dim=specs[1].obs_dim, device=cpu)
        ac_cpu.load_state_dict({k: v.cpu() for k, v in ac.state_dict().items()})
        starts = specs[1].reset(torch.Generator().manual_seed(9), RL_HOLD_ENVS)
        steps = train_rl.greedy_steps(env, 20.0) if env == "vision" else PPO_HOLD_ROLLOUT[env]
        out = []
        for spec, model, d in zip(specs, (ac, ac_cpu), (dev, cpu)):
            t1 = time.perf_counter()
            st, ret, alive = train_rl.greedy_rollout(spec, model,
                                                     type(starts)(*(x.to(d) for x in starts)),
                                                     steps)
            out.append((st, ret.cpu(), alive.cpu(), time.perf_counter() - t1))
        (sg, rg, ag, tg), (sc, rc, ac_, tc) = out
        pos = lambda s: (s.pos if env == "vision" else s.p).cpu()
        perr = (pos(sg) - pos(sc)).abs().max().item()
        rerr = ((rg - rc).abs() / rc.abs().clamp_min(1.0)).max().item()
        log(f"train_rl {env}: {RL_ITERS} iterations of 100 x 128 and the greedy evaluation in "
            f"{wall:.1f} s: {json.dumps({k: v for k, v in result.items() if k != 'history'})}; "
            f"greedy_rollout of {RL_HOLD_ENVS} envs x {steps} steps card vs CPU: max |pos diff| "
            f"{perr:.3g}, max return diff {rerr:.3g} (relative past 1), alive equal "
            f"{torch.equal(ag, ac_)} ({tg:.2f} s on the card, {tc:.2f} s on the CPU) on {smi}")
        require(perr <= RL_ATOL and rerr <= RL_ATOL and torch.equal(ag, ac_),
                f"train_rl {env}: the card's greedy rollout disagrees with the CPU's")
        numbers[env] = dict(pos_err=perr, ret_err=rerr, wall_s=wall)
    return numbers


def phase_driver_hil(dev, smi):
    """hil_real_model's episode with policy_best.pth: tracking, latency,
    launches."""
    _free_device_memory()
    _zero_launches()
    with driver_precision():
        report = hil_real_model.hil_episode(JOINT_CHECKPOINT, HIL_DRIVER_SECONDS, 4.0, HIL_SEED,
                                            30, False, dev)
    launches = _launches()
    log(f"hil_real_model, policy_best.pth, {HIL_DRIVER_SECONDS} s, seed {HIL_SEED}: "
        f"{json.dumps(report)}; launches {({n: c for n, c in launches.items() if c})} on {smi}")
    require(not report["collided"] and not report["guard_stopped"]
            and report["final_x_m"] > HIL_MIN_X, "the HIL episode with the trained model")
    require(launches["K4 cluster"] + launches["K5 cluster"] > 0, "HIL launched no K4/K5")
    return dict(launches=launches, p50_ms=report["tick_latency_ms_p50"],
                p95_ms=report["tick_latency_ms_p95"], final_x_m=report["final_x_m"])


def _report_held(name, got, ref):
    """A report against its JAX record (REPORT_SHARE's rule)."""
    bad = []
    for k, r in ref.items():
        g = got[k]
        if k.startswith("count_quantiles") or k == "adaptive_factor_p50_p95_max" or k in (
                "max_abs_count_diff",):
            ok = np.allclose(g, r, rtol=0, atol=1.0)
        elif isinstance(r, float):
            ok = abs(g - r) <= 4 * REPORT_SHARE * max(abs(r), 1.0)
        else:
            ok = g == r
        if not ok:
            bad.append((k, g, r))
    diffs = {k: abs(got[k] - r) / max(abs(r), 1.0) for k, r in ref.items()
             if isinstance(r, float)}
    log(f"{name} against the JAX record: |diff| / max(|record|, 1) {json.dumps(diffs)}; "
        f"outside the bound {bad}")
    require(not bad, f"{name} disagrees with its JAX record")
    return diffs


def phase_reports(dev, smi):
    """esim_divergence_report and upsample_report at their defaults on the
    card against the JAX records."""
    out = {}
    for name, mod in (("esim_divergence", esim_divergence_report),
                      ("upsample_report", upsample_report)):
        t0 = time.perf_counter()
        got = mod.report(device=dev)
        wall = time.perf_counter() - t0
        with open(os.path.join(REPO, "artifacts", f"{name}.json")) as fh:
            ref = json.load(fh)
        log(f"{name} report in {wall:.2f} s on {smi}")
        out[name] = max(_report_held(name, got, ref).values())
    return out


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
    with Phase("K4 and K5 on their three routes vs plain"):
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
        launches, l2_launches = phase_main_path(dev)
    with Phase("fused rung"):
        rung_launches = phase_fused_rung(dev)
    with Phase("streaming path"):
        stream_launches = phase_streaming(dev, model)
    with Phase(f"batched streaming, {STREAMS} streams"):
        phase_batched(dev, model)
    with Phase("graph step"):
        phase_graph_step(dev, model)
    with Phase("deployment loop (HIL)"):
        tick_ms = phase_hil(dev, model, smi)
    with Phase("training: Learner.train_loop, joint model at full width"):
        # what the streaming phases' graph captures leave reserved: a cuBLAS
        # workspace on each stream a warm-up ran on pins a cached segment
        _free_device_memory()
        reserved = torch.cuda.memory_reserved() / 2**30
        log(f"reserved after the streaming phases: {reserved:.3f} GiB (allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB)")
        require(reserved <= RESERVED_AFTER_STREAMING_GIB,
                f"the streaming phases left {reserved:.1f} GiB reserved")
        train_launches, train_numbers = phase_training(dev, smi)
    _free_device_memory()
    with Phase(f"data parallel: Learner.train_loop with dp_chunks_per_device = {DP_CHUNKS}, "
               f"the G-chunk step, G = {DP_SWEEP}, the dry run"):
        dp_launches, dp_numbers, dp_dry = phase_data_parallel(dev, smi, train_numbers)
    with Phase("velocity heads: configurations A and B at full width"):
        (head_errs, head_times, head_stream, head_train, head_val,
         head_numbers) = phase_velocity_heads(dev, flush, smi)
    _free_device_memory()
    with Phase("model zoo served: ConvNet, LSTMNet, ViT, UNetConvLSTMNet, LegacyTransformer"):
        zoo_rates = phase_zoo(dev, smi)
    with Phase("real recording -> training trajectory: EVT3, package_real_sequence, "
               "K1 over time windows"):
        dataset_launches, k1w = phase_dataset(dev, flush, smi)
    _free_device_memory()
    with Phase("event generation: esim, esim_flow, difflog on a 49-frame trajectory"):
        gen_ms = phase_event_generation(dev, smi)
    _free_device_memory()
    with Phase(f"closed loop, vision: {CL_STREAMS} trials in lockstep, joint model at "
               f"{H}x{W}"):
        closed = phase_closed_loop_vision(dev, model, smi)
    with Phase(f"closed loop, state: {STATE_TRIALS} trials batched against run_trial"):
        phase_closed_loop_state(dev, smi)
    with Phase(f"run_evaluation: {EVAL_TRIALS} vision trials"):
        phase_evaluation(dev, model, smi)
    _free_device_memory()
    with Phase(f"PPO: VecVisionEnv and QuadrotorEnv at {PPO_ENVS} envs x {PPO_ROLLOUT}"):
        rl_numbers = phase_ppo(dev, smi)
    _free_device_memory()
    with Phase(f"protocol evaluation (train_policy eval): {PROTOCOL_TRIALS} trials in batches "
               f"of {PROTOCOL_BATCH}, seed {PROTOCOL_SEED}, policy_best.pth"):
        protocol = phase_protocol(dev, smi)
    _free_device_memory()
    with Phase("DAgger -> data -> training: train_policy dagger, datagen, cache_dataset, "
               "e2e_demo"):
        driver_data = phase_driver_data(dev, smi)
    _free_device_memory()
    with Phase(f"probes: overfit_probe at its defaults, openloop_probe (joint, vit_depth) over "
               f"{PROBE_FRAMES} frames, bf16_accept at {bf16_accept.WINDOWS} windows"):
        probes = phase_probes(dev, smi, driver_data.pop("trajectories"))
    _free_device_memory()
    with Phase(f"RL driver: train_rl, {RL_ITERS} iterations for each env, greedy card vs CPU"):
        driver_rl = phase_driver_rl(dev, smi)
    with Phase(f"HIL with the trained model: hil_real_model, {HIL_DRIVER_SECONDS} s"):
        driver_hil = phase_driver_hil(dev, smi)
    _free_device_memory()
    with Phase("reports: esim_divergence_report and upsample_report at their defaults"):
        reports = phase_reports(dev, smi)
    signal.alarm(0)
    # every kernel's launches on the drivers' paths, by its key in KERNELS
    driver_launches = lambda key: dict(
        protocol_launches=protocol["launches"][key],
        e2e_demo_launches=driver_data["launches"][key],
        probes_launches=probes["launches"][key],
        hil_driver_launches=driver_hil["launches"][key])

    def entry(name, source, replaces, n, key, **times):
        """A kernel's JSON entry; ``key`` names it in KERNELS, for its
        launches over the training phase's train_loop."""
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=n,
                    training_launches=train_launches[key],
                    dp_train_loop_launches=dp_launches[key],
                    closed_loop_launches=closed["launches"][key], **driver_launches(key),
                    **times)

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
    k1_16, k1_band = dict(k1["cluster16"]), dict(k1["band"])
    kernels = [
        entry("hist_frame_cluster (K1, cluster kernel on 8 CTAs)", vox,
              "evfly_tpu/ops/voxelizer.py:153", stream_launches["K1 cluster"], "K1 cluster8",
              **k1["cluster8"]),
        entry("hist_frame_cluster (K1, cluster kernel on 16 CTAs: two thresholds at 640x480, "
              "one at 1280x720; event_histogram, 1 x 5,000 events at 640x480)", vox,
              "evfly_tpu/ops/voxelizer.py:153", k1_16.pop("launches"), "K1 cluster16", **k1_16),
        entry("hist_frame (K1, band route: hist_band_partition_kernel + hist_band_kernel; "
              "event_histogram, 1 x 5,000 events at 1280x720, two thresholds)", vox,
              "evfly_tpu/ops/voxelizer.py:153", k1_band.pop("launches"), "K1 band",
              streaming_forced_launches=stream_launches["K1 band"], **k1_band),
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
    # the head LSTM of configuration B (H = 768, L = 1) on the grid route
    # and on the L2 route of before, timed at its streaming step's shape
    # (one stream, T = 1); launches over B's streaming run in the kernel's
    # mode (the L2 route's over its forced timed runs), B's batched run and
    # B's validation
    for route in ("grid", "l2"):
        for mode in ("stacked", "wavefront"):
            label, kernel, _ = LSTM_ROUTES[(mode, route)]
            t = head_times[(mode, 1, 1)]
            run = mode if route == "grid" else f"{mode} forced l2"
            kernels.append(dict(
                name=f"{kernel.__name__} ({label}, H={HEAD_H} L=1: the velocity head's LSTM"
                     + (", forced)" if route == "l2" else ")"),
                route="cuda", source=lstm_src,
                replaces="evfly_tpu/ops/lstm_pallas.py:" + ("111" if mode == "stacked" else "203"),
                launches=head_stream[run][label], batched_launches=head_stream["batched"][label],
                training_launches=head_train[label], dp_train_loop_launches=dp_launches[label],
                closed_loop_launches=closed["launches"][label], **driver_launches(label),
                validation_launches=head_val if (mode, route) == ("stacked", "grid") else 0,
                max_abs_err=head_errs[(mode, route)], ms=t[route], plain_ms=t[f"plain_{route}"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"]))
    # K1 over time windows: launches on the dataset path
    # (package_real_sequence of the 640x480 recording: one threshold on 8
    # CTAs, two on 16; event_frames_from_windows at 1280x720 with two
    # thresholds on the band route), timed at 260x346 (8 CTAs), shape A (16)
    # and shape B (the band route)
    for route, kernel, shape in (
            ("cluster8", "hist_frame_cluster_kernel on 8 CTAs", "60 windows at 260x346"),
            ("cluster16", "hist_frame_cluster_kernel on 16 CTAs",
             "shape A: 60 windows at 640x480, two thresholds"),
            ("band", "the band route", "shape B: 60 windows at 1280x720, two thresholds")):
        kernels.append(dict(
            name=f"hist_frame_windows (K1 over time windows, {kernel}, window offsets; {shape})",
            route="cuda", source=vox, replaces="evfly_tpu/ops/voxelizer.py:153",
            launches=dataset_launches[route],
            training_launches=train_launches[f"K1 windows {route}"],
            dp_train_loop_launches=dp_launches[f"K1 windows {route}"],
            closed_loop_launches=closed["launches"][f"K1 windows {route}"],
            **driver_launches(f"K1 windows {route}"), **k1w[route]))
    closed_numbers = {k: v for k, v in closed.items() if k != "launches"}
    log(f"done in {time.perf_counter() - _T0:.1f}s; p50 ms per HIL tick {tick_ms}"
        + f"; zoo windows/s {zoo_rates}; event generation ms per trajectory {gen_ms}"
        + f"; closed loop {closed_numbers}; PPO {rl_numbers}"
        + f"; protocol {({k: v for k, v in protocol.items() if k != 'launches'})}"
        + f"; driver data {({k: v for k, v in driver_data.items() if k != 'launches'})}"
        + f"; probes {({k: v for k, v in probes.items() if k != 'launches'})}"
        + f"; driver RL {driver_rl}; driver HIL "
        f"{({k: v for k, v in driver_hil.items() if k != 'launches'})}; reports {reports}"
        + f"; training {train_numbers}; data parallel {dp_numbers}, dry run {dp_dry}"
        + f"; velocity heads {head_numbers}, head LSTM ms (grid / "
        f"L2 / cuDNN) " + ", ".join(f"{m} G={G} T={T_} {t['grid']:.4f} / {t['l2']:.4f} / "
                                    f"{t['library_ms']:.4f}"
                                    for (m, G, T_), t in head_times.items()))
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
