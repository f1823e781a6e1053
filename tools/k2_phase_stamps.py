"""Phase stamps of K2's cluster kernel (``hist_scaled_cluster_kernel``) on a
CUDA card: when each CTA ends each phase, and whether the frame writes of
one wave of windows overlap the binning of the next.

    python3 tools/k2_phase_stamps.py [--windows 256] [--events 5000] [--cluster 2]

Builds the port's kernels with ``-DEVFLY_PHASE_STAMPS`` (a library of its
own under ``build/``), launches K2 once to warm up and once stamped, checks
that frame and quantile against the plain version, and prints the median
time of each phase per CTA, the spread of the windows' starts, and a
timeline of how many CTAs bin events and how many write their band at
once.  Also times K2 with and without the stamps (CUDA events, L2 flushed
by a 64 MiB write, as ``chip_smoke.py`` times).  Exits 1 without a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from evfly_tpu_torch.ops import _build, voxelizer  # noqa: E402

PHASES = ("zero + barrier 1", "bin events + barrier 2", "scan + barrier 3", "bisection",
          "write band")
STAMPS_PER_CTA = 8  # csrc/voxelizer.cu kStampsPerCta: phases 0..5, SM id last


def launch(lib, x, y, p, H, W, cluster):
    B, N = x.shape
    out = torch.empty(B, H, W, device=x.device)
    q = torch.empty(B, device=x.device)
    status = lib.evfly_hist_scaled_cluster(
        x.data_ptr(), y.data_ptr(), p.data_ptr(), out.data_ptr(), q.data_ptr(), B, N, H, W,
        cluster, voxelizer._kth(0.97, H * W), 0.2, 18, _build.stream_of(x.device))
    _build.check("evfly_hist_scaled_cluster", status)
    return out, q


def device_ms(fn, reps=20):
    """Median device time of ``fn``, L2 flushed before each call; a spin
    kernel ahead keeps the card busy while the host queues the call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        flush.fill_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=256)
    ap.add_argument("--events", type=int, default=5000)
    ap.add_argument("--cluster", type=int, default=voxelizer.K2_CLUSTER)
    ap.add_argument("--height", type=int, default=260)
    ap.add_argument("--width", type=int, default=346)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_phase_stamps: no CUDA device", file=sys.stderr)
        return 1
    B, N, C, H, W = args.windows, args.events, args.cluster, args.height, args.width
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    x = torch.tensor(rng.uniform(0, W, (B, N)), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.uniform(0, H, (B, N)), dtype=torch.float32, device=dev)
    p = torch.tensor(rng.choice([-1, 1], (B, N)), dtype=torch.int32, device=dev)

    plain_lib = _build.library()
    lib = _build.library(("EVFLY_PHASE_STAMPS",))
    lib.evfly_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.evfly_phase_stamps.restype = ctypes.c_int
    launch(lib, x, y, p, H, W, C)
    torch.cuda.synchronize()
    out, q = launch(lib, x, y, p, H, W, C)
    torch.cuda.synchronize()
    ref, qref = voxelizer.hist_scaled_plain(x, y, p, H, W)
    err = (out - ref).abs().max().item()
    if not (torch.equal(q, qref) and err <= 2e-5):
        print(f"k2_phase_stamps: the stamped kernel disagrees with the plain version ({err})",
              file=sys.stderr)
        return 1
    ctas = B * C
    stamps = np.zeros(ctas * STAMPS_PER_CTA, np.uint64)
    _build.check("evfly_phase_stamps",
                 lib.evfly_phase_stamps(stamps.ctypes.data, stamps.size))
    stamps = stamps.reshape(ctas, STAMPS_PER_CTA)
    t = (stamps[:, :6].astype(np.int64) - int(stamps[:, 0].min())) / 1e3  # µs from the first start
    sm = stamps[:, STAMPS_PER_CTA - 1]
    span = t[:, 5].max()
    name = torch.cuda.get_device_name(0)
    print(f"{name}; K2 at {B} x {N:,} events, {H}x{W}, clusters of {C} CTAs: stamped "
          f"launch spans {span:.2f} µs over {len(set(sm.tolist()))} SMs; frame max|diff| "
          f"{err:.1e}, q equal")
    steps = np.diff(np.unique(t))
    print(f"smallest step between distinct stamps: {steps[steps > 0].min():.3f} µs")
    for k, label in enumerate(PHASES):
        d = t[:, k + 1] - t[:, k]
        print(f"  {label:24s} median {np.median(d):7.2f} µs, p10 {np.percentile(d, 10):7.2f},"
              f" p90 {np.percentile(d, 90):7.2f}")
    starts = np.sort(t[:, 0])
    first_end = t[:, 5].min()
    late = starts > first_end
    print(f"CTA starts: {np.count_nonzero(~late)} before the first CTA ended "
          f"({first_end:.2f} µs), {np.count_nonzero(late)} after; the later ones from "
          f"{starts[late].min() if late.any() else float('nan'):.2f} µs")
    # how many CTAs bin (phase 2: after barrier 1, before barrier 2) and how
    # many write (phase 5) at each moment
    edges = np.linspace(0.0, span, 41)
    mids = 0.5 * (edges[:-1] + edges[1:])
    binning = ((t[:, 1][None] <= mids[:, None]) & (mids[:, None] < t[:, 2][None])).sum(1)
    writing = ((t[:, 4][None] <= mids[:, None]) & (mids[:, None] < t[:, 5][None])).sum(1)
    print("timeline (µs: CTAs binning / CTAs writing):")
    print("  " + "  ".join(f"{m:.1f}:{b}/{w}" for m, b, w in zip(mids, binning, writing)))
    both = np.count_nonzero((binning > 0) & (writing > 0))
    print(f"{both} of {len(mids)} slices of the span have CTAs binning and CTAs writing at once; "
          f"writes fill {np.count_nonzero(writing > 0)} slices, binning {np.count_nonzero(binning > 0)}")

    stamped = device_ms(lambda: launch(lib, x, y, p, H, W, C))
    plain = device_ms(lambda: launch(plain_lib, x, y, p, H, W, C))
    print(f"K2 device ms (median of 20, L2 flushed): {plain:.4f} without stamps, "
          f"{stamped:.4f} with")
    return 0


if __name__ == "__main__":
    sys.exit(main())
