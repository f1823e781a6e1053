// K1, K2, K3: events -> signed count frame, and its quantile-normalized forms.
//
// Replaces the three voxelizer kernels of evfly_tpu/ops/voxelizer.py:
//
//   K1  `_hist_pallas`                        (event_histogram)
//       frame = thresh * counts, or pos * pos_counts - neg * neg_counts
//   K2  `_hist_pallas_fused_quantile`         (event_histogram_scaled)
//       frame = clip(counts * scale, -1, 1) and q
//   K3  `_hist_pallas_fused_quantile_resize`  (event_histogram_scaled_resized)
//       out   = R_h . clip(counts * scale, -1, 1) . R_w^T and q
//
// with, for every window of events,
//
//   counts[y, x] = sum_e sign_e [yi_e = y][xi_e = x]   (np.histogram2d bins)
//   q            = k-th smallest |counts|, 18-step f32 bisection, zero snap
//   scale        = q > 0 ? 1 / max(q, 1e-30) : thresh
//
// What bounds them on the H100: bytes.  They read 12 bytes per event and
// write the frame (K1, K2) or the small input (K3); the arithmetic is a few
// operations per event and per frame cell.  The TPU kernels turned the
// scatter into one-hot matmuls for the MXU; here the scatter is what the
// hardware does well (shared-memory atomics).  At the repo's shapes a window
// is a few microseconds of work, so what a design must avoid is serial
// memory latency and one SM doing a window's work alone.
//
// The cluster kernels (K1 `hist_frame_cluster_kernel`, K2 and K3
// `hist_scaled_cluster_kernel<kPacked, kResize>`): one thread-block cluster
// of C CTAs per window (K1: kK1Cluster = 8 where they hold the frame, else
// kK1WideCluster = 16, a non-portable size, where those do; the wrappers'
// K2_CLUSTER = K3_CLUSTER = 2), windows x C CTAs on grid.x.  The window's count frame is
// cut into C bands of ceil(H / C) rows, CTA r holding rows [r * rows, (r +
// 1) * rows) in its shared memory, so the cluster's distributed shared memory
// holds the whole frame (352 KiB of int32 at 260x346).  Each CTA reads 1/C of
// the window's events once, with 16-byte loads (its first group issued before
// it zeroes its band), bins each with `bin_event` and adds its sign into the
// owning CTA's band (a shared-memory atomic, or a reduction into the owner's
// shared memory: the counts are integers, so any order gives the same frame).
// A cluster barrier before the events (every band zeroed) and one after them
// (every event counted) order the adds.  Then:
//
//   * K1 writes each band with 16-byte stores.  The band starts in shared
//     memory at the word offset (`lead`) that its first cell has modulo 4 in
//     the output, so an aligned group of four cells is one int4 in shared
//     memory and one float4 in global memory.
//   * K2 and K3 scan their band for the count-of-counts of |count|
//     (`SmallCounts`): below kSmall from three sums per thread taken without
//     a branch (#(|count| > 0), sum |count|, sum |count|^2; most cells are 0,
//     1 or 2, and the scan is bound by the SM's integer issue rate, so what
//     counts is instructions per cell), below kTable, from kTable on into a
//     list (at most N / kTable cells reach it), each added into every CTA's
//     table and list, with its max, by atomics in distributed shared memory.
//     K3 also copies the next band's first row (the second tap row of its
//     last output rows) through distributed shared memory.  After a third
//     barrier no CTA touches another's shared memory, so none waits for the
//     others again: each prefix-sums its table and runs the 18-step
//     bisection in one warp: #(|count| <= mid) == CDF[floor(mid)], and where
//     the table's CDF reaches kth the test CDF[m] < kth is m < v for the
//     least v whose CDF does, so no step reads memory; the quantile is the
//     plain version's bit for bit.  K3 writes the output rows whose first tap
//     row lies in its band, the taps' indices held as ints; K2 writes its
//     band of the clipped frame with 16-byte stores, its band laid out at
//     K1's `lead`.  Up to kMaxPacked (32,767) events per window a band holds
//     two int16 counts a word (`Band<true>`, 94 KB a CTA at 260x346 on 2
//     CTAs), so two CTAs of 512 threads share an SM and twice as many windows
//     run at once as with int32 counts (`Band<false>`, one CTA of 1,024
//     threads per SM), which take the windows above.  The caps are what the
//     band, the list (and K3's taps and row) leave of a block's shared memory
//     (`scaled_cluster_cap`: 823,807 events at 260x346 on 2 CTAs;
//     `resized_cluster_cap`: 763,135).
//
// Frames that no 16-CTA cluster holds take K1's band route (below); the
// route is decided by shape alone (`frame_cluster_route`).
//
// K1 over time windows (`event_frames_from_windows` of the JAX package, a
// lax.map of K1 over the windows with every window masking the whole
// stream by time, T x N work): both K1 routes take an optional pair of
// int64 offset arrays `begin`, `end` (T,).  With them, window b reads the
// events [begin[b], end[b]) of one (N,) stream, which the wrapper has
// sorted by time, so the T windows of a recording are one launch that
// reads each event once per window holding it.  Windows may overlap, come
// in any order or be empty (end <= begin).  A window's first event has any
// alignment: `event_slice` reads one by one up to the first 16-byte
// boundary that x, y and pol share.  Without offsets, window b reads
// events [b * N, (b + 1) * N) of a (B, N) batch, as before.  The host
// checks that every offset is below 2^31.  With two thresholds the window
// launch writes fma(pos, pos_counts, -(neg * neg_counts)), one rounding
// fewer than K1's pos * pos_counts - neg * neg_counts: that is the value
// of the JAX package's event_frames_from_windows, whose compiler contracts
// the multiply and the subtract into one FMA inside its lax.map (its
// event_histogram has no FMA), so both ports equal their JAX function bit
// for bit.
//
// K1's band route, for frames no cluster holds (two thresholds at
// 1280x720, anything at 1920x1080): the frame cut into bands of
// `band_route_cells` flat cells (32 KiB of counts), two launches.  The
// partition pass (`hist_band_partition_kernel`, one block per chunk of
// kChunk events of a window) reads each event once for each window holding
// it, bins it and writes its key (2 * cell + [sign < 0]) into the window's
// run of scratch, sorted by band within its chunk (a counting sort in
// shared memory), with the offsets of the bands' runs in a table.  The band
// pass (`hist_band_kernel`, one block per (window, band), windows on grid.x,
// up to 2^31 - 1 of them; grid.y stops at 65,535) reads only its band's
// keys, counts them in shared memory and writes its band.  So every event is
// read once and every key once, where the band kernel of before had every
// block of a window read all its events (80 to 240 blocks at 640x480 and
// 1280x720).  Counts are exact integers, summed in any order; the
// thresholds are applied with round-to-nearest multiplies and subtract (no
// FMA contraction; the window launch's FMA above), as the JAX package does
// in f32, so the frame is bit for bit the JAX one (on every route).
//
// A window that K2 and K3 cannot take (more events than their caps, or a
// frame no band holds) gets their function in two launches: K1's counts
// (thresholds 1: exact integers in f32), then `scale_counts_cluster_kernel`,
// one cluster of C CTAs per window (the wrappers' SCALE_CLUSTER = 16).  Each
// CTA reads 1/C of the window's counts once with 16-byte loads (keeping them
// in shared memory for the frame where they fit) and tallies their |count|
// as K2 and K3 do, the list in global scratch (no count is bounded, so no
// list of shared memory could hold every cell past kTable); each CTA writes
// its table, max and list length into a slot of every CTA's shared memory,
// and one cluster barrier ends the exchange.  The bisection depends only on
// v_k, the k-th smallest |count|: #(|count| <= mid) >= kth exactly when v_k
// <= mid, so its 18 steps run in one thread as comparisons with v_k, and
// the zero snap is v_k == 0.  v_k is read off the merged table's CDF, or,
// where that stays below kth, found by a search over the lists.  Each CTA
// then writes its slice of the clipped frame with 16-byte stores (K2's
// function), or a share of the resized rows from K3's taps (K3's function),
// reading the taps' counts from L2.
//
// Every kernel's shared-memory attributes are set once per device, for the
// largest size a wrapper gives it.  Each C entry point returns
// cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

namespace cg = cooperative_groups;

constexpr int kFrameThreads = 512;     // K1's cluster kernel, a CTA
constexpr int kK1Cluster = 8;          // K1's cluster route: CTAs per window where they
constexpr int kK1WideCluster = 16;     //   hold the frame, else these (non-portable)
constexpr int kPartThreads = 512;      // K1's band route: the partition pass's block,
constexpr int kChunk = 4096;           //   which takes this many events of one window,
constexpr int kBandRouteThreads = 512;  //  and the band pass's block
constexpr int kMaxBands = 8192;        //   bands of a frame at most
constexpr int kBandInts = 8192;        //   a band block's counts: 32 KiB, wider only
                                       //   where the frame has more than kMaxBands
constexpr int kResizedThreads = 1024;  // K2's and K3's, int32 counts (one CTA per SM)
constexpr int kPackedThreads = 512;    // K2's and K3's, two int16 counts a word (two CTAs per SM)
constexpr int kMaxPacked = 32767;      // K2 and K3 pack their counts up to this many events
constexpr int kScaleThreads = 512;     // scale_counts' cluster kernel, a CTA
constexpr int kScaleBatch = 8;         //   its 16-byte loads in flight per thread
constexpr int kMaxCluster = 16;  // above 8 CTAs a cluster is non-portable
constexpr int kSmall = 4;        // K2, K3, scale_counts: |count| below this is counted
constexpr int kTable = 64;       //   in registers, below this in a dense table, from
                                 //   it on in a list
// a block may opt in to 227 KB (232,448 bytes) of shared memory; keep 1 KiB
// for the kernels' static shared variables (8 KiB for scale_counts', which
// hold every CTA's table)
constexpr int kSmemLimit = 232448 - 1024;
constexpr int kScaleSmemLimit = 232448 - 8192;

// Phase stamps for probes (tools/k2_phase_stamps.py builds the library with
// -DEVFLY_PHASE_STAMPS): thread 0 of CTA i of K2's cluster kernel writes
// %globaltimer at the end of phase k to g_stamps[i * kStampsPerCta + k] and
// its SM's id to the last slot.  Without the macro the stamps compile away.
constexpr int kStampsPerCta = 8;
#ifdef EVFLY_PHASE_STAMPS
constexpr int kStampCtas = 8192;
__device__ unsigned long long g_stamps[kStampCtas * kStampsPerCta];

template <bool kOn>
__device__ __forceinline__ void phase_stamp(int k) {
  if (!kOn || threadIdx.x != 0 || blockIdx.x >= kStampCtas) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  g_stamps[blockIdx.x * kStampsPerCta + k] = t;
  g_stamps[blockIdx.x * kStampsPerCta + kStampsPerCta - 1] = smid;
}
#define EVFLY_STAMP(on, k) phase_stamp<on>(k)
#else
#define EVFLY_STAMP(on, k)
#endif

// np.histogram2d binning: the flat cell of an event, or -1 when it is
// dropped (outside [0, W] x [0, H], NaN, or pol == 0); *sign gets +-1.
__device__ __forceinline__ int bin_event(float xf, float yf, int p, int H, int W,
                                         int* sign) {
  const float Wf = static_cast<float>(W), Hf = static_cast<float>(H);
  const int s = p > 0 ? 1 : (p < 0 ? -1 : 0);
  const bool valid = xf >= 0.f && xf <= Wf && yf >= 0.f && yf <= Hf;
  if (!valid || s == 0) return -1;
  const int xi = xf >= Wf ? W - 1 : static_cast<int>(floorf(xf));
  const int yi = yf >= Hf ? H - 1 : static_cast<int>(floorf(yf));
  *sign = s;
  return yi * W + xi;
}

// The first event and the count of window b: [win_begin[b], win_end[b])
// of one stream with offsets, else [b * N, (b + 1) * N) of a (B, N) batch
struct WindowRange {
  size_t first;
  int n;
};

__device__ __forceinline__ WindowRange window_range(const long long* win_begin,
                                                    const long long* win_end, int b, int N) {
  if (win_begin == nullptr) return {static_cast<size_t>(b) * N, N};
  const long long e0 = win_begin[b], e1 = win_end[b];
  return {static_cast<size_t>(e0), static_cast<int>(e1 > e0 ? e1 - e0 : 0)};
}

// A cell's value with two thresholds: pos * pc - neg * nc, each product
// rounded (K1), or with `fused` fma(pos, pc, -(neg * nc)) (K1 over time
// windows); no contraction by the compiler either way
__device__ __forceinline__ float two_pass_value(float pos_thresh, float neg_thresh, int pc,
                                                int nc, bool fused) {
  const float neg = __fmul_rn(neg_thresh, static_cast<float>(nc));
  if (fused) return __fmaf_rn(pos_thresh, static_cast<float>(pc), -neg);
  return __fsub_rn(__fmul_rn(pos_thresh, static_cast<float>(pc)), neg);
}

// ----------------------------------------------------------- K2 and K3

__device__ __forceinline__ int decode_count(const int* words, int idx) {
  const int w = words[idx >> 1];
  const int lo = static_cast<int>(static_cast<int16_t>(w & 0xFFFF));
  if ((idx & 1) == 0) return lo;
  return (w - lo) / 65536;  // exact: w - lo is a multiple of 65536
}

// c as a float, exactly, for |c| < 2^22 (every count of a window the
// kernels take), by the FP32 pipe: 1.5 * 2^23 + c has ulp 1
__device__ __forceinline__ float count_to_float(int c) {
  return __fsub_rn(__int_as_float(0x4B400000 + c), 12582912.f);
}

__device__ __forceinline__ float clip_scaled(float count, float scale) {
  return fminf(fmaxf(__fmul_rn(count, scale), -1.f), 1.f);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// the sum over the block of every thread's v, in every thread
__device__ int block_sum(int v, int* s_warp) {
  v = warp_sum(v);
  __syncthreads();  // s_warp's last readers are done
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += s_warp[w];
  return total;
}

// One thread's part of the count-of-counts of |count| that K2, K3 and
// scale_counts take: every cell, without a branch, into the max of its group
// (m) and into sums of [a > 0], a and a * a (mod 2^32), a = |count|, from
// which #(|count| == v) for v = 1, 2, 3 follow once the cells of a group
// whose max reaches kSmall (few) are taken out again for the caller's table
// or list.  The caller adds the cells it scans to `seen` (per group, so that
// a cell costs no instruction for it).
static_assert(kSmall == 4, "the sums give #(|count| == v) for v = 1, 2, 3");
struct SmallCounts {
  unsigned nz = 0, s1 = 0, s2 = 0;
  int seen = 0, taken = 0;

  __device__ __forceinline__ void add(int c, int& m) {
    const unsigned a = static_cast<unsigned>(abs(c));
    m = max(m, static_cast<int>(a));
    nz += min(a, 1u);
    s1 += a;
    s2 += a * a;
  }

  // takes a cell of |count| = a >= kSmall out of the sums
  __device__ __forceinline__ void take(unsigned a) {
    nz -= 1u;
    s1 -= a;
    s2 -= a * a;
    ++taken;
  }

  // #(|count| == v), v < kSmall, of the cells seen and not taken
  __device__ __forceinline__ void counts(unsigned n[4]) const {
    // n1 + n2 + n3 = nz, n1 + 2 n2 + 3 n3 = s1, n1 + 4 n2 + 9 n3 = s2
    const unsigned n3 = (s2 - 3u * s1 + 2u * nz) / 2u;
    const unsigned n2 = s1 - nz - 2u * n3;
    n[0] = static_cast<unsigned>(seen - taken) - nz;
    n[1] = nz - n2 - n3;
    n[2] = n2;
    n[3] = n3;
  }
};

// -------------------------------------------- K1, K2 and K3 on clusters

__host__ __device__ __forceinline__ int round_up4(int n) { return (n + 3) & ~3; }

// rows of the frame in each CTA's band
__host__ __device__ __forceinline__ int band_rows(int H, int cluster) {
  return (H + cluster - 1) / cluster;
}

// ints of one band array: its cells, 3 words for K1's `lead`, whole int4s
__host__ __device__ __forceinline__ int band_ints(int H, int W, int cluster) {
  return round_up4(band_rows(H, cluster) * W + 3);
}

bool cluster_size_ok(int cluster) { return cluster >= 1 && cluster <= kMaxCluster; }

size_t frame_cluster_smem(int H, int W, int two_pass, int cluster) {
  return static_cast<size_t>((two_pass ? 2 : 1) * band_ints(H, W, cluster)) * sizeof(int);
}

// entries of a list of the |count| >= kTable of a window of N events: at
// most N / kTable cells reach kTable
__host__ __device__ __forceinline__ int large_capacity(int N) {
  return round_up4(N / kTable + 1);
}

// K2's and K3's bands hold two int16 counts in each word while a window has
// at most kMaxPacked events (no count passes int16), else one int32 count a
// word
__host__ __device__ __forceinline__ bool resized_packed(int N) { return N <= kMaxPacked; }

// words of K3's band array (whole int4s) and of its copy of the next band's
// first row
__host__ __device__ __forceinline__ int resized_band_words(int H, int W, int cluster,
                                                           bool packed) {
  return packed ? round_up4((band_rows(H, cluster) * W + 1) / 2) : band_ints(H, W, cluster);
}

// words of K2's band array: its cells from K1's `lead` (up to 3 slots) on,
// whole int4s
__host__ __device__ __forceinline__ int scaled_band_words(int H, int W, int cluster,
                                                          bool packed) {
  return packed ? round_up4((band_rows(H, cluster) * W + 4) / 2) : band_ints(H, W, cluster);
}

// the band and the window's list of large |count|
size_t scaled_cluster_smem(int H, int W, int N, int cluster) {
  return static_cast<size_t>(scaled_band_words(H, W, cluster, resized_packed(N)) +
                             large_capacity(N)) *
         sizeof(int);
}

// the most events per window whose list fits beside `band_words(packed)`
// words of a block's shared memory, or -1 where not even a list of 4 does.
// Up to kMaxPacked events the band is packed, so the cap is the int32 band's
// where that passes kMaxPacked, else the packed band's (at most kMaxPacked)
template <typename BandWords>
int events_cap(BandWords band_words) {
  auto cap_of = [&](bool packed) {
    const int left = kSmemLimit / static_cast<int>(sizeof(int)) - band_words(packed);
    const int list = left & ~3;  // the list's entries; N / kTable + 1 <= list
    return list >= 4 ? list * kTable - 1 : -1;
  };
  const int wide = cap_of(false);
  if (wide > kMaxPacked) return wide;
  const int narrow = cap_of(true);
  return narrow < kMaxPacked ? narrow : kMaxPacked;
}

// K2's cap at (H, W) on `cluster` CTAs
int scaled_cluster_cap(int H, int W, int cluster) {
  if (H < 1 || W < 1 || !cluster_size_ok(cluster)) return -1;
  return events_cap([&](bool packed) { return scaled_band_words(H, W, cluster, packed); });
}

__host__ __device__ __forceinline__ int resized_halo_words(int W, bool packed) {
  return packed ? (W + 1) / 2 : W;
}

// the band, the window's list of large |count|, the taps of an (h_out,
// w_out) output and a copy of the next band's first row
size_t resized_cluster_smem(int H, int W, int N, int h_out, int w_out, int cluster) {
  const bool packed = resized_packed(N);
  return static_cast<size_t>(resized_band_words(H, W, cluster, packed) + large_capacity(N) +
                             4 * (h_out + w_out) + resized_halo_words(W, packed)) *
         sizeof(int);
}

bool frame_cluster_fits(int H, int W, int two_pass, int cluster) {
  return H >= 1 && W >= 1 && cluster_size_ok(cluster) &&
         frame_cluster_smem(H, W, two_pass, cluster) <= static_cast<size_t>(kSmemLimit);
}

// K1's route for an H x W frame, decided by shape before any launch: one
// cluster of kK1Cluster CTAs per window where they hold the frame, else
// one of kK1WideCluster where those do, else 0, the band route
int frame_cluster_route(int H, int W, int two_pass) {
  if (frame_cluster_fits(H, W, two_pass, kK1Cluster)) return kK1Cluster;
  if (frame_cluster_fits(H, W, two_pass, kK1WideCluster)) return kK1WideCluster;
  return 0;
}

// The band route's band: kBandInts counts (two arrays with two thresholds)
// of flat cells, a multiple of 4, at most the frame, wider where the frame
// would have more than kMaxBands bands; -1 where such a band passes a
// block's shared memory or a key (2 * cell + sign) passes int32
int band_route_cells(int H, int W, int two_pass) {
  if (H < 1 || W < 1) return -1;
  const long long HW = static_cast<long long>(H) * W;
  if (HW >= (1LL << 30)) return -1;
  const long long arrays = two_pass ? 2 : 1;
  long long cells = (kBandInts / arrays < HW + 3 ? kBandInts / arrays : HW + 3) & ~3LL;
  const long long widest = ((HW + kMaxBands - 1) / kMaxBands + 3) & ~3LL;
  if (cells < widest) cells = widest;
  if (arrays * cells * static_cast<long long>(sizeof(int)) > kSmemLimit) return -1;
  return static_cast<int>(cells);
}

__host__ __device__ __forceinline__ int band_count(int H, int W, int band_cells) {
  return static_cast<int>((static_cast<long long>(H) * W + band_cells - 1) / band_cells);
}

// K3's cap: the most events per window whose list fits beside the band,
// the taps and the row (`events_cap`)
int resized_cluster_cap(int H, int W, int h_out, int w_out, int cluster) {
  if (H < 1 || W < 1 || h_out < 1 || w_out < 1 || !cluster_size_ok(cluster)) return -1;
  return events_cap([&](bool packed) {
    return resized_band_words(H, W, cluster, packed) + 4 * (h_out + w_out) +
           resized_halo_words(W, packed);
  });
}

// CTA `rank`'s slice [e0, e1) of a window's N events, a multiple of 4
// events long so that every slice has the alignment of the first, as the
// block reads it: one by one up to v0, then `groups` groups of four as
// 16-byte loads (wherever x, y and pol share their alignment), then one by
// one to e1
struct EventSlice {
  int e0, e1, v0, groups;
};

__device__ __forceinline__ EventSlice event_slice(const float* x, const float* y,
                                                  const int* pol, int N, int cluster,
                                                  int rank) {
  EventSlice s;
  const int per = round_up4((N + cluster - 1) / cluster);
  s.e0 = min(N, rank * per);
  s.e1 = min(N, s.e0 + per);
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x + s.e0);
  const uintptr_t ay = reinterpret_cast<uintptr_t>(y + s.e0);
  const uintptr_t ap = reinterpret_cast<uintptr_t>(pol + s.e0);
  int head = s.e1 - s.e0;  // all of them one by one, unless the three share alignment
  if (((ax ^ ay) | (ax ^ ap)) % 16 == 0) {
    head = min(head, static_cast<int>((16 - ax % 16) % 16 / 4));
  }
  s.v0 = s.e0 + head;
  s.groups = (s.e1 - s.v0) / 4;
  return s;
}

struct EventGroup {
  float4 x, y;
  int4 p;
};

__device__ __forceinline__ EventGroup load_group(const float* __restrict__ x,
                                                 const float* __restrict__ y,
                                                 const int* __restrict__ pol,
                                                 const EventSlice& s, int g) {
  EventGroup v;
  v.x = __ldg(reinterpret_cast<const float4*>(x + s.v0) + g);
  v.y = __ldg(reinterpret_cast<const float4*>(y + s.v0) + g);
  v.p = __ldg(reinterpret_cast<const int4*>(pol + s.v0) + g);
  return v;
}

// group g of the slice on its way to L2, for a load that comes later
__device__ __forceinline__ void prefetch_group(const float* x, const float* y, const int* pol,
                                               const EventSlice& s, int g) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(x + s.v0 + 4 * g));
  asm volatile("prefetch.global.L2 [%0];" ::"l"(y + s.v0 + 4 * g));
  asm volatile("prefetch.global.L2 [%0];" ::"l"(pol + s.v0 + 4 * g));
}

template <typename Fn>
__device__ __forceinline__ void bin_group(const EventGroup& v, Fn& fn) {
  fn(v.x.x, v.y.x, v.p.x);
  fn(v.x.y, v.y.y, v.p.y);
  fn(v.x.z, v.y.z, v.p.z);
  fn(v.x.w, v.y.w, v.p.w);
}

// fn(x, y, pol) for every event of the slice, spread over the block;
// `first` is group threadIdx.x, loaded by the caller ahead of time (the
// kernels issue it before they zero shared memory and wait at the first
// cluster barrier, so its latency overlaps both)
template <typename Fn>
__device__ __forceinline__ void for_each_event(const float* __restrict__ x,
                                               const float* __restrict__ y,
                                               const int* __restrict__ pol,
                                               const EventSlice& s, const EventGroup& first,
                                               Fn fn) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int e = s.e0 + tid; e < s.v0; e += nthreads) fn(x[e], y[e], pol[e]);
  if (tid < s.groups) bin_group(first, fn);
  for (int g = tid + nthreads; g < s.groups; g += nthreads) {
    const EventGroup v = load_group(x, y, pol, s, g);
    bin_group(v, fn);
  }
  for (int e = s.v0 + 4 * s.groups + tid; e < s.e1; e += nthreads) fn(x[e], y[e], pol[e]);
}

// adds v to the int at `offset` of CTA `owner`'s shared array `base`: a
// shared-memory atomic, in this CTA's shared memory or another's (ordered
// by the next cluster barrier)
__device__ __forceinline__ void add_to(int* base, int offset, int owner, int rank, int v) {
  if (owner == rank) {
    atomicAdd(base + offset, v);
  } else {
    atomicAdd(cg::this_cluster().map_shared_rank(base + offset, owner), v);
  }
}

__global__ void __launch_bounds__(kFrameThreads)
hist_frame_cluster_kernel(const float* __restrict__ x, const float* __restrict__ y,
                          const int* __restrict__ pol, const long long* __restrict__ win_begin,
                          const long long* __restrict__ win_end, float* __restrict__ out, int N,
                          int H, int W, float pos_thresh, float neg_thresh, int two_pass) {
  // one band array, or pos then neg counts; cell i of CTA r's band at
  // lead(r) + i, lead(r) being the output's word offset of that cell mod 4
  extern __shared__ int4 smem4[];
  int* band = reinterpret_cast<int*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rows = band_rows(H, C), stride = band_ints(H, W, C);
  const int band_cells = rows * W;
  const size_t frame0 = static_cast<size_t>(b) * H * W;
  const size_t out_word = reinterpret_cast<uintptr_t>(out) / sizeof(float);
  auto lead_of = [&](int r) {
    return static_cast<int>((out_word + frame0 + static_cast<size_t>(r) * band_cells) & 3);
  };

  // 1. this thread's first group of events in flight; zero the band(s);
  //    no event lands before every band is zero
  const WindowRange win = window_range(win_begin, win_end, b, N);
  const size_t ev0 = win.first;
  const EventSlice slice = event_slice(x + ev0, y + ev0, pol + ev0, win.n, C, rank);
  EventGroup first = {};
  if (tid < slice.groups) first = load_group(x + ev0, y + ev0, pol + ev0, slice, tid);
  const int n4 = (two_pass ? 2 : 1) * stride / 4;
  for (int i = tid; i < n4; i += nthreads) smem4[i] = make_int4(0, 0, 0, 0);
  cluster.sync();

  // 2. this CTA's slice of the events into their owners' bands
  for_each_event(x + ev0, y + ev0, pol + ev0, slice, first, [&](float xf, float yf, int p) {
    int s = 0;
    const int idx = bin_event(xf, yf, p, H, W, &s);
    if (idx < 0) return;
    const int owner = idx / band_cells;
    const int offset = lead_of(owner) + idx - owner * band_cells;
    if (two_pass) {
      add_to(band, s > 0 ? offset : stride + offset, owner, rank, 1);
    } else {
      add_to(band, offset, owner, rank, s);
    }
  });
  cluster.sync();  // every event counted; no CTA adds into another's band after this

  // 3. the band, thresholds applied, to out: word s of the band array is
  //    word s of `dst`, which is 16-byte aligned
  const int row0 = rank * rows;
  const int cells = max(0, min(rows, H - row0)) * W;
  const int lead = lead_of(rank);
  float* dst = out + frame0 + static_cast<size_t>(row0) * W - lead;
  const bool fused = win_begin != nullptr;
  auto value = [&](int s) {
    if (two_pass) {
      return two_pass_value(pos_thresh, neg_thresh, band[s], band[stride + s], fused);
    }
    return __fmul_rn(pos_thresh, static_cast<float>(band[s]));
  };
  const int end = lead + cells;
  const int g0 = min((lead + 3) / 4, end / 4), g1 = end / 4;  // whole groups of 4
  for (int s = lead + tid; s < min(4 * g0, end); s += nthreads) dst[s] = value(s);
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int g = g0 + tid; g < g1; g += nthreads) {
    const int4 v = smem4[g];
    if (two_pass) {
      const int4 n = smem4[stride / 4 + g];
      dst4[g] = make_float4(two_pass_value(pos_thresh, neg_thresh, v.x, n.x, fused),
                            two_pass_value(pos_thresh, neg_thresh, v.y, n.y, fused),
                            two_pass_value(pos_thresh, neg_thresh, v.z, n.z, fused),
                            two_pass_value(pos_thresh, neg_thresh, v.w, n.w, fused));
    } else {
      dst4[g] = make_float4(__fmul_rn(pos_thresh, static_cast<float>(v.x)),
                            __fmul_rn(pos_thresh, static_cast<float>(v.y)),
                            __fmul_rn(pos_thresh, static_cast<float>(v.z)),
                            __fmul_rn(pos_thresh, static_cast<float>(v.w)));
    }
  }
  for (int s = max(4 * g1, lead) + tid; s < end; s += nthreads) dst[s] = value(s);
}

// ---------------------------------------------------- K1's band route

// a[0..n) -> its exclusive prefix sums in place, a[n] = their total; every
// thread of the block calls it (n <= kMaxBands)
__device__ void block_exclusive_scan(int* a, int n, int* s_warp) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int per = (n + nthreads - 1) / nthreads;
  const int i0 = min(n, tid * per), i1 = min(n, i0 + per);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += a[i];
  const int incl = warp_inclusive_scan(sum);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? s_warp[lane] : 0;
    const int wi = warp_inclusive_scan(w);
    if (lane < nwarps) s_warp[lane] = wi - w;
  }
  __syncthreads();
  int run = s_warp[warp] + incl - sum;
  for (int i = i0; i < i1; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  if (tid == nthreads - 1) a[n] = run;  // the last thread's run ends at the total
  __syncthreads();
}

// The band route's chunks: window b's events are cut into chunks of kChunk,
// the chunks of all windows numbered in window order.  Window b has chunks
// [c0, c1) and its keys start at key0 in the key scratch (its first event's
// occurrence).  Without offsets (a (B, N) batch) every window has ceil(N /
// kChunk) chunks and its keys start at b * N; with them `chunk_end` (T,)
// holds the running total of the windows' chunks and `key_base` (T,) the
// running total of their lengths before b (the wrapper's cumsums).
struct WindowChunks {
  long long c0, c1;
  size_t key0;
};

__device__ __forceinline__ WindowChunks window_chunks(const long long* chunk_end,
                                                      const long long* key_base, int b, int N) {
  if (chunk_end == nullptr) {
    const long long per = (N + kChunk - 1) / kChunk;
    return {b * per, (b + 1) * per, static_cast<size_t>(b) * N};
  }
  return {b > 0 ? chunk_end[b - 1] : 0, chunk_end[b], static_cast<size_t>(key_base[b])};
}

// the window that holds chunk c: the least b with chunk_end[b] > c
__device__ __forceinline__ int chunk_window(const long long* chunk_end, int T, int N,
                                            long long c) {
  if (chunk_end == nullptr) return static_cast<int>(c / ((N + kChunk - 1) / kChunk));
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (chunk_end[mid] > c) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Pass 1, one block per chunk: its events read once (coalesced, any
// alignment), binned, and their keys (2 * cell + [sign < 0]) sorted by band
// in shared memory (a counting sort: each key's rank within its band from
// the shared-memory atomic that counts it, the bands' offsets from a block
// scan), then written in band order at the chunk's place in `keys`; row c
// of `table` ((chunks, bands + 1) ints) gets the offsets of the bands'
// runs in the chunk, the last entry the chunk's count of kept keys.
__global__ void __launch_bounds__(kPartThreads)
hist_band_partition_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           const int* __restrict__ pol, const long long* __restrict__ win_begin,
                           const long long* __restrict__ win_end,
                           const long long* __restrict__ chunk_end,
                           const long long* __restrict__ key_base, int T, int N, int H, int W,
                           int band_cells, int bands, int* __restrict__ keys,
                           int* __restrict__ table) {
  extern __shared__ int s_part[];  // bands + 1 counts (whole int4s), then kChunk keys
  __shared__ int s_warp[kPartThreads / 32];
  int* s_count = s_part;
  int* s_keys = s_part + round_up4(bands + 1);
  const int tid = threadIdx.x;
  const long long c = blockIdx.x;
  const int b = chunk_window(chunk_end, T, N, c);
  const WindowChunks wc = window_chunks(chunk_end, key_base, b, N);
  const WindowRange win = window_range(win_begin, win_end, b, N);
  const long long j0 = (c - wc.c0) * kChunk;  // the chunk's first event in its window
  const int n = static_cast<int>(min(static_cast<long long>(kChunk), win.n - j0));
  const size_t first = win.first + j0;

  // the chunk's events in flight, the band counts zeroed
  constexpr int kPer = kChunk / kPartThreads;
  float ex[kPer], ey[kPer];
  int ep[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = k * kPartThreads + tid;
    ex[k] = ey[k] = -1.f;  // dropped by bin_event
    ep[k] = 0;
    if (e < n) {
      ex[k] = __ldg(x + first + e);
      ey[k] = __ldg(y + first + e);
      ep[k] = __ldg(pol + first + e);
    }
  }
  for (int i = tid; i < bands; i += kPartThreads) s_count[i] = 0;
  __syncthreads();

  int key[kPer], band[kPer], rank[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    int s = 0;
    const int idx = bin_event(ex[k], ey[k], ep[k], H, W, &s);
    key[k] = 2 * idx + (s < 0 ? 1 : 0);
    band[k] = idx < 0 ? -1 : idx / band_cells;
    rank[k] = idx < 0 ? 0 : atomicAdd(&s_count[band[k]], 1);
  }
  __syncthreads();
  block_exclusive_scan(s_count, bands, s_warp);

  int* row = table + static_cast<size_t>(c) * (bands + 1);
  for (int i = tid; i <= bands; i += kPartThreads) row[i] = s_count[i];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (band[k] >= 0) s_keys[s_count[band[k]] + rank[k]] = key[k];
  }
  __syncthreads();
  const int kept = s_count[bands];
  int* dst = keys + wc.key0 + j0;
  for (int i = tid; i < kept; i += kPartThreads) dst[i] = s_keys[i];
}

// Pass 2, one block per (window b, band k), windows on grid.x (up to 2^31
// - 1; grid.y stops at 65,535) and bands on grid.y: the band's counts in
// shared memory, from the run of band k in each chunk of window b (one warp
// per chunk), then written with the thresholds applied.  A key is read once.
__global__ void __launch_bounds__(kBandRouteThreads)
hist_band_kernel(const int* __restrict__ keys, const int* __restrict__ table,
                 const long long* __restrict__ chunk_end, const long long* __restrict__ key_base,
                 float* __restrict__ out, int N, int H, int W, int band_cells, int bands,
                 float pos_thresh, float neg_thresh, int two_pass, int fused) {
  extern __shared__ int4 s_band4[];  // band_cells counts; with two thresholds pos then neg
  int* counts = reinterpret_cast<int*>(s_band4);
  const int b = blockIdx.x, k = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int HW = H * W;
  const int cell0 = k * band_cells;
  const int cells = min(band_cells, HW - cell0);

  // this warp's first chunk: the run of band k in it and the run's first
  // keys in flight while the band is zeroed
  const WindowChunks wc = window_chunks(chunk_end, key_base, b, N);
  const long long first = wc.c0 + warp;
  int s0 = 0, s1 = 0, key = 0;
  const int* run = nullptr;
  auto find_run = [&](long long c) {
    const int* row = table + static_cast<size_t>(c) * (bands + 1) + k;
    s0 = __ldg(row);
    s1 = __ldg(row + 1);
    run = keys + wc.key0 + static_cast<size_t>(c - wc.c0) * kChunk;
  };
  if (first < wc.c1) {
    find_run(first);
    if (s0 + lane < s1) key = __ldg(run + s0 + lane);
  }
  const int n4 = (two_pass ? 2 : 1) * band_cells / 4;
  for (int i = tid; i < n4; i += nthreads) s_band4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  auto add = [&](int kv) {
    const int idx = (kv >> 1) - cell0;
    if (two_pass) {
      atomicAdd(&counts[(kv & 1) ? band_cells + idx : idx], 1);
    } else {
      atomicAdd(&counts[idx], (kv & 1) ? -1 : 1);
    }
  };
  for (long long c = first; c < wc.c1; c += nwarps) {
    int i = s0 + lane;
    if (c == first) {
      if (i < s1) add(key);
      i += 32;
    } else {
      find_run(c);
      i = s0 + lane;
    }
    for (; i < s1; i += 32) add(__ldg(run + i));
  }
  __syncthreads();

  float* ob = out + static_cast<size_t>(b) * HW + cell0;
  for (int i = tid; i < cells; i += nthreads) {
    ob[i] = two_pass ? two_pass_value(pos_thresh, neg_thresh, counts[i], counts[band_cells + i],
                                      fused != 0)
                     : __fmul_rn(pos_thresh, static_cast<float>(counts[i]));
  }
}

// K3's band: cell i at word i (int32 counts), or two int16 counts a word,
// cell i in the low (even i) or high (odd i) half of word i / 2; the signed
// +-1 and +-65536 adds keep word == hi * 65536 + lo exactly while |hi|,
// |lo| <= 32767, which kMaxPacked events per window guarantee
template <bool kPacked>
struct Band {
  static constexpr int kThreads = kPacked ? kPackedThreads : kResizedThreads;
  static constexpr int kCellsPerInt4 = kPacked ? 8 : 4;

  __device__ __forceinline__ static void add(int* base, int cell, int owner, int rank, int s) {
    if (kPacked) {
      add_to(base, cell >> 1, owner, rank, (cell & 1) ? s * 65536 : s);
    } else {
      add_to(base, cell, owner, rank, s);
    }
  }

  __device__ __forceinline__ static int at(const int* words, int cell) {
    return kPacked ? decode_count(words, cell) : words[cell];
  }

  // fn(count) for the cells of one word
  template <typename Fn>
  __device__ __forceinline__ static void cells_of(int w, Fn&& fn) {
    if (kPacked) {
      const int lo = static_cast<int>(static_cast<int16_t>(w & 0xFFFF));
      fn(lo);
      fn((w - lo) >> 16);  // exact: w - lo is a multiple of 65536
    } else {
      fn(w);
    }
  }
};

// K2 (kResize false) and K3 (kResize true) on one cluster per window
template <bool kPacked, bool kResize>
__global__ void __launch_bounds__(Band<kPacked>::kThreads, kPacked ? 2 : 1)
hist_scaled_cluster_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           const int* __restrict__ pol, const float* __restrict__ taps,
                           float* __restrict__ out, float* __restrict__ qout, int N, int H,
                           int W, int h_out, int w_out, int kth, float thresh, int iters) {
  // dynamic: the band (Band<kPacked>'s layout; K2's from its `lead` on);
  // the window's list of |count| >= kTable; K3's taps and the next band's
  // first row
  extern __shared__ int4 smem4[];
  // the window's #(|count| == v) for v < kTable, then their CDF; its max
  // |count|; the length of its list.  Every CTA adds its band's into every
  // CTA's (this one's too) before the third cluster barrier.
  __shared__ int s_cdf[kTable];
  __shared__ int s_max, s_merged;
  __shared__ float s_scale;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rows = band_rows(H, C);
  const int stride = kResize ? resized_band_words(H, W, C, kPacked)
                             : scaled_band_words(H, W, C, kPacked);
  const int band_cells = rows * W;
  const int row0 = rank * rows;
  const int row_end = min(row0 + rows, H);
  const int cells = max(0, row_end - row0) * W;
  const int n_taps = kResize ? 4 * (h_out + w_out) : 0;
  const int halo_words = resized_halo_words(W, kPacked);
  const float inv_band_cells = 1.f / static_cast<float>(band_cells);
  int* band = reinterpret_cast<int*>(smem4);
  int* large = band + stride;
  float* s_taps = reinterpret_cast<float*>(large + large_capacity(N));
  int* halo = reinterpret_cast<int*>(s_taps + n_taps);
  const int* next_row =
      kResize && row_end < H ? cluster.map_shared_rank(band, rank + 1) : nullptr;
  // K2: cell i of CTA r's band at slot lead(r) + i, lead(r) being the
  // output's word offset of that cell mod 4 (K1's layout); K3: at slot i
  const size_t frame0 = static_cast<size_t>(b) * H * W;
  const size_t out_word = reinterpret_cast<uintptr_t>(out) / sizeof(float);
  auto lead_of = [&](int r) {
    return kResize ? 0
                   : static_cast<int>((out_word + frame0 + static_cast<size_t>(r) * band_cells) &
                                      3);
  };
  const int lead = lead_of(rank);
  const int slots = lead + cells;
  EVFLY_STAMP(!kResize, 0);

  // 1. this thread's first group of events and first taps in flight (the
  //    taps land in shared memory after the events), its later groups on
  //    their way to L2; zero the band and the counters; no event lands
  //    before every band is zero
  const size_t ev0 = static_cast<size_t>(b) * N;
  const EventSlice slice = event_slice(x + ev0, y + ev0, pol + ev0, N, C, rank);
  EventGroup first = {};
  if (tid < slice.groups) first = load_group(x + ev0, y + ev0, pol + ev0, slice, tid);
  for (int g = tid + nthreads; g < slice.groups; g += nthreads) {
    prefetch_group(x + ev0, y + ev0, pol + ev0, slice, g);
  }
  const float tap = tid < n_taps ? __ldg(taps + tid) : 0.f;
  for (int i = tid; i < stride / 4; i += nthreads) smem4[i] = make_int4(0, 0, 0, 0);
  for (int i = tid; i < kTable; i += nthreads) s_cdf[i] = 0;
  if (tid == 0) { s_max = 0; s_merged = 0; }
  cluster.sync();
  EVFLY_STAMP(!kResize, 1);

  // 2. this CTA's slice of the events into their owners' bands
  for_each_event(x + ev0, y + ev0, pol + ev0, slice, first, [&](float xf, float yf, int p) {
    int s = 0;
    const int idx = bin_event(xf, yf, p, H, W, &s);
    if (idx < 0) return;
    // idx / band_cells: the float estimate is off by at most one
    int owner = __float2int_rz(static_cast<float>(idx) * inv_band_cells);
    owner -= owner * band_cells > idx;
    owner += (owner + 1) * band_cells <= idx;
    Band<kPacked>::add(band, lead_of(owner) + idx - owner * band_cells, owner, rank, s);
  });
  // the taps in shared memory, their two row or column indices as ints
  auto put_tap = [&](int i, float t) {
    s_taps[i] = (i & 3) < 2 ? __int_as_float(static_cast<int>(t)) : t;
  };
  if (tid < n_taps) put_tap(tid, tap);
  for (int i = tid + nthreads; i < n_taps; i += nthreads) put_tap(i, __ldg(taps + i));
  cluster.sync();  // every event counted
  EVFLY_STAMP(!kResize, 2);

  // 3. K3: the next band's first row, the second tap row of this band's
  //    last output rows, copied in (its first part in flight during the
  //    scan).  This band's count-of-counts (`SmallCounts`): |count| < kSmall
  //    in registers (most cells), up to kTable and from kTable on (into the
  //    list) taken out again and added into every CTA's table or list
  const int4 halo_first = next_row != nullptr && tid < halo_words / 4
                              ? reinterpret_cast<const int4*>(next_row)[tid]
                              : make_int4(0, 0, 0, 0);
  // v added into word w of every CTA's shared memory
  auto add_everywhere = [&](int* w, int v) {
    for (int r = 0; r < C; ++r) atomicAdd(r == rank ? w : cluster.map_shared_rank(w, r), v);
  };
  constexpr int kPerInt4 = Band<kPacked>::kCellsPerInt4;
  SmallCounts small;
  int my_max = 0;
  auto rare = [&](int c) {
    const int a = abs(c);
    if (a < kSmall) return;
    small.take(static_cast<unsigned>(a));
    if (a < kTable) {
      add_everywhere(&s_cdf[a], 1);
      return;
    }
    for (int r = 0; r < C; ++r) {
      int* len = r == rank ? &s_merged : cluster.map_shared_rank(&s_merged, r);
      int* list = r == rank ? large : cluster.map_shared_rank(large, r);
      list[atomicAdd(len, 1)] = a;
    }
  };
  // the slots [0, lead) before K2's first cell are zero and not cells
  if (tid == 0) small.seen = -lead;
  for (int g = tid; g < slots / kPerInt4; g += nthreads) {
    const int4 v = smem4[g];
    int m = 0;
    auto tally_m = [&](int c) { small.add(c, m); };
    Band<kPacked>::cells_of(v.x, tally_m);
    Band<kPacked>::cells_of(v.y, tally_m);
    Band<kPacked>::cells_of(v.z, tally_m);
    Band<kPacked>::cells_of(v.w, tally_m);
    if (m >= kSmall) {
      Band<kPacked>::cells_of(v.x, rare);
      Band<kPacked>::cells_of(v.y, rare);
      Band<kPacked>::cells_of(v.z, rare);
      Band<kPacked>::cells_of(v.w, rare);
    }
    my_max = max(my_max, m);
    small.seen += kPerInt4;
  }
  for (int i = slots / kPerInt4 * kPerInt4 + tid; i < slots; i += nthreads) {
    const int c = Band<kPacked>::at(band, i);
    small.add(c, my_max);
    rare(c);
    ++small.seen;
  }
  {
    unsigned n[kSmall];
    small.counts(n);
#pragma unroll
    for (int v = 0; v < kSmall; ++v) {
      const unsigned t = __reduce_add_sync(0xffffffffu, n[v]);
      if (lane == 0 && t > 0) add_everywhere(&s_cdf[v], static_cast<int>(t));
    }
  }
  my_max = __reduce_max_sync(0xffffffffu, my_max);
  if (lane == 0) {
    for (int r = 0; r < C; ++r) {
      atomicMax(r == rank ? &s_max : cluster.map_shared_rank(&s_max, r), my_max);
    }
  }
  if (next_row != nullptr) {
    int4* halo4 = reinterpret_cast<int4*>(halo);
    if (tid < halo_words / 4) halo4[tid] = halo_first;
    for (int g = tid + nthreads; g < halo_words / 4; g += nthreads) {
      halo4[g] = reinterpret_cast<const int4*>(next_row)[g];
    }
    for (int c = halo_words / 4 * 4 + tid; c < halo_words; c += nthreads) {
      halo[c] = next_row[c];
    }
  }
  // every band's counts, max and list are in every CTA; no CTA reads or
  // writes another's shared memory from here on, so none waits for the
  // others again, not even to exit
  cluster.sync();
  EVFLY_STAMP(!kResize, 3);

  // 4. the CDF of the table; the TPU kernel's bisection in one warp, its
  //    scale shared
  if (warp == 0) {  // kTable == 64: two entries per lane
    const int a0 = s_cdf[2 * lane], a1 = s_cdf[2 * lane + 1];
    const int incl = warp_inclusive_scan(a0 + a1);
    const int cdf0 = incl - a1, cdf1 = incl;  // the CDF at 2 * lane, 2 * lane + 1
    s_cdf[2 * lane] = cdf0;
    s_cdf[2 * lane + 1] = cdf1;
    __syncwarp();
    const int maxv = s_max, n_large = s_merged;
    // #(|count| <= m): the table's CDF below kTable, beyond it the CDF's
    // last entry and the list's entries <= m (m is the same in every lane)
    auto cdf_at = [&](int m) {
      if (m < kTable) return s_cdf[m];
      int n = 0;
      for (int i = lane; i < n_large; i += 32) n += large[i] <= m;
      return s_cdf[kTable - 1] + warp_sum(n);
    };
    // the CDF does not decrease, so the test cdf_at(m) < kth is m < v, v
    // the least m whose CDF reaches kth; where v < kTable (the table's CDF
    // reaches kth), v is the number of its entries below kth and no step
    // reads memory
    const bool in_table = s_cdf[kTable - 1] >= kth;
    const int v = __popc(__ballot_sync(0xffffffffu, cdf0 < kth)) +
                  __popc(__ballot_sync(0xffffffffu, cdf1 < kth));
    float lo = 0.f, hi = static_cast<float>(maxv);
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      const int m = min(static_cast<int>(floorf(mid)), maxv);
      if (in_table ? m < v : cdf_at(m) < kth) lo = mid; else hi = mid;
    }
    const float qv = v == 0 ? 0.f : hi;  // #(|count| == 0) reaches kth
    // multiply by the reciprocal, as the TPU kernel rounds
    if (lane == 0) s_scale = qv > 0.f ? 1.f / fmaxf(qv, 1e-30f) : thresh;
    if (rank == 0 && lane == 0) qout[b] = qv;
  }
  __syncthreads();
  const float scale = s_scale;
  EVFLY_STAMP(!kResize, 4);

  if constexpr (!kResize) {
    // 5. K2: the band's cells, clipped, to out with 16-byte stores: slot s
    //    of the band is word s of `dst`, which is 16-byte aligned
    float* dst = out + frame0 + static_cast<size_t>(row0) * W - lead;
    auto value = [&](int s) {
      return clip_scaled(count_to_float(Band<kPacked>::at(band, s)), scale);
    };
    const int g0 = min((lead + 3) / 4, slots / 4), g1 = slots / 4;  // whole groups of 4
    for (int s = lead + tid; s < min(4 * g0, slots); s += nthreads) dst[s] = value(s);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int g = g0 + tid; g < g1; g += nthreads) {
      int c[4];
      if (kPacked) {  // four slots, two words
        const int2 w = reinterpret_cast<const int2*>(band)[g];
        int k = 0;
        auto put = [&](int count) { c[k++] = count; };
        Band<kPacked>::cells_of(w.x, put);
        Band<kPacked>::cells_of(w.y, put);
      } else {
        const int4 w = smem4[g];
        c[0] = w.x, c[1] = w.y, c[2] = w.z, c[3] = w.w;
      }
      dst4[g] = make_float4(clip_scaled(count_to_float(c[0]), scale),
                            clip_scaled(count_to_float(c[1]), scale),
                            clip_scaled(count_to_float(c[2]), scale),
                            clip_scaled(count_to_float(c[3]), scale));
    }
    for (int s = max(4 * g1, lead) + tid; s < slots; s += nthreads) dst[s] = value(s);
#ifdef EVFLY_PHASE_STAMPS
    __syncthreads();  // every thread's stores issued
#endif
    EVFLY_STAMP(true, 5);
  } else {
    // 5. K3: the output rows whose first tap row lies in this band, one
    //    warp per row; a second tap row past the band is the next band's
    //    first, in halo
    auto scaled_at = [&](int row, int col) {
      const int c = row < row_end ? Band<kPacked>::at(band, (row - row0) * W + col)
                                  : Band<kPacked>::at(halo, col);
      return clip_scaled(count_to_float(c), scale);
    };
    // (i0, i1, w0, w1) of an output row, then of an output column
    const float4* th = reinterpret_cast<const float4*>(s_taps);
    const float4* tw = th + h_out;
    float* ob = out + static_cast<size_t>(b) * h_out * w_out;
    for (int i = warp; i < h_out; i += nthreads >> 5) {
      const float4 r = th[i];
      const int h0 = __float_as_int(r.x), h1 = __float_as_int(r.y);
      if (h0 < row0 || h0 >= row_end) continue;
      for (int j = lane; j < w_out; j += 32) {
        const float4 c = tw[j];
        const int c0 = __float_as_int(c.x), c1 = __float_as_int(c.y);
        const float s00 = scaled_at(h0, c0);
        const float s10 = scaled_at(h1, c0);
        const float s01 = scaled_at(h0, c1);
        const float s11 = scaled_at(h1, c1);
        // rows first, then columns: the order of the TPU kernel's two matmuls
        const float t0 = r.z * s00 + r.w * s10;
        const float t1 = r.z * s01 + r.w * s11;
        ob[i * w_out + j] = t0 * c.z + t1 * c.w;
      }
    }
  }
}

// ---------------------------------------- K2 and K3 over K1's counts

// Cell i of a window of scale_counts is at slot lead + i, lead being the word
// offset of the window's first cell mod 4 in the counts and in the output
// (both 16-byte aligned), so slot group g is one float4 of either.  CTA r
// takes slots [r * per, (r + 1) * per) of [lead, lead + H * W): a multiple of
// 4 slots each, so every slice but the first starts a group.
__host__ __device__ __forceinline__ int scale_slice_slots(int HW, int cluster) {
  return round_up4((HW + 3 + cluster - 1) / cluster);
}

// whether a CTA's slice of the frame, as float4s, fits its shared memory
__host__ __device__ __forceinline__ bool scale_slice_cached(int HW, int cluster) {
  return static_cast<size_t>(scale_slice_slots(HW, cluster)) * sizeof(float) <=
         static_cast<size_t>(kScaleSmemLimit);
}

// the two halves of a cluster barrier: arrive without ordering memory (this
// CTA has started; nothing it wrote need be seen), and wait for every CTA's
// arrival
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// a CTA's part of the window's count-of-counts: #(|count| == v) for v <
// kTable, then its max |count| and the length of its list
constexpr int kScaleSlot = kTable + 2;

// counts (B, H, W) of exact integers -> q[b] and, kResize false, the clipped
// frame (B, H, W); kResize true, the resized input (B, h_out, w_out) from
// K3's taps.  `lists` (B, H, W) ints of scratch: each CTA's list of |count|
// >= kTable at the offset of its first cell.  `cached`: the frame kernel
// keeps its slice in shared memory (scale_slice_cached).
template <bool kResize>
__global__ void __launch_bounds__(kScaleThreads)
scale_counts_cluster_kernel(const float* __restrict__ counts, const float* __restrict__ taps,
                            float* __restrict__ out, float* __restrict__ qout, int* lists,
                            int H, int W, int h_out, int w_out, int kth, float thresh,
                            int iters, int cached) {
  extern __shared__ float4 s_slice[];  // the frame kernel's slice, cached
  // slot r: CTA r's part (kScaleSlot), written there by CTA r
  __shared__ int s_parts[kMaxCluster][kScaleSlot];
  __shared__ int s_local[kScaleSlot];
  __shared__ int s_warp[kScaleThreads / 32];
  __shared__ int s_vk, s_rank, s_maxv;
  __shared__ float s_scale;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int HW = H * W;
  const size_t frame0 = static_cast<size_t>(b) * HW;
  const int lead = static_cast<int>(frame0 & 3);
  const int per = scale_slice_slots(HW, C);
  auto slice_start = [&](int r) { return max(lead, r * per); };  // in slots
  const int s0 = slice_start(rank);
  const int s1 = max(s0, min(lead + HW, (rank + 1) * per));
  const int g0 = min((s0 + 3) / 4, s1 / 4), g1 = s1 / 4;  // whole groups of 4
  const float* src = counts + frame0 - lead;  // slot s at src[s]
  const float4* src4 = reinterpret_cast<const float4*>(src);
  int* list = lists + frame0 + (s0 - lead);   // this CTA's list, s1 - s0 entries at most

  // 1. this CTA has started (the slots of its s_parts may be written from
  //    step 3 on); its first batch of counts in flight; its part zeroed
  cluster_arrive_relaxed();
  float4 v[kScaleBatch];
  auto load_batch = [&](int base) {
#pragma unroll
    for (int k = 0; k < kScaleBatch; ++k) {
      const int g = base + k * nthreads;
      v[k] = g < g1 ? __ldg(src4 + g) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_batch(g0 + tid);
  for (int i = tid; i < kScaleSlot; i += nthreads) s_local[i] = 0;
  __syncthreads();

  // 2. the slice's count-of-counts (`SmallCounts`), |count| >= kSmall taken
  //    out again into this CTA's table or list
  SmallCounts small;
  int my_max = 0;
  auto rare = [&](int c) {
    const int a = abs(c);
    if (a < kSmall) return;
    small.take(static_cast<unsigned>(a));
    if (a < kTable) {
      atomicAdd(&s_local[a], 1);
    } else {
      list[atomicAdd(&s_local[kTable + 1], 1)] = a;
    }
  };
  auto tally = [&](float f, int& m) { small.add(__float2int_rz(f), m); };
  auto tally_rare = [&](float f) { rare(__float2int_rz(f)); };
  for (int base = g0 + tid; base < g1; base += kScaleBatch * nthreads) {
    if (base != g0 + tid) load_batch(base);
#pragma unroll
    for (int k = 0; k < kScaleBatch; ++k) {
      const int g = base + k * nthreads;
      if (g >= g1) break;
      if (!kResize && cached) s_slice[g - g0] = v[k];
      int m = 0;
      tally(v[k].x, m);
      tally(v[k].y, m);
      tally(v[k].z, m);
      tally(v[k].w, m);
      if (m >= kSmall) {
        tally_rare(v[k].x);
        tally_rare(v[k].y);
        tally_rare(v[k].z);
        tally_rare(v[k].w);
      }
      my_max = max(my_max, m);
      small.seen += 4;
    }
  }
  // the slots before the first whole group and after the last, one by one
  auto one = [&](int s) {
    const float f = __ldg(src + s);
    tally(f, my_max);
    tally_rare(f);
    ++small.seen;
  };
  for (int s = s0 + tid; s < min(4 * g0, s1); s += nthreads) one(s);
  for (int s = max(4 * g1, s0) + tid; s < s1; s += nthreads) one(s);
  {
    unsigned n[kSmall];
    small.counts(n);
#pragma unroll
    for (int k = 0; k < kSmall; ++k) {
      const unsigned t = __reduce_add_sync(0xffffffffu, n[k]);
      if (lane == 0 && t > 0) atomicAdd(&s_local[k], static_cast<int>(t));
    }
  }
  my_max = __reduce_max_sync(0xffffffffu, my_max);
  if (lane == 0) atomicMax(&s_local[kTable], my_max);
  __syncthreads();

  // 3. every CTA has started: this CTA's part into its slot of every CTA's
  //    s_parts; one cluster barrier ends the exchange (and orders the lists'
  //    stores before the reads of step 4)
  cluster_wait();
  for (int i = tid; i < C * kScaleSlot; i += nthreads) {
    const int r = i / kScaleSlot, j = i - r * kScaleSlot;
    int* slot = &s_parts[rank][j];
    *(r == rank ? slot : cluster.map_shared_rank(slot, r)) = s_local[j];
  }
  cluster.sync();  // no CTA touches another's shared memory from here on

  // 4. v_k, the kth smallest |count|: from the CDF of the merged table in
  //    one warp (its entries below kth, where the CDF reaches kth), else
  //    the rank-th smallest entry of the lists, all >= kTable
  if (warp == 0) {  // kTable == 64: two entries per lane
    int a0 = 0, a1 = 0, maxv = 0;
    for (int r = 0; r < C; ++r) {
      a0 += s_parts[r][2 * lane];
      a1 += s_parts[r][2 * lane + 1];
      maxv = max(maxv, s_parts[r][kTable]);
    }
    const int incl = warp_inclusive_scan(a0 + a1);
    const int cdf0 = incl - a1, cdf1 = incl;  // the CDF at 2 * lane, 2 * lane + 1
    const int v_table = __popc(__ballot_sync(0xffffffffu, cdf0 < kth)) +
                        __popc(__ballot_sync(0xffffffffu, cdf1 < kth));
    const int below = __shfl_sync(0xffffffffu, cdf1, 31);  // #(|count| < kTable)
    if (lane == 0) {
      s_vk = below >= kth ? v_table : -1;
      s_rank = kth - below;
      s_maxv = maxv;
    }
  }
  __syncthreads();
  int vk = s_vk;
  if (vk < 0) {
    // the least v in [kTable, max] with #(list entries <= v) >= s_rank: a
    // search by halving over the lists (in global memory, stored by every
    // CTA before the barrier), the whole block counting each step
    int lo = kTable, hi = s_maxv;
    while (lo < hi) {
      const int mid = lo + (hi - lo) / 2;
      int n = 0;
      for (int r = 0; r < C; ++r) {
        const int* seg = lists + frame0 + (slice_start(r) - lead);
        const int len = s_parts[r][kTable + 1];
        for (int i = tid; i < len; i += nthreads) n += __ldcg(seg + i) <= mid;
      }
      if (block_sum(n, s_warp) >= s_rank) hi = mid; else lo = mid + 1;
    }
    vk = lo;
  }

  // 5. the plain version's 18-step bisection (ops/percentile.py): its test
  //    #(|count| <= mid) < kth is mid < v_k, and its zero snap
  //    #(|count| == 0) >= kth is v_k == 0
  if (tid == 0) {
    const float v_f = static_cast<float>(vk);
    float lo = 0.f, hi = static_cast<float>(s_maxv);
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      if (mid < v_f) lo = mid; else hi = mid;
    }
    const float qv = vk == 0 ? 0.f : hi;
    // multiply by the reciprocal, as the TPU kernel rounds
    s_scale = qv > 0.f ? 1.f / fmaxf(qv, 1e-30f) : thresh;
    if (rank == 0) qout[b] = qv;
  }
  __syncthreads();
  const float scale = s_scale;

  if constexpr (!kResize) {
    // 6. the slice of the clipped frame, whole groups as 16-byte stores
    float* dst = out + frame0 - lead;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int g = g0 + tid; g < g1; g += nthreads) {
      const float4 c = cached ? s_slice[g - g0] : __ldg(src4 + g);
      dst4[g] = make_float4(clip_scaled(c.x, scale), clip_scaled(c.y, scale),
                            clip_scaled(c.z, scale), clip_scaled(c.w, scale));
    }
    for (int s = s0 + tid; s < min(4 * g0, s1); s += nthreads) {
      dst[s] = clip_scaled(__ldg(src + s), scale);
    }
    for (int s = max(4 * g1, s0) + tid; s < s1; s += nthreads) {
      dst[s] = clip_scaled(__ldg(src + s), scale);
    }
  } else {
    // 6. this CTA's share of the bilinear resize from the taps, the taps'
    //    counts read from L2
    const float* cb = counts + frame0;
    const float* th = taps;
    const float* tw = taps + 4 * h_out;
    float* ob = out + static_cast<size_t>(b) * h_out * w_out;
    for (int o = rank * nthreads + tid; o < h_out * w_out; o += C * nthreads) {
      const int i = o / w_out, j = o - i * w_out;
      const int h0 = static_cast<int>(__ldg(th + 4 * i)), h1 = static_cast<int>(__ldg(th + 4 * i + 1));
      const float a0 = __ldg(th + 4 * i + 2), a1 = __ldg(th + 4 * i + 3);
      const int c0 = static_cast<int>(__ldg(tw + 4 * j)), c1 = static_cast<int>(__ldg(tw + 4 * j + 1));
      const float b0 = __ldg(tw + 4 * j + 2), b1 = __ldg(tw + 4 * j + 3);
      const float t0 = a0 * clip_scaled(__ldg(cb + h0 * W + c0), scale) +
                       a1 * clip_scaled(__ldg(cb + h1 * W + c0), scale);
      const float t1 = a0 * clip_scaled(__ldg(cb + h0 * W + c1), scale) +
                       a1 * clip_scaled(__ldg(cb + h1 * W + c1), scale);
      ob[o] = t0 * b0 + t1 * b1;
    }
  }
}

// Sets a kernel's shared-memory attributes on the current device once, for
// the largest size its wrapper gives it (`smem`); for a cluster kernel also
// clusters of up to kMaxCluster CTAs and the largest shared-memory carveout.
// `done` holds one bit for each device already set.
template <typename Kernel>
cudaError_t prepare_once(Kernel kernel, std::atomic<uint64_t>* done, bool cluster,
                         int smem = kSmemLimit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done->load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  done->fetch_or(bit);
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(int B, int cluster, int threads, size_t smem, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

std::atomic<uint64_t> g_band_partition_done{0}, g_band_done{0}, g_frame_cluster_done{0};
// hist_scaled_cluster_kernel<kPacked, kResize>, by 2 * kResize + kPacked;
// scale_counts_cluster_kernel<kResize>, by kResize
std::atomic<uint64_t> g_scaled_done[4] = {}, g_scale_counts_done[2] = {};

// K2's (kResize false) or K3's cluster kernel for windows of N events
// (packed where resized_packed(N)), its shared-memory attributes set on the
// current device
template <bool kResize>
cudaError_t scaled_cluster_kernel(int N, void (**kernel)(const float*, const float*,
                                                          const int*, const float*, float*,
                                                          float*, int, int, int, int, int, int,
                                                          float, int)) {
  const bool packed = resized_packed(N);
  *kernel = packed ? hist_scaled_cluster_kernel<true, kResize>
                   : hist_scaled_cluster_kernel<false, kResize>;
  return prepare_once(*kernel, &g_scaled_done[2 * kResize + packed], true);
}

// K2 or K3 on clusters of `cluster` CTAs, one cluster per window, N events
// each (at most the kernel's cap); taps are read only by K3
template <bool kResize>
int launch_scaled_cluster(const void* x, const void* y, const void* pol, const void* taps,
                          void* out, void* qout, int B, int N, int H, int W, int h_out,
                          int w_out, int cluster, int kth, float thresh, int iters,
                          void* stream) {
  const int cap = kResize ? resized_cluster_cap(H, W, h_out, w_out, cluster)
                          : scaled_cluster_cap(H, W, cluster);
  if (N < 0 || N > cap) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const float*, const float*, const int*, const float*, float*, float*, int,
                 int, int, int, int, int, float, int) = nullptr;
  cudaError_t err = scaled_cluster_kernel<kResize>(N, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    const bool packed = resized_packed(N);
    const size_t smem = kResize ? resized_cluster_smem(H, W, N, h_out, w_out, cluster)
                                : scaled_cluster_smem(H, W, N, cluster);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(
        B, cluster, packed ? kPackedThreads : kResizedThreads, smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x),
                             static_cast<const float*>(y), static_cast<const int*>(pol),
                             static_cast<const float*>(taps), static_cast<float*>(out),
                             static_cast<float*>(qout), N, H, W, h_out, w_out, kth, thresh,
                             iters);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {

// K1's band route over B windows: of a (B, N) batch, or with offsets
// (begin, end non-null) the windows [begin[b], end[b]) of one stream, with
// chunk_end and key_base as window_chunks reads them and `chunks` their
// total.  `keys` holds one int per event of each window (the sum of their
// lengths), `table` chunks x (bands + 1) ints: both scratch of the caller,
// on its stream.  `chunk` must be kChunk (the wrapper's cumsums count by
// it).  Two launches: the partition pass, then the band pass.
int launch_hist_band(const void* x, const void* y, const void* pol, const void* begin,
                     const void* end, const void* chunk_end, const void* key_base, void* keys,
                     void* table, void* out, int B, int N, long long chunks, int H, int W,
                     int chunk, float pos_thresh, float neg_thresh, int two_pass,
                     void* stream) {
  const int band_cells = band_route_cells(H, W, two_pass);
  if (band_cells < 0 || chunk != kChunk || B < 0 || N < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bands = band_count(H, W, band_cells);
  if (begin == nullptr) chunks = static_cast<long long>(B) * ((N + kChunk - 1) / kChunk);
  if (chunks < 0 || chunks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t part_smem = static_cast<size_t>(round_up4(bands + 1) + kChunk) * sizeof(int);
  const size_t band_smem = static_cast<size_t>((two_pass ? 2 : 1) * band_cells) * sizeof(int);
  cudaError_t err = prepare_once(hist_band_partition_kernel, &g_band_partition_done, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare_once(hist_band_kernel, &g_band_done, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* ce = static_cast<const long long*>(chunk_end);
  const auto* kb = static_cast<const long long*>(key_base);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks > 0) {
    hist_band_partition_kernel<<<static_cast<unsigned>(chunks), kPartThreads, part_smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const int*>(pol), static_cast<const long long*>(begin),
        static_cast<const long long*>(end), ce, kb, B, N, H, W, band_cells, bands,
        static_cast<int*>(keys), static_cast<int*>(table));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B > 0) {
    hist_band_kernel<<<dim3(static_cast<unsigned>(B), bands), kBandRouteThreads, band_smem, s>>>(
        static_cast<const int*>(keys), static_cast<const int*>(table), ce, kb,
        static_cast<float*>(out), N, H, W, band_cells, bands, pos_thresh, neg_thresh, two_pass,
        begin != nullptr ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's cluster kernel over B windows: of a (B, N) batch, or with offsets
// (begin, end non-null) the windows [begin[b], end[b]) of one stream
int launch_hist_frame_cluster(const void* x, const void* y, const void* pol, const void* begin,
                              const void* end, void* out, int B, int N, int H, int W,
                              int cluster, float pos_thresh, float neg_thresh, int two_pass,
                              void* stream) {
  if (!frame_cluster_fits(H, W, two_pass, cluster)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare_once(hist_frame_cluster_kernel, &g_frame_cluster_done, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(
        B, cluster, kFrameThreads, frame_cluster_smem(H, W, two_pass, cluster), stream, &attr);
    err = cudaLaunchKernelEx(&cfg, hist_frame_cluster_kernel, static_cast<const float*>(x),
                             static_cast<const float*>(y), static_cast<const int*>(pol),
                             static_cast<const long long*>(begin),
                             static_cast<const long long*>(end), static_cast<float*>(out), N,
                             H, W, pos_thresh, neg_thresh, two_pass);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1's band route over a (B, N) batch (frames no cluster holds): `keys`
// B * N ints and `table` (B * ceil(N / chunk), bands + 1) ints of scratch
extern "C" int evfly_hist_frame(const void* x, const void* y, const void* pol, void* keys,
                                void* table, void* out, int B, int N, int H, int W, int chunk,
                                float pos_thresh, float neg_thresh, int two_pass,
                                void* stream) {
  return launch_hist_band(x, y, pol, nullptr, nullptr, nullptr, nullptr, keys, table, out, B, N,
                          0, H, W, chunk, pos_thresh, neg_thresh, two_pass, stream);
}

// K1's band route over T time windows of one sorted stream: window b is
// the events [begin[b], end[b]) (int64, each below 2^31); chunk_end and
// key_base (T,) int64, the running totals of the windows' chunks (of
// `chunk` events) and of their lengths before b; `chunks` chunks in all;
// `keys` one int per event of each window, `table` (chunks, bands + 1)
// ints of scratch
extern "C" int evfly_hist_frame_windows(const void* x, const void* y, const void* pol,
                                        const void* begin, const void* end,
                                        const void* chunk_end, const void* key_base, void* keys,
                                        void* table, void* out, int T, long long chunks, int H,
                                        int W, int chunk, float pos_thresh, float neg_thresh,
                                        int two_pass, void* stream) {
  if (begin == nullptr || end == nullptr || chunk_end == nullptr || key_base == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_hist_band(x, y, pol, begin, end, chunk_end, key_base, keys, table, out, T, 0,
                          chunks, H, W, chunk, pos_thresh, neg_thresh, two_pass, stream);
}

// K2's (resize == 0) or K3's (resize != 0) function over K1's counts (B, H,
// W) of exact integers, on clusters of `cluster` CTAs; `lists` is (B, H, W)
// ints of scratch; taps are read only when resize != 0.  counts and out
// must be 16-byte aligned.
extern "C" int evfly_scale_counts(const void* counts, const void* taps, void* out, void* qout,
                                  void* lists, int B, int H, int W, int h_out, int w_out,
                                  int cluster, int kth, float thresh, int iters, int resize,
                                  void* stream) {
  if (H < 1 || W < 1 || !cluster_size_ok(cluster) ||
      (reinterpret_cast<uintptr_t>(counts) | reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = resize ? scale_counts_cluster_kernel<true> : scale_counts_cluster_kernel<false>;
  cudaError_t err =
      prepare_once(kernel, &g_scale_counts_done[resize ? 1 : 0], true, kScaleSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    const int cached = !resize && scale_slice_cached(H * W, cluster);
    const size_t smem =
        cached ? static_cast<size_t>(scale_slice_slots(H * W, cluster)) * sizeof(float) : 0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(B, cluster, kScaleThreads, smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(counts),
                             static_cast<const float*>(taps), static_cast<float*>(out),
                             static_cast<float*>(qout), static_cast<int*>(lists), H, W, h_out,
                             w_out, kth, thresh, iters, cached);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 on clusters of `cluster` CTAs, one cluster per window
extern "C" int evfly_hist_frame_cluster(const void* x, const void* y, const void* pol,
                                        void* out, int B, int N, int H, int W, int cluster,
                                        float pos_thresh, float neg_thresh, int two_pass,
                                        void* stream) {
  return launch_hist_frame_cluster(x, y, pol, nullptr, nullptr, out, B, N, H, W, cluster,
                                   pos_thresh, neg_thresh, two_pass, stream);
}

// K1's cluster kernel over T time windows of one sorted stream, as
// evfly_hist_frame_windows
extern "C" int evfly_hist_frame_cluster_windows(const void* x, const void* y, const void* pol,
                                                const void* begin, const void* end, void* out,
                                                int T, int H, int W, int cluster,
                                                float pos_thresh, float neg_thresh,
                                                int two_pass, void* stream) {
  if (begin == nullptr || end == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_hist_frame_cluster(x, y, pol, begin, end, out, T, 0, H, W, cluster,
                                   pos_thresh, neg_thresh, two_pass, stream);
}

// K2 on clusters of `cluster` CTAs, one cluster per window, N events each
// (at most scaled_cluster_cap(H, W, cluster))
extern "C" int evfly_hist_scaled_cluster(const void* x, const void* y, const void* pol,
                                         void* out, void* qout, int B, int N, int H, int W,
                                         int cluster, int kth, float thresh, int iters,
                                         void* stream) {
  return launch_scaled_cluster<false>(x, y, pol, nullptr, out, qout, B, N, H, W, 0, 0,
                                      cluster, kth, thresh, iters, stream);
}

// K3 on clusters of `cluster` CTAs, one cluster per window, N events each
// (at most resized_cluster_cap(H, W, h_out, w_out, cluster))
extern "C" int evfly_hist_scaled_resized_cluster(const void* x, const void* y, const void* pol,
                                                 const void* taps, void* out, void* qout,
                                                 int B, int N, int H, int W, int h_out,
                                                 int w_out, int cluster, int kth, float thresh,
                                                 int iters, void* stream) {
  return launch_scaled_cluster<true>(x, y, pol, taps, out, qout, B, N, H, W, h_out, w_out,
                                     cluster, kth, thresh, iters, stream);
}

// The rules by which the wrappers choose a route (ops/voxelizer.py holds a
// copy for the CPU): 1 where K1's cluster kernel takes (H, W), else 0
extern "C" int evfly_hist_frame_cluster_fits(int H, int W, int two_pass, int cluster) {
  return frame_cluster_fits(H, W, two_pass, cluster) ? 1 : 0;
}

// K1's route at (H, W): its cluster's CTAs per window, or 0 (the band route)
extern "C" int evfly_hist_frame_route(int H, int W, int two_pass) {
  return frame_cluster_route(H, W, two_pass);
}

// the band route's band at (H, W), in cells, or -1 where it has none
extern "C" int evfly_hist_band_cells(int H, int W, int two_pass) {
  return band_route_cells(H, W, two_pass);
}

// K2's cluster kernel's cap on events per window at (H, W), or -1
extern "C" int evfly_hist_scaled_cluster_cap(int H, int W, int cluster) {
  return scaled_cluster_cap(H, W, cluster);
}

// K3's cluster kernel's cap on events per window at (H, W) -> (h_out,
// w_out), or -1
extern "C" int evfly_hist_resized_cluster_cap(int H, int W, int h_out, int w_out,
                                              int cluster) {
  return resized_cluster_cap(H, W, h_out, w_out, cluster);
}

// cudaOccupancyMaxActiveClusters into *clusters: K1's cluster kernel
// (kind 0, one count array; kind 1, two), K3's with N events and an (h_out,
// w_out) output (kind 2) or K2's with N events (kind 3)
extern "C" int evfly_hist_cluster_occupancy(int kind, int H, int W, int N, int h_out,
                                            int w_out, int cluster, int* clusters) {
  cudaLaunchAttribute attr;
  cudaError_t err = cudaSuccess;
  if (kind == 0 || kind == 1) {
    if (!frame_cluster_fits(H, W, kind, cluster)) return static_cast<int>(cudaErrorInvalidValue);
    err = prepare_once(hist_frame_cluster_kernel, &g_frame_cluster_done, true);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaLaunchConfig_t cfg = cluster_config(
        1, cluster, kFrameThreads, frame_cluster_smem(H, W, kind, cluster), nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(clusters, hist_frame_cluster_kernel, &cfg);
  } else if (kind == 2 || kind == 3) {
    const bool resize = kind == 2;
    const int cap = resize ? resized_cluster_cap(H, W, h_out, w_out, cluster)
                           : scaled_cluster_cap(H, W, cluster);
    if (N < 0 || N > cap) return static_cast<int>(cudaErrorInvalidValue);
    void (*kernel)(const float*, const float*, const int*, const float*, float*, float*, int,
                   int, int, int, int, int, float, int) = nullptr;
    err = resize ? scaled_cluster_kernel<true>(N, &kernel)
                 : scaled_cluster_kernel<false>(N, &kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = resize ? resized_cluster_smem(H, W, N, h_out, w_out, cluster)
                               : scaled_cluster_smem(H, W, N, cluster);
    const cudaLaunchConfig_t cfg = cluster_config(
        1, cluster, resized_packed(N) ? kPackedThreads : kResizedThreads, smem, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef EVFLY_PHASE_STAMPS
// the phase stamps of the last K2 launch: n values of g_stamps into host
extern "C" int evfly_phase_stamps(void* host, int n) {
  if (n < 0 || n > kStampCtas * kStampsPerCta) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_stamps, static_cast<size_t>(n) * sizeof(unsigned long long)));
}
#endif
