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
// hardware does well (shared-memory atomics).
//
// K1 takes any number of events per window, so its counts are int32, and a
// 260x346 int32 frame (352 KiB) is larger than the 227 KB a block may use.
// The frame is cut into bands of rows: one block per (window, band), with
// windows on grid.x (up to 2^31 - 1 of them; grid.y stops at 65,535) and
// bands on grid.y.  Each block reads all of the window's events, counts
// those that fall in its band in shared memory and writes its band.  For the streaming path's
// single window this also puts a dozen SMs to work instead of one.  Counts
// are exact integers; the thresholds are applied with round-to-nearest
// multiplies and subtract (no FMA contraction), as the JAX package does in
// f32, so the frame is bit for bit the JAX one.
//
// K2 and K3 need the whole frame in one block for the quantile:
//
//   * one block per window; the full frame never leaves shared memory.  Two
//     int16 counts share one int32 word.  atomicAdd on the word with +-1 or
//     +-65536 keeps word == hi * 65536 + lo exactly while |hi|, |lo| <=
//     32767, which the wrappers guarantee (events per window).
//   * the quantile comes from a count-of-counts table over |count| in
//     shared memory, prefix-summed once.  Because |count| is an integer,
//     #(|count| <= mid) == CDF[floor(mid)], so each bisection step is O(1)
//     and gives bit for bit the same result as the TPU's masked counts.
//   * K2 writes the clipped frame; K3 reads its <= 2x2 resize taps straight
//     from the packed frame.
//
// A window that K2 and K3 cannot take (more than 32,767 events, or a frame
// and count table past 227 KB) gets their function in two launches: K1's
// counts (thresholds 1: exact integers in f32), then scale_counts_kernel,
// one block per window, which reads the count frame from global memory
// (L2) and runs the plain version's bisection on it: on [0, max |count|],
// `iters` halvings, each counting #(|count| <= mid) over the whole frame,
// and the same zero snap, so the quantile is the plain version's bit for
// bit.  It then writes the clipped frame (K2's function) or the resized
// input from K3's taps (K3's function).
//
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBandThreads = 512;

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

// ---------------------------------------------------------------- K1

__global__ void __launch_bounds__(kBandThreads)
hist_frame_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const int* __restrict__ pol, float* __restrict__ out, int N, int H, int W,
                  int rows_per_band, float pos_thresh, float neg_thresh, int two_pass) {
  extern __shared__ int band[];  // (rows_per_band, W) counts; two_pass: pos then neg
  const int b = blockIdx.x;
  const int row0 = blockIdx.y * rows_per_band;
  const int rows = min(rows_per_band, H - row0);
  const int first = row0 * W, cells = rows * W;
  int* pos_counts = band;
  int* neg_counts = band + rows_per_band * W;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  for (int i = tid; i < (two_pass ? 2 : 1) * rows_per_band * W; i += nthreads) band[i] = 0;
  __syncthreads();

  const float* xb = x + static_cast<size_t>(b) * N;
  const float* yb = y + static_cast<size_t>(b) * N;
  const int* pb = pol + static_cast<size_t>(b) * N;
  for (int e = tid; e < N; e += nthreads) {
    int s = 0;
    const int idx = bin_event(xb[e], yb[e], pb[e], H, W, &s) - first;
    if (idx < 0 || idx >= cells) continue;  // dropped, or another block's band
    if (two_pass) {
      atomicAdd(s > 0 ? &pos_counts[idx] : &neg_counts[idx], 1);
    } else {
      atomicAdd(&band[idx], s);
    }
  }
  __syncthreads();

  float* ob = out + static_cast<size_t>(b) * H * W + first;
  for (int i = tid; i < cells; i += nthreads) {
    if (two_pass) {
      ob[i] = __fsub_rn(__fmul_rn(pos_thresh, static_cast<float>(pos_counts[i])),
                        __fmul_rn(neg_thresh, static_cast<float>(neg_counts[i])));
    } else {
      ob[i] = __fmul_rn(pos_thresh, static_cast<float>(band[i]));
    }
  }
}

// ----------------------------------------------------------- K2 and K3

__device__ __forceinline__ int decode_count(const int* words, int idx) {
  const int w = words[idx >> 1];
  const int lo = static_cast<int>(static_cast<int16_t>(w & 0xFFFF));
  if ((idx & 1) == 0) return lo;
  return (w - lo) / 65536;  // exact: w - lo is a multiple of 65536
}

__device__ __forceinline__ float scaled_count(const int* words, int idx, float scale) {
  return fminf(fmaxf(__fmul_rn(static_cast<float>(decode_count(words, idx)), scale), -1.f),
               1.f);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
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

// Steps 1-4 of K2 and K3 for window b: the packed count frame in
// words[(H*W+1)/2] and the scale in the return value; q goes to qout[b].
__device__ float packed_frame_and_scale(const float* __restrict__ x,
                                        const float* __restrict__ y,
                                        const int* __restrict__ pol, float* __restrict__ qout,
                                        int* words, int* table, int b, int N, int H, int W,
                                        int kth, float thresh, int iters, int table_len) {
  __shared__ int s_zero, s_max;
  __shared__ int s_warp[kThreads / 32];
  __shared__ float s_scale;

  const int HW = H * W;
  const int nwords = (HW + 1) / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;

  for (int i = tid; i < nwords; i += nthreads) words[i] = 0;
  for (int i = tid; i < table_len; i += nthreads) table[i] = 0;
  if (tid == 0) { s_zero = 0; s_max = 0; }
  __syncthreads();

  // 1. bin with np.histogram2d edge rules and accumulate signed counts
  const float* xb = x + static_cast<size_t>(b) * N;
  const float* yb = y + static_cast<size_t>(b) * N;
  const int* pb = pol + static_cast<size_t>(b) * N;
  for (int e = tid; e < N; e += nthreads) {
    int s = 0;
    const int idx = bin_event(xb[e], yb[e], pb[e], H, W, &s);
    if (idx < 0) continue;
    atomicAdd(&words[idx >> 1], (idx & 1) ? s * 65536 : s);
  }
  __syncthreads();

  // 2. count-of-counts table of |count|; zeros are counted in registers
  //    (most cells of a window are empty, one shared counter would serialise)
  int my_zero = 0, my_max = 0;
  for (int i = tid; i < HW; i += nthreads) {
    const int a = abs(decode_count(words, i));
    if (a == 0) {
      ++my_zero;
    } else {
      atomicAdd(&table[a], 1);
      my_max = max(my_max, a);
    }
  }
  my_zero = warp_sum(my_zero);
  my_max = warp_max(my_max);
  if (lane == 0) { atomicAdd(&s_zero, my_zero); atomicMax(&s_max, my_max); }
  __syncthreads();
  if (tid == 0) table[0] = s_zero;
  __syncthreads();

  // 3. inclusive prefix sum of table[0..max] -> CDF
  const int maxv = s_max;
  const int len = maxv + 1;
  const int per = (len + nthreads - 1) / nthreads;
  const int start = min(tid * per, len), stop = min(start + per, len);
  int part = 0;
  for (int i = start; i < stop; ++i) part += table[i];
  const int incl = warp_inclusive_scan(part);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? s_warp[lane] : 0;
    v = warp_inclusive_scan(v);
    s_warp[lane] = v;
  }
  __syncthreads();
  int run = (warp > 0 ? s_warp[warp - 1] : 0) + incl - part;
  for (int i = start; i < stop; ++i) { run += table[i]; table[i] = run; }
  __syncthreads();

  // 4. the TPU kernel's bisection, with O(1) counts
  if (tid == 0) {
    float lo = 0.f, hi = static_cast<float>(maxv);
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      const int m = min(static_cast<int>(floorf(mid)), maxv);
      if (table[m] < kth) lo = mid; else hi = mid;
    }
    const float qv = table[0] >= kth ? 0.f : hi;
    // multiply by the reciprocal, as the TPU kernel rounds
    s_scale = qv > 0.f ? 1.f / fmaxf(qv, 1e-30f) : thresh;
    qout[b] = qv;
  }
  __syncthreads();
  return s_scale;
}

__global__ void __launch_bounds__(kThreads)
hist_scaled_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const int* __restrict__ pol, float* __restrict__ out,
                   float* __restrict__ qout, int N, int H, int W, int kth, float thresh,
                   int iters, int table_len) {
  extern __shared__ int smem[];
  int* words = smem;
  int* table = smem + (H * W + 1) / 2;  // table[v] = #(|count| == v), then the CDF
  const int b = blockIdx.x;
  const float scale = packed_frame_and_scale(x, y, pol, qout, words, table, b, N, H, W, kth,
                                             thresh, iters, table_len);
  // 5. the clipped frame
  float* ob = out + static_cast<size_t>(b) * H * W;
  for (int i = threadIdx.x; i < H * W; i += blockDim.x) ob[i] = scaled_count(words, i, scale);
}

__global__ void __launch_bounds__(kThreads)
hist_scaled_resized_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           const int* __restrict__ pol, const float* __restrict__ taps,
                           float* __restrict__ out, float* __restrict__ qout,
                           int N, int H, int W, int h_out, int w_out, int kth,
                           float thresh, int iters, int table_len) {
  extern __shared__ int smem[];
  int* words = smem;
  int* table = smem + (H * W + 1) / 2;
  const int b = blockIdx.x;
  const float scale = packed_frame_and_scale(x, y, pol, qout, words, table, b, N, H, W, kth,
                                             thresh, iters, table_len);

  // 5. bilinear resize from the <= 2x2 taps; taps rows are (i0, i1, w0, w1)
  const float* th = taps;
  const float* tw = taps + 4 * h_out;
  float* ob = out + static_cast<size_t>(b) * h_out * w_out;
  for (int o = threadIdx.x; o < h_out * w_out; o += blockDim.x) {
    const int i = o / w_out, j = o - i * w_out;
    const int h0 = static_cast<int>(th[4 * i]), h1 = static_cast<int>(th[4 * i + 1]);
    const float a0 = th[4 * i + 2], a1 = th[4 * i + 3];
    const int c0 = static_cast<int>(tw[4 * j]), c1 = static_cast<int>(tw[4 * j + 1]);
    const float b0 = tw[4 * j + 2], b1 = tw[4 * j + 3];
    const float s00 = scaled_count(words, h0 * W + c0, scale);
    const float s10 = scaled_count(words, h1 * W + c0, scale);
    const float s01 = scaled_count(words, h0 * W + c1, scale);
    const float s11 = scaled_count(words, h1 * W + c1, scale);
    // rows first, then columns: the order of the TPU kernel's two matmuls
    const float t0 = a0 * s00 + a1 * s10;
    const float t1 = a0 * s01 + a1 * s11;
    ob[o] = t0 * b0 + t1 * b1;
  }
}

// ------------------------------------------- K2 and K3 over K1's counts

__device__ __forceinline__ float clip_scaled(float count, float scale) {
  return fminf(fmaxf(__fmul_rn(count, scale), -1.f), 1.f);
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

// the max over the block of every thread's v >= 0, in every thread
__device__ float block_max(float v, float* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmaxf(m, s_warp[w]);
  return m;
}

// counts (B, H, W) -> q[b] and, kResize false, the clipped frame (B, H, W);
// kResize true, the resized input (B, h_out, w_out) from K3's taps
template <bool kResize>
__global__ void __launch_bounds__(kThreads)
scale_counts_kernel(const float* __restrict__ counts, const float* __restrict__ taps,
                    float* __restrict__ out, float* __restrict__ qout, int H, int W,
                    int h_out, int w_out, int kth, float thresh, int iters) {
  __shared__ int s_int[kThreads / 32];
  __shared__ float s_flt[kThreads / 32];
  const int HW = H * W;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const float* cb = counts + static_cast<size_t>(b) * HW;

  // 1. max |count| and the number of zeros
  float my_max = 0.f;
  int my_zero = 0;
  for (int i = tid; i < HW; i += nthreads) {
    const float a = fabsf(cb[i]);
    my_max = fmaxf(my_max, a);
    my_zero += a <= 0.f;
  }
  const float maxv = block_max(my_max, s_flt);
  const int zeros = block_sum(my_zero, s_int);

  // 2. the plain version's bisection (ops/percentile.bisect_abs_quantile)
  float lo = 0.f, hi = maxv;
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    int n = 0;
    for (int i = tid; i < HW; i += nthreads) n += fabsf(cb[i]) <= mid;
    if (block_sum(n, s_int) < kth) lo = mid; else hi = mid;
  }
  const float qv = zeros >= kth ? 0.f : hi;
  const float scale = qv > 0.f ? 1.f / fmaxf(qv, 1e-30f) : thresh;
  if (tid == 0) qout[b] = qv;

  // 3. the clipped frame, or the bilinear resize of it from the taps
  if (!kResize) {
    float* ob = out + static_cast<size_t>(b) * HW;
    for (int i = tid; i < HW; i += nthreads) ob[i] = clip_scaled(cb[i], scale);
    return;
  }
  const float* th = taps;
  const float* tw = taps + 4 * h_out;
  float* ob = out + static_cast<size_t>(b) * h_out * w_out;
  for (int o = tid; o < h_out * w_out; o += nthreads) {
    const int i = o / w_out, j = o - i * w_out;
    const int h0 = static_cast<int>(th[4 * i]), h1 = static_cast<int>(th[4 * i + 1]);
    const float a0 = th[4 * i + 2], a1 = th[4 * i + 3];
    const int c0 = static_cast<int>(tw[4 * j]), c1 = static_cast<int>(tw[4 * j + 1]);
    const float b0 = tw[4 * j + 2], b1 = tw[4 * j + 3];
    const float t0 = a0 * clip_scaled(cb[h0 * W + c0], scale) +
                     a1 * clip_scaled(cb[h1 * W + c0], scale);
    const float t1 = a0 * clip_scaled(cb[h0 * W + c1], scale) +
                     a1 * clip_scaled(cb[h1 * W + c1], scale);
    ob[o] = t0 * b0 + t1 * b1;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

size_t packed_smem(int H, int W, int table_len) {
  return static_cast<size_t>((H * W + 1) / 2 + table_len) * sizeof(int);
}

}  // namespace

extern "C" int evfly_hist_frame(const void* x, const void* y, const void* pol, void* out,
                                int B, int N, int H, int W, int rows_per_band,
                                float pos_thresh, float neg_thresh, int two_pass,
                                void* stream) {
  const size_t smem =
      static_cast<size_t>((two_pass ? 2 : 1) * rows_per_band * W) * sizeof(int);
  cudaError_t err = allow_smem(hist_frame_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    const dim3 grid(B, (H + rows_per_band - 1) / rows_per_band);
    hist_frame_kernel<<<grid, kBandThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const int*>(pol), static_cast<float*>(out), N, H, W, rows_per_band,
        pos_thresh, neg_thresh, two_pass);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int evfly_hist_scaled(const void* x, const void* y, const void* pol, void* out,
                                 void* qout, int B, int N, int H, int W, int kth,
                                 float thresh, int iters, int table_len, void* stream) {
  const size_t smem = packed_smem(H, W, table_len);
  cudaError_t err = allow_smem(hist_scaled_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    hist_scaled_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const int*>(pol), static_cast<float*>(out), static_cast<float*>(qout), N,
        H, W, kth, thresh, iters, table_len);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int evfly_hist_scaled_resized(const void* x, const void* y, const void* pol,
                                         const void* taps, void* out, void* qout,
                                         int B, int N, int H, int W, int h_out, int w_out,
                                         int kth, float thresh, int iters, int table_len,
                                         void* stream) {
  const size_t smem = packed_smem(H, W, table_len);
  cudaError_t err = allow_smem(hist_scaled_resized_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    hist_scaled_resized_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const int*>(pol), static_cast<const float*>(taps),
        static_cast<float*>(out), static_cast<float*>(qout), N, H, W, h_out, w_out, kth,
        thresh, iters, table_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2's (resize == 0) or K3's (resize != 0) function over K1's counts
// (B, H, W); taps are read only when resize != 0
extern "C" int evfly_scale_counts(const void* counts, const void* taps, void* out, void* qout,
                                  int B, int H, int W, int h_out, int w_out, int kth,
                                  float thresh, int iters, int resize, void* stream) {
  if (B > 0) {
    auto kernel = resize ? scale_counts_kernel<true> : scale_counts_kernel<false>;
    kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(counts), static_cast<const float*>(taps),
        static_cast<float*>(out), static_cast<float*>(qout), H, W, h_out, w_out, kth, thresh,
        iters);
  }
  return static_cast<int>(cudaGetLastError());
}
