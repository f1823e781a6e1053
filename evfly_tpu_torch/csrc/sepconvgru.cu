// E-RAFT's separable ConvGRU (RAFT's SepConvGRU), each of its two half-steps
// as two kernels: the z and r gates as one implicit GEMM, then the candidate
// q with the GRU's update.
//
// Replaces no Pallas kernel: the JAX package has no E-RAFT.  It was added
// because cuDNN runs these convolutions (384 -> 128 channels, 1x5 and 5x1,
// at the 60x80 of a 480x640 camera's 1/8 map) as a 32x32-tile implicit GEMM
// at about a quarter of the card's f32 peak, and the GRU's concatenations,
// sigmoids, tanh and update as a dozen elementwise kernels around them
// (PERF.md).
//
// The function of a half-step, kernel (1, 5) along W or (5, 1) along H,
// padding 2 along that axis, C_h hidden channels, C_x input channels:
//   z  = sigmoid(conv_z([h, x]) + b_z),  r = sigmoid(conv_r([h, x]) + b_r)
//   q  = tanh(conv_q([r h, x]) + b_q)
//   h' = (1 - z) h + z q
// sepconvgru_zr_conv_kernel is the GEMM of M = B H W pixels, N = 2 C_h (z's
// output channels, then r's) and K = (C_h + C_x) 5; it reads h and x through
// two base pointers (no [h, x] is built), adds the biases, applies the
// sigmoid and writes z and r h.  sepconvgru_q_conv_kernel is the GEMM of N =
// C_h over [r h, x], again through two base pointers; it adds the bias, takes
// the tanh and writes h' with the reference's operations in its order, each
// rounded (no fused multiply-add).  The weights come packed by
// ops/sepconvgru.pack: (C_h + C_x, 5, N), output channels innermost.
//
// What bounds it on the H100: operations.  At E-RAFT's 60x80 a half-step is
// 2 * 4800 * (256 + 128) * 1920 = 7.08 GFLOP, 0.106 ms at 67 TFLOP/s, against
// about 20 MB of inputs, weights and outputs (6 us at 3.35 TB/s), all of
// which L2 holds.  So the design is about keeping the FMA pipes fed:
//   - Full f32: fused multiply-adds into f32 sums, no tensor cores (TF32
//     would round the operands to 10 bits of mantissa).
//   - A block's tile is BL lines (rows for 1x5, columns for 5x1) by BP
//     positions along the convolution's axis by BN output channels.  For each
//     chunk of KC input channels it stages the input slab, with the 2-pixel
//     halo on each side along the axis (zeros outside the image), and the
//     chunk's weights into shared memory by cp.async, in two buffers: chunk
//     k + 1's copies are in flight while chunk k is summed.  The slab keeps
//     the image's layout (a 1x5 block's rows, a 5x1 block's rows of BL
//     columns), so the copies are 16 bytes where the image's rows are 16-byte
//     aligned (4 bytes else), their offsets from a table the block builds
//     once.
//   - A thread sums 4 output channels of P = 20 consecutive positions of one
//     row (1x5; a row padded to a multiple of 20, the padding's outputs not
//     stored) or of P = 4 rows of 4 neighbouring columns (5x1): for each
//     input channel it reads the inputs it needs once (1x5: 24 floats of its
//     row, as float2s and float4s; 5x1: 8 float4s of its columns) and uses
//     them for all 5 taps, with one float4 of weights a tap: 400 (1x5) or
//     320 (5x1) FMAs for 12 or 13 shared loads.
//     Neighbouring threads take neighbouring lines or column quads of one
//     group of 4 channels: distinct banks for the inputs (a 1x5 line's stride
//     is 4 mod 8 floats), broadcasts for the weights.
//   - Within a block, KS groups of threads split each chunk's input channels
//     and add their partial sums through shared memory at the end: more
//     warps on an SM where the grid is short (the q GEMM has half the z r
//     one's outputs), at no cost in shared loads a FMA.
//   - The block's sums go through a tile in shared memory, so the epilogue
//     (bias, activation, the reads of h and z, the stores) walks the outputs
//     in the image's order: whole rows, not one float in each of 32 rows.
//   - The tile (BL, BP, BN, KS, KC, WPG) is chosen from the shape and the
//     card's SMs by ops/sepconvgru.choose_tile; at 60x80 each kernel's grid
//     is 120 blocks, one an SM.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kTaps = 5;
constexpr int kHalo = 2;          // (kTaps - 1) / 2 positions on each side
constexpr int kTN = 4;            // output channels a thread
constexpr int kMaxThreads = 512;  // ops/sepconvgru.MAX_THREADS: 128 registers a thread
constexpr size_t kSmemLimit = 232448 - 1024;  // opt-in limit, 1 KiB kept

struct Params {
  const float* a;     // (B, c_a, H, W): h (z r) or r h (q)
  const float* x;     // (B, c_x, H, W)
  const float* w;     // (c_a + c_x, 5, n), packed
  const float* bias;  // (n,)
  const float* h;     // (B, c_a, H, W): r h's h (z r), the update's h (q)
  const float* z;     // (B, c_a, H, W): q only
  float* out0;        // z r: z; q: h'
  float* out1;        // z r: r h
  int H, W, hw, c_a, c_x, n;
  int lines, len;     // lines across the axis, positions along it
  int bl, bp, bn, ks, kc, wpg;
  int chan_tiles, line_tiles;
  int quad_shift;     // log2(bn / 4)
  int stride;         // slab: floats a line (1x5) or a row (5x1)
  int chan_floats;    // slab: floats a channel
  int vec;            // floats a staged unit: 4 (16-byte copies) or 1
  int units;          // staged units a channel
  float inv_units;
  int stage_floats;   // a buffer: kc channels' slab, then kc 5 bn weights
  int out_offset;     // the output tile's first float
  int out_cs;         // the output tile's channel stride, odd
};

// 1x5: floats of a staged line, positions p0 - 4 ... p0 + bp + 3 (the halo's
// 2 and 2 more, so that the staged float4s are the image's), padded to 4 mod
// 8 so that 8 lines' float4 reads fall in distinct banks
int line_stride(int bp) {
  const int ls = bp + 4 * kHalo;
  return ls % 8 == 0 ? ls + 4 : ls;
}

// 5x1: floats of a staged row, the block's bl columns padded to a multiple of 4
int row_stride(int bl) { return (bl + 3) / 4 * 4; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Lines a thread: 1 for 1x5, 4 neighbouring columns (a float4) for 5x1
template <int AXIS>
__host__ __device__ constexpr int lines_a_thread() { return AXIS == 0 ? 1 : 4; }

// The positions a thread each kernel is built for: 20 of one row (1x5),
// 4 rows of a column quad (5x1); ops/sepconvgru.PLACES
template <int AXIS>
__host__ __device__ constexpr int places() { return AXIS == 0 ? 20 : 4; }

// The block's GEMM.  Every output is summed over all input channels and
// taps and handed to finish(b, channel, offset in the (H, W) plane, sum), in
// the order of the outputs in memory, from a tile of sums in shared memory.
// A thread sums 4 output channels of P consecutive positions of one line
// (1x5) or of 4 neighbouring columns (5x1): O = P or 4 P outputs a channel,
// output o at position o (1x5) or at row o / 4 and column o % 4 (5x1).  With
// K groups, group g adds outputs g O / ks ... (g + 1) O / ks - 1 of all the
// groups' sums, in group order, into the tile.
template <int AXIS, class Finish>
__device__ __forceinline__ void conv_tile(const Params& p, float* smem, Finish finish) {
  constexpr int P = places<AXIS>(), kLines = lines_a_thread<AXIS>(), kOut = P * kLines;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int line_groups = p.bl / kLines;
  const int pgs = line_groups * (p.bp / P), cgs = p.bn / kTN;
  const int group = pgs * cgs;  // threads of a K group
  const int ks = tid / group, t = tid - ks * group;
  // wpg neighbouring threads take neighbouring lines (or column quads) of
  // one channel group, the next wpg the next channel group
  const int pg_low = t % p.wpg, cg = t / p.wpg % cgs, pg = t / p.wpg / cgs * p.wpg + pg_low;
  const int li = pg % line_groups * kLines, pi = pg / line_groups;

  int rest = blockIdx.x;
  const int ct = rest % p.chan_tiles;
  rest /= p.chan_tiles;
  const int lt = rest % p.line_tiles, pt = rest / p.line_tiles;
  const int b = blockIdx.y;
  const int n0 = ct * p.bn, l0 = lt * p.bl, p0 = pt * p.bp;

  // A channel's staged units (vec floats each): (global offset or -1 where
  // outside the image, shared offset).  1x5: line l's floats p0 - 4 ... p0 +
  // bp + 3 of row l0 + l at l stride + s; 5x1: row r's (image row p0 - 2 +
  // r) columns l0 ... l0 + bl - 1 at r stride + column.  Either way
  // neighbouring units are neighbouring floats of the image.
  int2* table = reinterpret_cast<int2*>(smem + 2 * p.stage_floats);
  for (int u = tid; u < p.units; u += nthreads) {
    int off, at;
    bool inside;
    if (AXIS == 0) {
      const int per_line = (p.bp + 4 * kHalo) / p.vec;
      const int l = u / per_line, s = (u - l * per_line) * p.vec;
      const int line = l0 + l, x = p0 - 2 * kHalo + s;
      inside = line < p.lines && x >= 0 && x < p.W;
      off = line * p.W + x;
      at = l * p.stride + s;
    } else {
      const int per_row = p.bl / p.vec;
      const int r = u / per_row, col = (u - r * per_row) * p.vec;
      const int y = p0 - kHalo + r, x = l0 + col;
      inside = y >= 0 && y < p.H && x < p.W;
      off = y * p.W + x;
      at = r * p.stride + col;
    }
    table[u] = make_int2(inside ? off : -1, at);
  }
  __syncthreads();

  const float* img_a = p.a + static_cast<size_t>(b) * p.c_a * p.hw;
  const float* img_x = p.x + static_cast<size_t>(b) * p.c_x * p.hw;
  // chunk k (input channels k kc ... k kc + kc - 1, all of a or all of x)
  // into buf: the slab, then the weights' rows (c, tap), columns n0 ... n0 +
  // bn - 1
  auto prefetch = [&](int k, float* buf) {
    const int c0 = k * p.kc;
    const float* src = c0 < p.c_a ? img_a + static_cast<size_t>(c0) * p.hw
                                  : img_x + static_cast<size_t>(c0 - p.c_a) * p.hw;
    const int cells = p.kc * p.units;
    for (int e = tid; e < cells; e += nthreads) {
      const int c = __float2int_rz((static_cast<float>(e) + 0.5f) * p.inv_units);
      const int2 cell = table[e - c * p.units];
      const bool inside = cell.x >= 0;
      float* dst = buf + c * p.chan_floats + cell.y;
      const float* from = inside ? src + static_cast<size_t>(c) * p.hw + cell.x : src;
      if (p.vec == 4) {
        cp_async16(dst, from, inside ? 16 : 0);
      } else {
        cp_async4(dst, from, inside ? 4 : 0);
      }
    }
    float* wbuf = buf + p.kc * p.chan_floats;
    const float* wsrc = p.w + static_cast<size_t>(c0) * kTaps * p.n + n0;
    const int quads = p.bn / 4, wcells = p.kc * kTaps * quads;
    for (int e = tid; e < wcells; e += nthreads) {
      const int r = e >> p.quad_shift, q = e & (quads - 1);
      cp_async16(wbuf + r * p.bn + 4 * q, wsrc + static_cast<size_t>(r) * p.n + 4 * q, 16);
    }
  };

  float acc[kOut][kTN];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[o][j] = 0.f;
  }
  // the thread's first staged input: 1x5 its line's float p0 + pi P - 2
  // (staged position pi P + 2), 5x1 its columns' row p0 + pi P - 2
  const int first = AXIS == 0 ? li * p.stride + pi * P + kHalo : pi * P * p.stride + li;
  const int chunks = (p.c_a + p.c_x) / p.kc;
  prefetch(0, smem);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const float* cur = smem + (k & 1) * p.stage_floats;
    if (k + 1 < chunks) prefetch(k + 1, smem + ((k + 1) & 1) * p.stage_floats);
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    const float* wts = cur + p.kc * p.chan_floats + cg * kTN;
#pragma unroll 1
    for (int c = ks; c < p.kc; c += p.ks) {
      const float* in = cur + c * p.chan_floats + first;
      const float* wc = wts + c * kTaps * p.bn;
      if (AXIS == 0) {
        // v[e]: the input at position pos - 2 + e of the thread's first
        // output: a float2, P / 4 float4s, a float2
        float v[P + 2 * kHalo];
        const float2 lo = *reinterpret_cast<const float2*>(in);
        const float2 hi = *reinterpret_cast<const float2*>(in + kHalo + P);
        v[0] = lo.x;
        v[1] = lo.y;
        v[P + 2] = hi.x;
        v[P + 3] = hi.y;
#pragma unroll
        for (int i = 0; i < P / 4; ++i) {
          const float4 f = *reinterpret_cast<const float4*>(in + kHalo + 4 * i);
          v[kHalo + 4 * i] = f.x;
          v[kHalo + 4 * i + 1] = f.y;
          v[kHalo + 4 * i + 2] = f.z;
          v[kHalo + 4 * i + 3] = f.w;
        }
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap) {
          const float4 wv = *reinterpret_cast<const float4*>(wc + tap * p.bn);
#pragma unroll
          for (int i = 0; i < P; ++i) {
            acc[i][0] = fmaf(v[i + tap], wv.x, acc[i][0]);
            acc[i][1] = fmaf(v[i + tap], wv.y, acc[i][1]);
            acc[i][2] = fmaf(v[i + tap], wv.z, acc[i][2]);
            acc[i][3] = fmaf(v[i + tap], wv.w, acc[i][3]);
          }
        }
      } else {
        // row e of the thread's columns (image row pos - 2 + e) feeds output
        // row e - tap through tap, taps in order for each output
        float4 wv[kTaps];
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap) {
          wv[tap] = *reinterpret_cast<const float4*>(wc + tap * p.bn);
        }
#pragma unroll
        for (int e = 0; e < P + 2 * kHalo; ++e) {
          const float4 v = *reinterpret_cast<const float4*>(in + e * p.stride);
          const float col[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int tap = 0; tap < kTaps; ++tap) {
            const int i = e - tap;
            if (i >= 0 && i < P) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                float* o = acc[4 * i + q];
                o[0] = fmaf(col[q], wv[tap].x, o[0]);
                o[1] = fmaf(col[q], wv[tap].y, o[1]);
                o[2] = fmaf(col[q], wv[tap].z, o[2]);
                o[3] = fmaf(col[q], wv[tap].w, o[3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled
  }
  cp_async_wait_all();

  // the block's sums into the output tile (bn channels of rows x cols in
  // the image's order: 1x5 bl lines of bp positions, 5x1 bp rows of bl
  // columns), then finished output by output in that order
  const int rows = AXIS == 0 ? p.bl : p.bp, cols = AXIS == 0 ? p.bp : p.bl;
  float* tile = smem + p.out_offset;
  const auto put = [&](int o, int j, float sum) {
    const int at = AXIS == 0 ? li * cols + pi * P + o : (pi * P + o / 4) * cols + li + o % 4;
    tile[(cg * kTN + j) * p.out_cs + at] = sum;
  };
  if (p.ks == 1) {
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) put(o, j, acc[o][j]);
    }
  } else {  // every group's sums into (ks, O kTN, group); each group adds up its share
    float* red = smem + t;
    const int stride = kOut * kTN * group;
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) red[ks * stride + (o * kTN + j) * group] = acc[o][j];
    }
    __syncthreads();
    const int share = kOut / p.ks;
    for (int o = ks * share; o < (ks + 1) * share; ++o) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float* r = red + (o * kTN + j) * group;
        float sum = r[0];
        for (int g = 1; g < p.ks; ++g) sum += r[g * stride];
        put(o, j, sum);
      }
    }
  }
  __syncthreads();
  const int plane = rows * cols;
  for (int e = tid; e < p.bn * plane; e += nthreads) {
    const int ch = e / plane, rc = e - ch * plane, r = rc / cols, col = rc - r * cols;
    const int line = l0 + (AXIS == 0 ? r : col), pos = p0 + (AXIS == 0 ? col : r);
    if (line < p.lines && pos < p.len) {
      finish(b, n0 + ch, AXIS == 0 ? line * p.W + pos : pos * p.W + line,
             tile[ch * p.out_cs + rc]);
    }
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <int AXIS>
__global__ void __launch_bounds__(kMaxThreads)
sepconvgru_zr_conv_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  conv_tile<AXIS>(p, smem, [&](int b, int ch, int off, float v) {
    const float s = sigmoid(v + __ldg(p.bias + ch));
    if (ch < p.c_a) {
      p.out0[(static_cast<size_t>(b) * p.c_a + ch) * p.hw + off] = s;
    } else {
      const size_t idx = (static_cast<size_t>(b) * p.c_a + ch - p.c_a) * p.hw + off;
      p.out1[idx] = __fmul_rn(s, __ldg(p.h + idx));
    }
  });
}

template <int AXIS>
__global__ void __launch_bounds__(kMaxThreads)
sepconvgru_q_conv_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  conv_tile<AXIS>(p, smem, [&](int b, int ch, int off, float v) {
    const size_t idx = (static_cast<size_t>(b) * p.c_a + ch) * p.hw + off;
    const float q = tanhf(v + __ldg(p.bias + ch));
    const float z = __ldg(p.z + idx), h = __ldg(p.h + idx);
    // (1 - z) * h + z * q, as the reference computes it
    p.out0[idx] = __fadd_rn(__fmul_rn(__fsub_rn(1.f, z), h), __fmul_rn(z, q));
  });
}

// Launch one kernel, its shared-memory attribute set once per device to the
// most a block may opt in to
template <bool ZR, int AXIS>
cudaError_t launch(const Params& p, dim3 grid, int threads, size_t smem, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};  // bit d: set on device d
  void (*kernel)(const Params) =
      ZR ? sepconvgru_zr_conv_kernel<AXIS> : sepconvgru_q_conv_kernel<AXIS>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!bit || !(done.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return err;
    done.fetch_or(bit);
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// One of a half-step's two kernels over B images of H x W.  zr 1: the z r
// GEMM over [a = h, x] into out0 = z and out1 = r h; zr 0: the q GEMM over
// [a = r h, x] with the update into out0 = h' (h and z read; out1 unused).
// axis 0: the (1, 5) kernel along W; 1: the (5, 1) kernel along H.  The tile
// (bl lines, bp positions and bn channels a block; ks K groups; kc channels
// a chunk; wpg lines a warp) is what ops/sepconvgru.choose_tile picks.  a, x
// and w are read by 16-byte copies and must be 16-byte aligned.  Returns
// cudaErrorInvalidValue for a tile, shape or address the kernels do not take.
extern "C" int evfly_sepconvgru_conv(int zr, int axis, const void* a, const void* x,
                                     const void* w, const void* bias, const void* h,
                                     const void* z, void* out0, void* out1, int B, int H, int W,
                                     int c_a, int c_x, int bl, int bp, int bn, int ks, int kc,
                                     int wpg, void* stream) {
  const int n = zr ? 2 * c_a : c_a;
  const int lines = axis == 0 ? H : W, len = axis == 0 ? W : H;
  const bool shape_ok = B >= 1 && B <= 65535 && H >= 1 && W >= 1 && c_a >= kTN &&
                        c_a % kTN == 0 && c_x >= 0 && (axis == 0 || axis == 1) &&
                        a && x && w && bias && h && out0 && (zr ? out1 != nullptr : z != nullptr);
  const bool aligned = (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  const int per_thread = axis == 0 ? lines_a_thread<0>() : lines_a_thread<1>();
  const int P = axis == 0 ? places<0>() : places<1>();
  if (!shape_ok || !aligned || bl < 1 || bl % per_thread || bp < P || bp % P ||
      bn < kTN || bn % kTN || !pow2(bn / kTN) || n % bn || ks < 1 || kc < ks || kc % ks ||
      c_a % kc || c_x % kc || !pow2(wpg) || wpg > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pgs = bl / per_thread * (bp / P), cgs = bn / kTN;
  const long long threads = static_cast<long long>(ks) * pgs * cgs;
  if (pgs % wpg || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.a = static_cast<const float*>(a);
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.h = static_cast<const float*>(h);
  p.z = static_cast<const float*>(z);
  p.out0 = static_cast<float*>(out0);
  p.out1 = static_cast<float*>(out1);
  p.H = H;
  p.W = W;
  p.hw = H * W;
  p.c_a = c_a;
  p.c_x = c_x;
  p.n = n;
  p.lines = lines;
  p.len = len;
  p.bl = bl;
  p.bp = bp;
  p.bn = bn;
  p.ks = ks;
  p.kc = kc;
  p.wpg = wpg;
  p.chan_tiles = n / bn;
  p.line_tiles = (lines + bl - 1) / bl;
  p.quad_shift = __builtin_ctz(static_cast<unsigned>(bn / kTN));
  if (axis == 0) {  // 16-byte copies where the image's rows are 16-byte aligned
    p.stride = line_stride(bp);
    p.chan_floats = bl * p.stride;
    p.vec = W % 4 == 0 ? 4 : 1;
    p.units = bl * (bp + 4 * kHalo) / p.vec;
  } else {
    p.stride = row_stride(bl);
    p.chan_floats = (bp + 2 * kHalo) * p.stride;
    p.vec = W % 4 == 0 && bl % 4 == 0 ? 4 : 1;
    p.units = (bp + 2 * kHalo) * bl / p.vec;
  }
  p.inv_units = 1.0f / static_cast<float>(p.units);
  p.stage_floats = kc * p.chan_floats + kc * kTaps * bn;
  p.out_offset = ks > 1 ? static_cast<int>(threads) * P * per_thread * kTN : 0;
  p.out_cs = bl * bp + 1;
  const long long pos_tiles = (len + bp - 1) / bp;
  const long long tiles = static_cast<long long>(p.chan_tiles) * p.line_tiles * pos_tiles;
  // two buffers and the unit table; after the sums the K groups' partial
  // sums and the output tile reuse them
  const size_t main_floats = 2 * static_cast<size_t>(p.stage_floats) + 2 * p.units;
  const size_t tail_floats = static_cast<size_t>(p.out_offset) + static_cast<size_t>(bn) * p.out_cs;
  const size_t smem = sizeof(float) * (main_floats > tail_floats ? main_floats : tail_floats);
  if (smem > kSmemLimit || tiles > 0x7fffffffLL ||
      static_cast<long long>(kc) * p.units >= (1 << 22)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(B));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = static_cast<int>(threads);
  cudaError_t err;
  if (zr) {
    err = axis == 0 ? launch<true, 0>(p, grid, nt, smem, s) : launch<true, 1>(p, grid, nt, smem, s);
  } else {
    err = axis == 0 ? launch<false, 0>(p, grid, nt, smem, s)
                    : launch<false, 1>(p, grid, nt, smem, s);
  }
  return static_cast<int>(err);
}
