// MixFFN's grouped 3x3 convolution, its bias and exact GELU in one pass over
// V(phi)'s tokens.
//
// Replaces no Pallas kernel: the JAX package leaves this convolution to XLA
// (evfly_tpu/models/vit.py, MixFFN.apply: ops.conv2d with groups = channels,
// then ops.gelu_exact).  It was added because cuDNN has no fast f32 engine
// for 8 channels a group: at the serving batch of 256 windows its searched
// plan (convolve_common_engine_float_NHWC) took 3.88 of the encoder's 4.53 ms
// of convolutions, about 4% of the roofline, and the GELU after it was a
// separate elementwise pass over the same bytes (PERF.md).
//
// The function: tokens x (B, H*W, C), channels innermost as MixFFN's mlp1
// leaves them, C = 8 * groups; weight (C, 8, 3, 3) in the OIHW layout of the
// state_dict; bias (C,) or none.  Output channel c of group g = c / 8:
//   y[b, p, c] = gelu(bias[c] + sum_{i < 8, ky, kx < 3}
//                     w[c, i, ky, kx] * x[b, p + (ky - 1, kx - 1), 8 g + i])
// with zeros outside the image ("same" padding), gelu(v) =
// 0.5 v (1 + erf(v / sqrt(2))) as torch's exact GELU.  Sums in f32 FMA.
//
// What bounds it on the H100: bytes and operations about equally.  Each
// output takes 72 multiply-adds (144 flops) and moves 8 bytes (its input
// read once, itself written once): 18 flops a byte against the card's f32
// ridge of 67e12 / 3.35e12 = 20.  At the serving batch (block 1: B = 256,
// 15 x 23, C = 256; block 2: 8 x 12, C = 512; two calls each) the four
// calls do 10.1 GFLOP, 0.15 ms at 67 TFLOP/s, and move 563 MB, 0.17 ms at
// 3.35 TB/s.
//
// What the design does about it:
//   - A tile is one image, a band of rows and a chunk of groups
//     (ops/dwconv.choose_tile: up to 4 groups, a pixel's 128 contiguous
//     bytes, and about three warps of work).  Its input, with the one-pixel
//     halo, is staged into shared memory as (cell, channel) by 16-byte async
//     copies (cp.async, zero-filled outside the image): neighbouring threads
//     take neighbouring channels of a pixel, and every input byte is read
//     from device memory once, plus the halo rows of a band.  A cell's
//     channels are padded by 4 floats, so the 16-byte reads of 8
//     neighbouring cells fall in distinct banks.
//   - The grid holds as many blocks as are resident at once, a multiple of
//     the chunks, so a block keeps one chunk; it reads its 576 weights a
//     group once from the OIHW tensor as it is (16-byte loads, reordered to
//     (ky, kx, i, o) in shared memory by the block itself: no repacking
//     kernel, no extra node in a CUDA graph) and walks its tiles with two
//     input buffers: the next tile's copies are in flight while it sums the
//     current one.  On the H100 this took the four serving calls from 0.61
//     ms (one tile a block, staged through registers into channel planes,
//     then summed) to 0.56 ms (PERF.md).
//   - A thread computes one column of kRows output rows for the 8 output
//     channels of its group: 32 sums in registers.  For each tap and each
//     half of the input channels it reads kRows 16-byte cells and 8 float4s
//     of weights (the same address across the threads of a group) and does
//     32 kRows FMAs with them.  The sums run over (ky, kx, i) with the bias
//     added last: the order of PyTorch's CPU convolution, whose results they
//     match bit for bit, so the card and the CPU part only at GELU.
//   - The epilogue adds the bias, applies GELU with erff and stores the 8
//     consecutive channels of each output as two 16-byte stores.
//   - The tile adapts to the shape; where a batch has fewer than two tiles
//     an SM (the streaming batches of 1 and 16) bands get shorter and chunks
//     narrower.  One kernel for every shape.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

namespace {

constexpr int kGroupChannels = 8;                                     // in and out, a group
constexpr int kGroupWeights = kGroupChannels * kGroupChannels * 9;    // 576
constexpr int kRows = 4;          // output rows a thread computes (ops/dwconv.ROWS)
constexpr int kMaxThreads = 256;  // ops/dwconv.MAX_THREADS
constexpr int kStage = 8;         // 16-byte weight loads in flight a thread
constexpr size_t kSmemLimit = 232448 - 1024;  // opt-in limit, 1 KiB kept

// Cells of a tile's zero-padded input for bands of `band_rows` rows: (row
// blocks * kRows + 2) rows of W + 2 columns
__host__ __device__ inline int tile_cells(int band_rows, int W) {
  return ((band_rows + kRows - 1) / kRows * kRows + 2) * (W + 2);
}

// Floats a cell takes in shared memory: the chunk's channels and 4 more, so
// that 8 neighbouring cells' 16-byte reads fall in distinct banks
__host__ __device__ inline int cell_floats(int tile_groups) {
  return tile_groups * kGroupChannels + 4;
}

// the chunk's weights and two buffers of a tile's input
size_t smem_bytes(int tile_groups, int band_rows, int W) {
  return sizeof(float) * (static_cast<size_t>(tile_groups) * kGroupWeights +
                          2 * static_cast<size_t>(tile_cells(band_rows, W)) *
                              cell_floats(tile_groups));
}

__device__ __forceinline__ float gelu_exact(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
}

// 16 bytes global -> shared without a register; src_bytes 0 writes zeros
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

// A tile: one image, one band of rows, the block's chunk of groups
struct Tile {
  int b, y0, rows;
};

__device__ __forceinline__ Tile tile_of(int t, int chunks, int bands, int band_rows, int H) {
  const int rest = t / chunks, band = rest % bands;
  const int y0 = band * band_rows;
  return {rest / bands, y0, min(band_rows, H - y0)};
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kMaxThreads, 2)
mixffn_dwconv3x3_gelu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                             const float* __restrict__ bias, float* __restrict__ y, int H,
                             int W, int C, int tile_groups, int band_rows, int bands,
                             int chunks, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int groups = C / kGroupChannels;
  // the grid is a multiple of `chunks`, so a block's tiles t = blockIdx.x +
  // k gridDim.x (chunks fastest) all hold its chunk of groups
  const int g0 = static_cast<int>(blockIdx.x) % chunks * tile_groups;
  const int ng = min(tile_groups, groups - g0);
  const int RS = W + 2;  // cells of a padded row
  const int S = cell_floats(tile_groups);
  const int cells = tile_cells(band_rows, W);

  float* s_w = smem;                                // [group][ky][kx][i][o]
  float* s_in = smem + tile_groups * kGroupWeights;  // two [cell][channel] buffers

  // The input of tile t with its halo into buf by 16-byte async copies, cell
  // (ry, rx) = image pixel (y0 - 1 + ry, rx - 1); zeros outside the image and
  // below the band's halo row.  Thread slot: float4 q = tid % Q of a cell
  // (neighbouring threads, neighbouring channels), cells tid / Q + k
  // threads / Q (threads % Q == 0).
  const int Q = tile_groups * 2, q = threadIdx.x % Q, step = blockDim.x / Q;
  const float* xq = x + g0 * kGroupChannels + 4 * q;
  auto prefetch = [&](int t, float* buf) {
    if (q >= ng * 2) return;
    const Tile tl = tile_of(t, chunks, bands, band_rows, H);
    const float* xb = xq + static_cast<size_t>(tl.b) * H * W * C;
    int cell = threadIdx.x / Q, ry = cell / RS, rx = cell - ry * RS;
    for (; cell < cells; cell += step) {
      const int yy = tl.y0 - 1 + ry, xx = rx - 1;
      const bool inside = ry <= tl.rows + 1 && yy >= 0 && yy < H && xx >= 0 && xx < W;
      cp_async16(buf + cell * S + 4 * q,
                 inside ? xb + (static_cast<size_t>(yy) * W + xx) * C : xq, inside ? 16 : 0);
      for (rx += step; rx >= RS; rx -= RS) ++ry;
    }
  };
  if (static_cast<int>(blockIdx.x) < n_tiles) prefetch(blockIdx.x, s_in);
  cp_async_commit();

  // the chunk's weights, once a block: output channels 8 g0 ... 8 (g0 + ng)
  // - 1, each 72 contiguous floats (i, ky, kx) in the OIHW tensor, read as
  // float4s, kStage of them in flight a thread, reordered to (ky, kx, i, o)
  const float4* wg =
      reinterpret_cast<const float4*>(w + static_cast<size_t>(g0) * kGroupWeights);
  const int n_w = ng * kGroupWeights / 4;
  for (int k0 = threadIdx.x; k0 < n_w; k0 += kStage * blockDim.x) {
    float4 v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < n_w) v[u] = __ldg(wg + k);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < n_w) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int f = 4 * k + j, oc = f / 72, rem = f - oc * 72;
          const int i = rem / 9, tap = rem - i * 9;
          s_w[(oc >> 3) * kGroupWeights + (tap * 8 + i) * 8 + (oc & 7)] = lane(v[u], j);
        }
      }
    }
  }

  int k = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++k) {
    const float* cur = s_in + (k & 1) * cells * S;
    // the next tile's copies go out before this tile's sums
    if (t + static_cast<int>(gridDim.x) < n_tiles) {
      prefetch(t + gridDim.x, s_in + ((k + 1) & 1) * cells * S);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();

    const Tile tl = tile_of(t, chunks, bands, band_rows, H);
    // thread item -> (group of the chunk, row block, column)
    const int per_group = (tl.rows + kRows - 1) / kRows * W;
    for (int it = threadIdx.x; it < ng * per_group; it += blockDim.x) {
      const int gi = it / per_group, rem = it - gi * per_group;
      const int rb = rem / W, col = rem - rb * W;
      const int c0 = (g0 + gi) * kGroupChannels;
      float acc[kRows][8] = {};
      // cell (rb kRows, col): the top-left tap of the thread's first output
      const float* base = cur + (rb * kRows * RS + col) * S + gi * kGroupChannels;
      const float* sw = s_w + gi * kGroupWeights;
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // input channels 4h ... 4h + 3
            float4 xv[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              xv[r] = *reinterpret_cast<const float4*>(base + ((r + ky) * RS + kx) * S + 4 * h);
            }
            const float4* w4 =
                reinterpret_cast<const float4*>(sw + ((ky * 3 + kx) * 8 + 4 * h) * 8);
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              const float4 wa = w4[2 * ii], wb = w4[2 * ii + 1];
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                const float a = lane(xv[r], ii);
                acc[r][0] = fmaf(a, wa.x, acc[r][0]);
                acc[r][1] = fmaf(a, wa.y, acc[r][1]);
                acc[r][2] = fmaf(a, wa.z, acc[r][2]);
                acc[r][3] = fmaf(a, wa.w, acc[r][3]);
                acc[r][4] = fmaf(a, wb.x, acc[r][4]);
                acc[r][5] = fmaf(a, wb.y, acc[r][5]);
                acc[r][6] = fmaf(a, wb.z, acc[r][6]);
                acc[r][7] = fmaf(a, wb.w, acc[r][7]);
              }
            }
          }
        }
      }
      // the bias after the sums, as cuDNN and the CPU's convolution add it
      float bo[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) bo[o] = bias ? __ldg(bias + c0 + o) : 0.f;
      float* yb = y + static_cast<size_t>(tl.b) * H * W * C + c0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int rr = rb * kRows + r;
        if (rr < tl.rows) {
          float4* dst =
              reinterpret_cast<float4*>(yb + (static_cast<size_t>(tl.y0 + rr) * W + col) * C);
          dst[0] = make_float4(gelu_exact(acc[r][0] + bo[0]), gelu_exact(acc[r][1] + bo[1]),
                               gelu_exact(acc[r][2] + bo[2]), gelu_exact(acc[r][3] + bo[3]));
          dst[1] = make_float4(gelu_exact(acc[r][4] + bo[4]), gelu_exact(acc[r][5] + bo[5]),
                               gelu_exact(acc[r][6] + bo[6]), gelu_exact(acc[r][7] + bo[7]));
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled
  }
}

// The kernel's shared-memory attributes, set once per device to the most a
// block may opt in to (a streaming step launches it at every capture), and
// the device's SMs
cudaError_t prepare(int* sms) {
  static std::atomic<uint64_t> done{0};  // bit d: set on device d
  static std::atomic<int> sm_count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done.load() & bit)) {
    *sms = sm_count[dev].load();
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(mixffn_dwconv3x3_gelu_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mixffn_dwconv3x3_gelu_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (bit) {
    sm_count[dev].store(*sms);
    done.fetch_or(bit);
  }
  return cudaSuccess;
}

}  // namespace

// y = gelu(grouped 3x3 conv(x) + bias) over (B, H*W, C) tokens, 8 channels a
// group, on the tile (tile_groups groups, bands of band_rows rows, threads a
// block, a multiple of 2 tile_groups) that ops/dwconv.choose_tile picks; bias
// may be null.  The grid holds as many blocks as are resident at once, a
// multiple of the chunks of groups, each walking its tiles.  Returns
// cudaErrorInvalidValue for a tile or shape the kernel does not take.
extern "C" int evfly_dwconv3x3_gelu(const void* x, const void* w, const void* bias, void* y,
                                    int B, int H, int W, int C, int tile_groups, int band_rows,
                                    int threads, void* stream) {
  const size_t smem = smem_bytes(tile_groups, band_rows, W);
  if (B < 0 || H < 0 || W < 0 || C <= 0 || C % kGroupChannels || tile_groups < 1 ||
      band_rows < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      threads % (tile_groups * 2) || smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  cudaError_t err = prepare(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bands = H > 0 ? (H + band_rows - 1) / band_rows : 0;
  const int chunks = (C / kGroupChannels + tile_groups - 1) / tile_groups;
  const long long n_tiles = static_cast<long long>(B) * bands * chunks;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles > 0 && W > 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mixffn_dwconv3x3_gelu_kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long resident = static_cast<long long>(per_sm) * sms;
    const long long grid =
        std::min<long long>(n_tiles, chunks * std::max<long long>(1, resident / chunks));
    mixffn_dwconv3x3_gelu_kernel<<<static_cast<unsigned>(grid), threads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), H, W, C, tile_groups,
        band_rows, bands, chunks, static_cast<int>(n_tiles));
  }
  return static_cast<int>(cudaGetLastError());
}
