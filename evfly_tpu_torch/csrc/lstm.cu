// K4 and K5: stacked multi-layer LSTM inference, G independent streams.
//
// K4 replaces evfly_tpu/ops/lstm_pallas.py `_lstm_fused` (kernel body
// `_make_lstm_kernel`, the "stacked" mode); K5 replaces
// `_lstm_fused_wavefront` (kernel body `_make_lstm_kernel_wavefront`, the
// "wavefront" mode).  Same inputs and math as the TPU kernels: gates
// ordered (i, f, g, o) as torch packs them, f32 throughout, the layer-0
// input projection (x_proj0 = x W_ih0^T + b_ih0 + b_hh0) hoisted out by the
// caller.  Both take a leading stream axis: G independent sequences with
// their own state and shared weights, which is what `jax.vmap` over the
// pallas_call computes for the batched streaming pipeline.  One unbatched
// sequence is G = 1.
//
//   K4 walks time steps and, inside each, layers 0..L-1 in turn: T * L
//      dependent (layer, step) matrix-vector products of 4H columns.
//   K5 walks the anti-diagonals of the (layer, time) grid: on wavefront w
//      every layer l with 0 <= w - l < T advances on its own time index
//      w - l, reading the state that wavefront w - 1 left (layer l - 1 at
//      time w - l and layer l at time w - l - 1).  T + L - 1 dependent
//      steps of up to L * 4H columns; the top layer writes out[w - (L-1)].
//      The TPU kernel packs all layers into one (2LH, 4LH) block-diagonal
//      matrix for one MXU product per wavefront; here each column reads
//      only its own layer's two weight blocks, so the zero blocks are never
//      read or multiplied.
//
// What bounds them on the H100: neither bytes nor operations but the serial
// chain of dependent matrix-vector products.  Their bound by operations
// (2 T H 4H (2L - 1) flops per stream) is a few microseconds; the chain is
// T * L (K4) or T + L - 1 (K5) links long.  Each of the three routes below
// does something else about the cost of one link.  Which shape takes which
// route is one rule, `choose_route` below (ops/lstm_fused.choose_route
// states it again for the CPU): the cluster route where its 8 SMs hold the
// weights, else the grid route where up to 132 SMs hold them, else L2.
//
// The cluster route (lstm_cluster_kernel, every shape whose weights fit the
// shared memory of 8 SMs: H = 128 with L <= 3, H = 256 with L = 1): one
// cluster of 8 CTAs per stream.  The (2L - 1) weight blocks (W_hh of every
// layer, W_ih of layers 1..L-1; 1.25 MiB at H = 128, L = 3) are split over
// the 8 CTAs' shared memory and loaded once per launch by bulk async copies.
// CTA r owns hidden units [r H/8, (r+1) H/8) of every layer and with them
// their four gate columns, so its slice is 4 H/8 columns of each block
// (160 KiB at H = 128, L = 3), the cell update and c stay local, and only h
// crosses CTAs.  One link: every CTA computes its gate columns from the
// full h in its own shared memory, updates its units, pushes its slice of
// the new h into all 8 CTAs' shared memory (distributed shared memory) and
// arrives at one cluster barrier (release/acquire).  h is double-buffered
// per layer by time parity, so one barrier per link is enough: T * L
// barriers for K4, T + L - 1 for K5; that chain of barriers is the
// practical floor of this route.
//
// The grid route (lstm_grid_kernel, the shapes past a cluster whose
// weights fit up to 132 SMs: H = 768 with L = 1, the velocity head's LSTM;
// H = 256 with L = 2 or 3; H = 128 with L = 4 to 7): one grid of H/8 (at
// most 132) CTAs for all streams, the weights stationary across it.  CTA b
// owns hidden units [8b, 8b + 8) of every layer and their four gate columns
// in each of the 2L - 1 blocks (32 H floats a block, 96 KiB at H = 768),
// loaded once per launch by bulk async copies, so W_hh is read once by H/8
// SMs in parallel instead of once per link by one.  Warp u of the CTA owns
// unit 8b + u; lane q sums k = i*32 + q over i < H/32.  One link, per layer
// it advances and per chunk of up to 8 streams: stage the chunk's full h of
// the previous link (global -> shared), form the 4 x 8 gate sums of each
// unit, reduce them across the warp so that lane 4s + gate holds stream s's
// gate, gather the four gates by shuffles, update the cell, and write the
// new h slice into a global exchange buffer double-buffered by time parity;
// then one grid-wide barrier.  c lives in cn (each element read by its
// stream's four lanes of one warp and written by one of them), so nothing
// in shared memory but the staged chunk depends on G, and any number of
// streams runs in one launch.  Links and barriers:
// T * L links for K4 and T + L - 1 for K5, one barrier between two links
// (none at T = L = 1).  What bounds it on the H100: at T = 1 the launch
// and the first read of the weights (H = 768: 9.4 MB, 0.0028 ms at the HBM
// rate, over 96 SMs); each further link costs a grid barrier through L2
// and a round trip to stage h, about 3 us (PERF.md).  What was settled on
// the card:
//   1. Co-residency: the launch carries cudaLaunchAttributeCooperative, so
//      CUDA refuses a grid that cannot be resident at once (the
//      wrapper raises; nothing falls back to another route), and every
//      spin-wait (the weights' mbarrier, the grid barrier) gives up after
//      kSpinLimit polls with __trap(), which the next synchronisation
//      reports as a launch failure.  chip_smoke.py reads
//      cudaOccupancyMaxActiveBlocksPerMultiprocessor (evfly_lstm_grid_
//      occupancy) and traps a stalled barrier in a child process.
//   2. CUDA graphs: the cooperative launch is captured and replayed (the
//      streaming step's graph and tests/test_torch_lstm_grid.py); the
//      barrier counts arrivals up from 0 and the wrapper zeroes the counter
//      with a fill on the launch stream before each launch, which the graph
//      captures, so every replay starts at 0.
//   3. Many streams: h is staged in chunks of kGridStreams streams (16 KiB
//      a chunk and layer input at H = 768), never whole; G = 16 is two
//      chunks, G = 64 eight, and the weights stay resident.
//   4. Memory order of the exchange: each thread's h stores (st.cg) come
//      before a __syncthreads, after which thread 0 arrives with
//      red.release.gpu; the wait is ld.acquire.gpu, then __syncthreads, and
//      h and c are read back with ld.cg (L2, coherent), never __ldg.
//   5. The reduction order differs from the plain version's (each lane's
//      partial sums, then a 32-lane tree): within 2e-5, 3e-5 with a carried
//      state, as the other routes.
//
// The L2 route (lstm_stacked_kernel, lstm_wavefront_kernel; every other
// shape with H % 128 == 0, e.g. H = 768 with L = 2): one block per stream,
// threads over the gate columns, h and c in shared memory and two
// __syncthreads() per link.  The weights do not fit one SM; they are read
// from global memory on every link, where they stay in L2, column-major per
// thread so a warp's loads are coalesced, and in batches of kBatch loads
// into registers so that one SM keeps many in flight: a link is then bound
// by how fast one SM reads L2.
//
// Layouts (all f32, row-major):
//   xp0   (G, T, 4H)       layer-0 gates before the recurrent term
//   whh_t (H, L * 4H)      W_hh^T of each layer, side by side      (L2 route)
//   wih_t (H, (L-1) * 4H)  W_ih^T of layers 1..L-1 (unused when L == 1)
//   wcl   (8, 2L - 1, H*H/2)  the cluster layout: rank r's slices of the
//                          blocks W_hh0, W_ih1, W_hh1, W_ih2, ... (ops/
//                          lstm_fused.pack_cluster), one contiguous block
//                          per rank                             (cluster route)
//   wgr   (H/8, 2L - 1, 32H)  the grid layout: CTA b's slices of the same
//                          blocks (ops/lstm_fused.pack_grid)        (grid route)
//   bias  ((L-1) * 4H)     b_ih + b_hh of layers 1..L-1
//   h0, c0, hn, cn (G, L, H); out (G, T, H)
//   hx    (2, G, L, H)     the grid route's h exchange, by time parity
//   arrivals (1) uint32    the grid barrier's count, 0 at launch
//
// Each C entry point returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;
constexpr int kWaveThreads = 768;
constexpr int kBatch = 16;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// sum_k v[k] * w[k * ld] over k < H, the loads of each batch of kBatch
// weights issued together before their FMAs (H % kBatch == 0: the wrappers
// ask for H % 128 == 0)
__device__ __forceinline__ float column_dot(const float* v, const float* __restrict__ w,
                                            int ld, int H) {
  float r = 0.f;
  for (int k0 = 0; k0 < H; k0 += kBatch) {
    float a[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) a[u] = __ldg(w + (k0 + u) * ld);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) r += v[k0 + u] * a[u];
  }
  return r;
}

// two dot products over the same k, their loads in flight together
__device__ __forceinline__ void column_dot2(const float* v1, const float* __restrict__ w1,
                                            int ld1, const float* v2,
                                            const float* __restrict__ w2, int ld2, int H,
                                            float* r1, float* r2) {
  float s1 = 0.f, s2 = 0.f;
  for (int k0 = 0; k0 < H; k0 += kBatch) {
    float a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      a[u] = __ldg(w1 + (k0 + u) * ld1);
      b[u] = __ldg(w2 + (k0 + u) * ld2);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      s1 += v1[k0 + u] * a[u];
      s2 += v2[k0 + u] * b[u];
    }
  }
  *r1 = s1;
  *r2 = s2;
}

// gate column j (of 4H) of layer l at layer-0 time row xp (layer 0 only),
// from h (L, H) as it stands
__device__ __forceinline__ float gate_column(const float* h, const float* __restrict__ xp,
                                             const float* __restrict__ whh_t,
                                             const float* __restrict__ wih_t,
                                             const float* __restrict__ bias, int l, int j,
                                             int H, int L) {
  const int G = 4 * H;
  const float* wh = whh_t + l * G + j;
  if (l == 0) return xp[j] + column_dot(h, wh, L * G, H);
  float s, r;
  column_dot2(h + (l - 1) * H, wih_t + (l - 1) * G + j, (L - 1) * G, h + l * H, wh, L * G, H,
              &s, &r);
  return (s + bias[(l - 1) * G + j]) + r;
}

// the cell update of unit u of layer l from its four gates
__device__ __forceinline__ float cell_update(const float* gl, float* c, float* h, int u,
                                             int H) {
  const float ig = sigmoidf_(gl[u]);
  const float fg = sigmoidf_(gl[H + u]);
  const float gg = tanhf(gl[2 * H + u]);
  const float og = sigmoidf_(gl[3 * H + u]);
  const float cv = fg * c[u] + ig * gg;
  const float hv = og * tanhf(cv);
  c[u] = cv;
  h[u] = hv;
  return hv;
}

__global__ void __launch_bounds__(kThreads)
lstm_stacked_kernel(const float* __restrict__ xp0, const float* __restrict__ whh_t,
                    const float* __restrict__ wih_t, const float* __restrict__ bias,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    float* __restrict__ out, float* __restrict__ hn, float* __restrict__ cn,
                    int T, int H, int L) {
  extern __shared__ float sm[];
  const int G = 4 * H;
  float* h = sm;             // (L, H)
  float* c = h + L * H;      // (L, H)
  float* gates = c + L * H;  // (G)
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const size_t g = blockIdx.x;
  xp0 += g * T * G;
  out += g * T * H;
  h0 += g * L * H;
  c0 += g * L * H;
  hn += g * L * H;
  cn += g * L * H;

  for (int i = tid; i < L * H; i += nthreads) { h[i] = h0[i]; c[i] = c0[i]; }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int l = 0; l < L; ++l) {
      for (int j = tid; j < G; j += nthreads) {
        gates[j] = gate_column(h, xp0 + static_cast<size_t>(t) * G, whh_t, wih_t, bias, l, j,
                               H, L);
      }
      __syncthreads();
      for (int u = tid; u < H; u += nthreads) {
        const float hv = cell_update(gates, c + l * H, h + l * H, u, H);
        if (l == L - 1) out[static_cast<size_t>(t) * H + u] = hv;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < L * H; i += nthreads) { hn[i] = h[i]; cn[i] = c[i]; }
}

__global__ void __launch_bounds__(kWaveThreads)
lstm_wavefront_kernel(const float* __restrict__ xp0, const float* __restrict__ whh_t,
                      const float* __restrict__ wih_t, const float* __restrict__ bias,
                      const float* __restrict__ h0, const float* __restrict__ c0,
                      float* __restrict__ out, float* __restrict__ hn,
                      float* __restrict__ cn, int T, int H, int L) {
  extern __shared__ float sm[];
  const int G = 4 * H;
  float* h = sm;             // (L, H): layer l's state at its last live wavefront
  float* c = h + L * H;      // (L, H)
  float* gates = c + L * H;  // (L, 4H)
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const size_t g = blockIdx.x;
  xp0 += g * T * G;
  out += g * T * H;
  h0 += g * L * H;
  c0 += g * L * H;
  hn += g * L * H;
  cn += g * L * H;

  for (int i = tid; i < L * H; i += nthreads) { h[i] = h0[i]; c[i] = c0[i]; }
  __syncthreads();

  for (int w = 0; w < T + L - 1; ++w) {
    // live layers: 0 <= w - l < T (ramp-up for w < L - 1, drain for w >= T)
    const int l_lo = max(0, w - T + 1), l_hi = min(L - 1, w);
    const float* xp = xp0 + static_cast<size_t>(max(0, min(w, T - 1))) * G;
    for (int j = l_lo * G + tid; j < (l_hi + 1) * G; j += nthreads) {
      const int l = j / G;
      gates[j] = gate_column(h, xp, whh_t, wih_t, bias, l, j - l * G, H, L);
    }
    __syncthreads();
    for (int i = l_lo * H + tid; i < (l_hi + 1) * H; i += nthreads) {
      const int l = i / H, u = i - l * H;
      const float hv = cell_update(gates + l * G, c + l * H, h + l * H, u, H);
      if (l == L - 1) out[static_cast<size_t>(w - (L - 1)) * H + u] = hv;
    }
    __syncthreads();
  }
  for (int i = tid; i < L * H; i += nthreads) { hn[i] = h[i]; cn[i] = c[i]; }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const void* xp0, const void* whh_t,
           const void* wih_t, const void* bias, const void* h0, const void* c0, void* out,
           void* hn, void* cn, int G, int T, int H, int L, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 0) {
    kernel<<<G, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xp0), static_cast<const float*>(whh_t),
        static_cast<const float*>(wih_t), static_cast<const float*>(bias),
        static_cast<const float*>(h0), static_cast<const float*>(c0),
        static_cast<float*>(out), static_cast<float*>(hn), static_cast<float*>(cn), T, H, L);
  }
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------ cluster route

namespace cg = cooperative_groups;

constexpr int kCluster = 8;   // CTAs per stream
constexpr int kSplits = 16;   // threads per hidden unit, each over H/16 of k
// a block may opt in to 227 KB (232,448 bytes) of shared memory; keep 1 KiB
// for the static shared variables
constexpr size_t kSmemLimit = 232448 - 1024;

// The shapes of one CTA's share at hidden size kH.  Thread (u, q) of a
// layer group owns unit u of the CTA's kUnits and the k indices
// k = i * kSplits + q (i < kK): it forms the partial sums of the unit's four
// gate columns over those k, and the 16 threads of a unit (one half-warp)
// add them with __shfl_xor_sync.  Warp w holds units 2w and 2w + 1; its lane
// is q + 16 (u & 1).  Weight slice of one block, in float4s:
//   slice[((w * 4 + gate) * kK / 4 + i / 4) * 32 + lane].{x,y,z,w}[i % 4]
//     = W[gate * H + r * kUnits + u][k = i * kSplits + q]
// (W the block in torch's (4H, H) layout), so a warp's float4 loads are 512
// contiguous bytes and its h loads are 16 contiguous words read twice.
constexpr size_t cluster_smem_bytes(int H, int L) {
  // weight slices, h (2 parities, L, H), c (L, H/8), biases (L-1, 4, H/8)
  return static_cast<size_t>((2 * L - 1) * H * H / 2 + 2 * L * H + L * H / 8 +
                             (L - 1) * 4 * H / 8) * sizeof(float);
}

// The one rule of which shapes take the cluster route: a hidden size the
// kernel is built for, and one CTA's share within a block's shared memory.
// ops/lstm_fused.cluster_fits states the same rule for the CPU, where this
// library is not built; chip_smoke.py holds the two against each other.
constexpr bool cluster_fits(int H, int L) {
  return (H == 128 || H == 256) && L >= 1 && cluster_smem_bytes(H, L) <= kSmemLimit;
}

constexpr int cluster_max_layers(int H) {
  int L = 0;
  while (cluster_fits(H, L + 1)) ++L;
  return L;
}

template <int kH>
struct ClusterShape {
  static constexpr int kUnits = kH / kCluster;
  static constexpr int kThreads = kUnits * kSplits;  // per layer group: 2H
  static constexpr int kK = kH / kSplits;
  static constexpr int kSlice = kH * kH / 2;         // floats of one block's slice
  static constexpr int kMaxLayers = cluster_max_layers(kH);
  static_assert(kMaxLayers >= 1 && 2 * kH * kMaxLayers <= 1024,
                "K5 runs 2H threads per layer in one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// polls of a spin-wait before it gives up with __trap() (an L2 round trip
// each, about 2 s in all): a wait that long is a fault, never a slow link
constexpr long long kSpinLimit = 1LL << 22;

// Thread 0: the mbarrier at `bar` for one arrival, visible to the bulk
// copies; a __syncthreads() must follow before another thread waits on it
__device__ __forceinline__ void init_load_barrier(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Thread 0: n bulk async copies of `bytes` each (a multiple of 16), from
// consecutive blocks of src into consecutive blocks of dst in shared memory,
// completing on the mbarrier at `bar`
__device__ __forceinline__ void start_bulk_load(uint32_t bar, float* dst, const float* src,
                                                uint32_t bytes, int n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes * n)
               : "memory");
  const size_t floats = bytes / sizeof(float);
  for (int m = 0; m < n; ++m) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_u32(dst + m * floats)),
        "l"(reinterpret_cast<uint64_t>(src + m * floats)), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// Every thread: wait until the copies of start_bulk_load have landed
__device__ __forceinline__ void wait_bulk_load(uint32_t bar) {
  uint32_t loaded = 0;
  for (long long spins = 0; !loaded; ++spins) {
    if (spins > kSpinLimit) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(loaded)
        : "r"(bar)
        : "memory");
  }
}

// acc[gate] += sum over this thread's k of slice(gate, k) * h[k]
template <int kH>
__device__ __forceinline__ void slice_dot(const float* __restrict__ slice,
                                          const float* __restrict__ h, int warp, int lane,
                                          int q, float acc[4]) {
  using S = ClusterShape<kH>;
  constexpr int kI4 = S::kK / 4;
  float hk[S::kK];
#pragma unroll
  for (int i = 0; i < S::kK; ++i) hk[i] = h[i * kSplits + q];
  const float4* w4 = reinterpret_cast<const float4*>(slice) + warp * 4 * kI4 * 32 + lane;
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {
#pragma unroll
    for (int i4 = 0; i4 < kI4; ++i4) {
      const float4 v = w4[(gate * kI4 + i4) * 32];
      float a = acc[gate];
      a = fmaf(v.x, hk[4 * i4], a);
      a = fmaf(v.y, hk[4 * i4 + 1], a);
      a = fmaf(v.z, hk[4 * i4 + 2], a);
      a = fmaf(v.w, hk[4 * i4 + 3], a);
      acc[gate] = a;
    }
  }
}

// kWave false: K4, links (t, l) in order, one layer group of 2H threads.
// kWave true: K5, links are wavefronts, group l of 2H threads advances
// layer l.  grid = 8 G CTAs in clusters of 8; CTA rank r of cluster g runs
// stream g's units [r H/8, (r+1) H/8).
template <int kH, bool kWave>
__global__ void __launch_bounds__(kWave ? 2 * kH * ClusterShape<kH>::kMaxLayers : 2 * kH)
lstm_cluster_kernel(const float* __restrict__ xp0, const float* __restrict__ wcl,
                    const float* __restrict__ bias, const float* __restrict__ h0,
                    const float* __restrict__ c0, float* __restrict__ out,
                    float* __restrict__ hn, float* __restrict__ cn, int T, int L) {
  using S = ClusterShape<kH>;
  constexpr int kU = S::kUnits;
  constexpr int kG = 4 * kH;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t g = blockIdx.x / kCluster;
  const int nblocks = 2 * L - 1;

  extern __shared__ __align__(16) float sm[];
  float* w = sm;                              // (2L - 1) slices
  float* hbuf = w + nblocks * S::kSlice;      // (2, L, H): h of time t at parity t & 1
  float* cst = hbuf + 2 * L * kH;             // (L, kU)
  float* bsm = cst + L * kU;                  // (L - 1, 4, kU)
  __shared__ __align__(8) uint64_t wbar;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  xp0 += g * T * kG;
  out += g * T * kH;
  h0 += g * L * kH;
  c0 += g * L * kH;
  hn += g * L * kH;
  cn += g * L * kH;

  // 1. this rank's weight slices: bulk async copies into shared memory,
  //    completing on an mbarrier
  const uint32_t bar = smem_u32(&wbar);
  if (tid == 0) init_load_barrier(bar);
  __syncthreads();
  if (tid == 0) {
    start_bulk_load(bar, w, wcl + static_cast<size_t>(rank) * nblocks * S::kSlice,
                    S::kSlice * sizeof(float), nblocks);
  }

  // 2. the state: the full h0 in both parities, this rank's c0 and biases
  for (int i = tid; i < L * kH; i += nthreads) hbuf[i] = hbuf[L * kH + i] = h0[i];
  for (int i = tid; i < L * kU; i += nthreads) {
    const int l = i / kU;
    cst[i] = c0[l * kH + rank * kU + (i - l * kU)];
  }
  for (int i = tid; i < (L - 1) * 4 * kU; i += nthreads) {
    const int l = i / (4 * kU), gate = (i / kU) & 3, u = i % kU;
    bsm[i] = bias[l * kG + gate * kH + rank * kU + u];
  }

  // 3. roles
  const int group = tid / S::kThreads;  // K5: the layer this thread advances
  const int tg = tid - group * S::kThreads;
  const int warp = tg >> 5, lane = tg & 31, q = lane & 15;
  const int u = 2 * warp + (lane >> 4);
  const int col = rank * kU + u;        // the unit's index in h
  // lanes q < 8 push the unit's new h into rank q's shared memory
  float* peer_h = cluster.map_shared_rank(hbuf, q & (kCluster - 1));
  float xc[4], xn[4];                   // layer-0 gates of this time step and the next
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) xn[gate] = T > 0 ? xp0[gate * kH + col] : 0.f;

  // every CTA of the cluster runs and holds its state before h crosses CTAs
  cluster.sync();
  wait_bulk_load(bar);

  // layer l at time t: reads h_{l-1}(t) and h_l(t-1), writes h_l(t)
  auto advance = [&](int l, int t) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (l == 0) {
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) xc[gate] = xn[gate];
      if (t + 1 < T) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          xn[gate] = xp0[static_cast<size_t>(t + 1) * kG + gate * kH + col];
      }
    } else {
      slice_dot<kH>(w + (2 * l - 1) * S::kSlice, hbuf + (t & 1) * L * kH + (l - 1) * kH,
                    warp, lane, q, acc);
    }
    slice_dot<kH>(w + 2 * l * S::kSlice, hbuf + ((t + 1) & 1) * L * kH + l * kH, warp, lane,
                  q, acc);
#pragma unroll
    for (int off = kSplits / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        acc[gate] += __shfl_xor_sync(0xffffffffu, acc[gate], off);
    }
    float pre[4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
      pre[gate] = l == 0 ? xc[gate] + acc[gate]
                         : bsm[(l - 1) * 4 * kU + gate * kU + u] + acc[gate];
    const float ig = sigmoidf_(pre[0]);
    const float fg = sigmoidf_(pre[1]);
    const float gg = tanhf(pre[2]);
    const float og = sigmoidf_(pre[3]);
    const float cv = fg * cst[l * kU + u] + ig * gg;
    const float hv = og * tanhf(cv);
    __syncwarp();  // every lane has read c before lane 8 replaces it
    if (q < kCluster) {
      peer_h[(t & 1) * L * kH + l * kH + col] = hv;
    } else if (q == kCluster) {
      cst[l * kU + u] = cv;
    } else if (q == kCluster + 1 && l == L - 1) {
      out[static_cast<size_t>(t) * kH + col] = hv;
    }
  };

  // 4. the links, each closed by one cluster barrier (arrive.release /
  //    wait.acquire); the barrier of the last link is the final one, after
  //    which no CTA writes into another's shared memory
  if (kWave) {
    for (int wf = 0; wf < T + L - 1; ++wf) {
      const int t = wf - group;
      if (t >= 0 && t < T) advance(group, t);
      cluster.sync();
    }
  } else {
    for (int t = 0; t < T; ++t) {
      for (int l = 0; l < L; ++l) {
        advance(l, t);
        cluster.sync();
      }
    }
  }

  // 5. this rank's units of h_n (time T - 1, parity (T + 1) & 1; h0 when
  //    T == 0) and c_n
  for (int i = tid; i < L * kU; i += nthreads) {
    const int l = i / kU, c = rank * kU + (i - l * kU);
    hn[l * kH + c] = hbuf[((T + 1) & 1) * L * kH + l * kH + c];
    cn[l * kH + c] = cst[i];
  }
}

// The kernel's shared-memory attributes, set once per device for the
// largest L it takes (a streaming step launches it hundreds of times)
template <int kH, bool kWave>
cudaError_t allow_cluster_smem() {
  static std::atomic<uint64_t> done{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done.load() & bit)) return cudaSuccess;
  auto kernel = lstm_cluster_kernel<kH, kWave>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cluster_smem_bytes(kH, ClusterShape<kH>::kMaxLayers)));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  done.fetch_or(bit);
  return cudaSuccess;
}

template <int kH, bool kWave>
cudaError_t cluster_config(int G, int L, void* stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  if (!cluster_fits(kH, L)) return cudaErrorInvalidValue;
  const size_t smem = cluster_smem_bytes(kH, L);
  const int threads = 2 * kH * (kWave ? L : 1);
  cudaError_t err = allow_cluster_smem<kH, kWave>();
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kCluster * G, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int kH, bool kWave>
int launch_cluster(const void* xp0, const void* wcl, const void* bias, const void* h0,
                   const void* c0, void* out, void* hn, void* cn, int G, int T, int L,
                   void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<kH, kWave>(G, L, stream, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 0) {
    err = cudaLaunchKernelEx(&cfg, lstm_cluster_kernel<kH, kWave>,
                             static_cast<const float*>(xp0), static_cast<const float*>(wcl),
                             static_cast<const float*>(bias), static_cast<const float*>(h0),
                             static_cast<const float*>(c0), static_cast<float*>(out),
                             static_cast<float*>(hn), static_cast<float*>(cn), T, L);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kH, bool kWave>
int occupancy_cluster(int L, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<kH, kWave>(1, L, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveClusters(clusters, lstm_cluster_kernel<kH, kWave>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------ grid route

constexpr int kGridUnits = 8;                    // hidden units per CTA, a warp each
constexpr int kGridThreads = 32 * kGridUnits;
constexpr int kGridStreams = 8;                  // streams staged at once
constexpr int kGridMaxCtas = 132;                // the H100's SMs, one CTA each

// floats of one CTA's slice of one weight block: 4 gates x 8 units x H
__host__ __device__ constexpr size_t grid_slice_floats(int H) {
  return static_cast<size_t>(4 * kGridUnits) * H;
}

// One CTA's shared memory: its slices of the 2L - 1 blocks and a chunk of
// staged h (two layer inputs of kGridStreams streams)
constexpr size_t grid_smem_bytes(int H, int L) {
  return ((2 * static_cast<size_t>(L) - 1) * grid_slice_floats(H) +
          2 * static_cast<size_t>(kGridStreams) * H) * sizeof(float);
}

// The one rule of which shapes the grid kernel takes: H % 128 == 0 (the
// wrappers' rule), H/8 CTAs within the card's SMs, and one CTA's share
// within a block's shared memory.  ops/lstm_fused.grid_fits states it for
// the CPU; chip_smoke.py holds the two against each other.
constexpr bool grid_fits(int H, int L) {
  return H > 0 && H % 128 == 0 && L >= 1 && H / kGridUnits <= kGridMaxCtas &&
         grid_smem_bytes(H, L) <= kSmemLimit;
}

// The route of (H, L): 1 cluster, 2 grid, 0 L2 (ops/lstm_fused.choose_route)
constexpr int choose_route(int H, int L) {
  return cluster_fits(H, L) ? 1 : grid_fits(H, L) ? 2 : 0;
}

struct GridArgs {
  const float* xp0;
  const float* bias;
  const float* h0;
  const float* c0;
  float* out;
  float* hn;
  float* cn;
  float* hx;
  int G, T, H, L;
};

// The sums over a warp's 32 lanes of each lane's 4 NG values v[], from
// lane bit log2(O) down: at a bit that indexes no value (O >= 4 NG) every
// value is summed with the partner lane's; at the others each lane keeps
// the half of its values that its bit selects and adds the partner's copy
// of that half, so that at the end v[0] of lane j is the sum of value
// j % (4 NG), in 31 shuffles for NG = 8
template <int NG, int O>
__device__ __forceinline__ void warp_reduce(float (&v)[4 * NG], int lane) {
  if constexpr (O >= 1) {
    if constexpr (O >= 4 * NG) {
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], O);
    } else {
      const bool upper = lane & O;
#pragma unroll
      for (int j = 0; j < O; ++j) {
        const float send = upper ? v[j] : v[j + O];
        const float keep = upper ? v[j + O] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
    }
    warp_reduce<NG, O / 2>(v, lane);
  }
}

// Warp `warp` (unit col = 8b + warp) advances layer l to time t for streams
// g0 .. g0 + NG - 1 (those below G): stage their h inputs, sum the unit's
// four gate columns over them, reduce, update the cells, write h and c.
// The staged chunk `hs` is shared by the CTA's warps; ends in __syncthreads.
template <int NG>
__device__ __forceinline__ void grid_advance(const GridArgs& a, const float* __restrict__ w,
                                             float* hs, int l, int t, int g0, int col,
                                             int warp, int lane) {
  const int H = a.H, L = a.L, G4 = 4 * H, kK = H / 32;
  const int gc = min(NG, a.G - g0);
  const int nin = l == 0 ? 1 : 2;  // h_l(t - 1), and h_{l-1}(t) above layer 0

  // lane 4s + gate of the first 4 NG lanes owns stream g0 + s, gate `gate`
  const int s_own = (lane >> 2) & (NG - 1), gate = lane & 3;
  const bool owner = lane < 4 * NG && s_own < gc;
  const int g = g0 + s_own;
  const size_t state = (static_cast<size_t>(g) * L + l) * H + col;
  float c_old = 0.f, xin = 0.f;
  if (owner) {
    c_old = t == 0 ? a.c0[state] : __ldcg(a.cn + state);
    xin = l == 0 ? __ldg(a.xp0 + (static_cast<size_t>(g) * a.T + t) * G4 + gate * H + col)
                 : __ldg(a.bias + (l - 1) * G4 + gate * H + col);
  }

  // 1. stage the chunk's h inputs (all CTAs wrote them in the last link)
  const int H4 = H / 4, per_in = gc * H4;
  for (int i = threadIdx.x; i < nin * per_in; i += kGridThreads) {
    const int in = i / per_in, s = (i - in * per_in) / H4, k4 = i - in * per_in - s * H4;
    const float* src;
    if (in == 0) {
      src = t == 0 ? a.h0 + (static_cast<size_t>(g0 + s) * L + l) * H
                   : a.hx + ((static_cast<size_t>((t + 1) & 1) * a.G + g0 + s) * L + l) * H;
    } else {
      src = a.hx + ((static_cast<size_t>(t & 1) * a.G + g0 + s) * L + l - 1) * H;
    }
    reinterpret_cast<float4*>(hs + (in * kGridStreams + s) * H)[k4] =
        __ldcg(reinterpret_cast<const float4*>(src) + k4);
  }
  __syncthreads();

  // 2. this lane's partial sums of the unit's 4 gates for each stream:
  //    block 2l (W_hh_l) on h_l(t - 1), block 2l - 1 (W_ih_l) on h_{l-1}(t)
  float v[4 * NG];
#pragma unroll
  for (int j = 0; j < 4 * NG; ++j) v[j] = 0.f;
  for (int in = 0; in < nin; ++in) {
    const float4* wq = reinterpret_cast<const float4*>(w + (2 * l - in) * grid_slice_floats(H)) +
                       static_cast<size_t>(warp) * kK * 32 + lane;
    const float* hv = hs + in * kGridStreams * H + lane;
#pragma unroll 4
    for (int i = 0; i < kK; ++i) {  // kK = H/32, a multiple of 4
      const float4 wi = wq[i * 32];
#pragma unroll
      for (int s = 0; s < NG; ++s) {
        const float x = hv[s * H + i * 32];
        v[4 * s] = fmaf(wi.x, x, v[4 * s]);
        v[4 * s + 1] = fmaf(wi.y, x, v[4 * s + 1]);
        v[4 * s + 2] = fmaf(wi.z, x, v[4 * s + 2]);
        v[4 * s + 3] = fmaf(wi.w, x, v[4 * s + 3]);
      }
    }
  }

  // 3. reduce over the warp's 32 lanes: v[0] of lane j is then the sum of
  //    value j % (4 NG)
  warp_reduce<NG, 16>(v, lane);

  // 4. gather the stream's four gates, update the cell; lane `gate` of the
  //    stream writes h into the exchange, c, h_n, or the top layer's out
  const float pre = v[0] + xin;
  const int base = lane & ~3;
  const float ig = sigmoidf_(__shfl_sync(0xffffffffu, pre, base));
  const float fg = sigmoidf_(__shfl_sync(0xffffffffu, pre, base + 1));
  const float gg = tanhf(__shfl_sync(0xffffffffu, pre, base + 2));
  const float og = sigmoidf_(__shfl_sync(0xffffffffu, pre, base + 3));
  const float cv = fg * c_old + ig * gg;
  const float hv = og * tanhf(cv);
  if (owner) {
    if (gate == 0) {
      __stcg(a.hx + ((static_cast<size_t>(t & 1) * a.G + g) * L + l) * H + col, hv);
    } else if (gate == 1) {
      __stcg(a.cn + state, cv);
    } else if (gate == 2) {
      a.hn[state] = hv;
    } else if (l == L - 1) {
      a.out[(static_cast<size_t>(g) * a.T + t) * H + col] = hv;
    }
  }
  __syncthreads();  // every warp has read hs before it is staged again
}

// Layer l to time t for all streams, in chunks of kGridStreams
__device__ __forceinline__ void grid_layer(const GridArgs& a, const float* w, float* hs, int l,
                                           int t, int col, int warp, int lane) {
  for (int g0 = 0; g0 < a.G; g0 += kGridStreams) {
    const int gc = min(kGridStreams, a.G - g0);
    if (gc > 4) {
      grid_advance<8>(a, w, hs, l, t, g0, col, warp, lane);
    } else if (gc > 2) {
      grid_advance<4>(a, w, hs, l, t, g0, col, warp, lane);
    } else if (gc > 1) {
      grid_advance<2>(a, w, hs, l, t, g0, col, warp, lane);
    } else {
      grid_advance<1>(a, w, hs, l, t, g0, col, warp, lane);
    }
  }
}

// One grid-wide barrier, the n-th of the launch: every CTA has arrived n
// times.  Thread 0 arrives with a release at gpu scope after the CTA's
// threads have stored (__syncthreads orders their stores before it; the
// release is cumulative, as in CUTLASS's GenericBarrier), and waits with
// acquire loads, after which __syncthreads orders the CTA's reads.
__device__ __forceinline__ void grid_barrier(unsigned int* arrivals, unsigned int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int target = n * gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(arrivals) : "memory");
    unsigned int seen = 0;
    for (long long spins = 0;; ++spins) {
      asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(seen) : "l"(arrivals) : "memory");
      if (static_cast<int>(seen - target) >= 0) break;
      if (spins > kSpinLimit) __trap();
    }
  }
  __syncthreads();
}

// kWave false: K4, links (t, l) in order; kWave true: K5, link w advances
// every live layer l to time w - l.  grid = H/8 CTAs, cooperative.
template <bool kWave>
__global__ void __launch_bounds__(kGridThreads, 1)
lstm_grid_kernel(const float* __restrict__ xp0, const float* __restrict__ wgr,
                 const float* __restrict__ bias, const float* __restrict__ h0,
                 const float* __restrict__ c0, float* __restrict__ out,
                 float* __restrict__ hn, float* cn, float* hx, unsigned int* arrivals, int G,
                 int T, int H, int L) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x, col = b * kGridUnits + warp;
  const int nblocks = 2 * L - 1;
  const size_t slice = grid_slice_floats(H);

  extern __shared__ __align__(16) float sm[];
  float* w = sm;                   // (2L - 1) slices
  float* hs = w + nblocks * slice; // (2, kGridStreams, H) staged h
  __shared__ __align__(8) uint64_t wbar;

  // 1. this CTA's weight slices, once per launch
  const uint32_t bar = smem_u32(&wbar);
  if (tid == 0) init_load_barrier(bar);
  __syncthreads();
  if (tid == 0) {
    start_bulk_load(bar, w, wgr + static_cast<size_t>(b) * nblocks * slice,
                    static_cast<uint32_t>(slice * sizeof(float)), nblocks);
  }
  const GridArgs a{xp0, bias, h0, c0, out, hn, cn, hx, G, T, H, L};
  wait_bulk_load(bar);

  // 2. the links, a grid barrier between two
  unsigned int barriers = 0;
  if (kWave) {
    const int links = T > 0 ? T + L - 1 : 0;
    for (int wf = 0; wf < links; ++wf) {
      for (int l = max(0, wf - T + 1); l <= min(L - 1, wf); ++l)
        grid_layer(a, w, hs, l, wf - l, col, warp, lane);
      if (wf + 1 < links) grid_barrier(arrivals, ++barriers);
    }
  } else {
    for (int t = 0; t < T; ++t) {
      for (int l = 0; l < L; ++l) {
        grid_layer(a, w, hs, l, t, col, warp, lane);
        if (t + 1 < T || l + 1 < L) grid_barrier(arrivals, ++barriers);
      }
    }
  }

  // 3. no step: h_n, c_n are h0, c0 (this CTA's units)
  if (T == 0) {
    for (int i = tid; i < G * L * kGridUnits; i += kGridThreads) {
      const size_t e = static_cast<size_t>(i / kGridUnits) * H + b * kGridUnits + i % kGridUnits;
      hn[e] = h0[e];
      cn[e] = c0[e];
    }
  }
}

// The kernel's shared-memory attributes, set once per device to the most a
// block may opt in to (a streaming step launches it hundreds of times)
template <bool kWave>
cudaError_t allow_grid_smem() {
  static std::atomic<uint64_t> done{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(lstm_grid_kernel<kWave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lstm_grid_kernel<kWave>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  done.fetch_or(bit);
  return cudaSuccess;
}

template <bool kWave>
int launch_grid(const void* xp0, const void* wgr, const void* bias, const void* h0,
                const void* c0, void* out, void* hn, void* cn, void* hx, void* arrivals, int G,
                int T, int H, int L, void* stream) {
  if (!grid_fits(H, L)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_grid_smem<kWave>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 0) {
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3(H / kGridUnits, 1, 1);
    cfg.blockDim = dim3(kGridThreads, 1, 1);
    cfg.dynamicSmemBytes = grid_smem_bytes(H, L);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr{};
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, lstm_grid_kernel<kWave>, static_cast<const float*>(xp0),
                             static_cast<const float*>(wgr), static_cast<const float*>(bias),
                             static_cast<const float*>(h0), static_cast<const float*>(c0),
                             static_cast<float*>(out), static_cast<float*>(hn),
                             static_cast<float*>(cn), static_cast<float*>(hx),
                             static_cast<unsigned int*>(arrivals), G, T, H, L);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kWave>
int occupancy_grid(int H, int L, int* blocks_per_sm) {
  if (!grid_fits(H, L)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_grid_smem<kWave>();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, lstm_grid_kernel<kWave>,
                                                      kGridThreads, grid_smem_bytes(H, L));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evfly_lstm_stacked(const void* xp0, const void* whh_t, const void* wih_t,
                                  const void* bias, const void* h0, const void* c0,
                                  void* out, void* hn, void* cn, int G, int T, int H, int L,
                                  void* stream) {
  const size_t smem = static_cast<size_t>(2 * L * H + 4 * H) * sizeof(float);
  return launch(lstm_stacked_kernel, kThreads, smem, xp0, whh_t, wih_t, bias, h0, c0, out, hn,
                cn, G, T, H, L, stream);
}

extern "C" int evfly_lstm_wavefront(const void* xp0, const void* whh_t, const void* wih_t,
                                    const void* bias, const void* h0, const void* c0,
                                    void* out, void* hn, void* cn, int G, int T, int H, int L,
                                    void* stream) {
  const size_t smem = static_cast<size_t>(2 * L * H + 4 * L * H) * sizeof(float);
  return launch(lstm_wavefront_kernel, kWaveThreads, smem, xp0, whh_t, wih_t, bias, h0, c0,
                out, hn, cn, G, T, H, L, stream);
}

// K4 (wave == 0) or K5 (wave != 0) on the cluster route; H is 128 or 256
extern "C" int evfly_lstm_cluster(const void* xp0, const void* wcl, const void* bias,
                                  const void* h0, const void* c0, void* out, void* hn,
                                  void* cn, int G, int T, int H, int L, int wave,
                                  void* stream) {
  if (H == 128) {
    return wave ? launch_cluster<128, true>(xp0, wcl, bias, h0, c0, out, hn, cn, G, T, L, stream)
                : launch_cluster<128, false>(xp0, wcl, bias, h0, c0, out, hn, cn, G, T, L,
                                             stream);
  }
  if (H == 256) {
    return wave ? launch_cluster<256, true>(xp0, wcl, bias, h0, c0, out, hn, cn, G, T, L, stream)
                : launch_cluster<256, false>(xp0, wcl, bias, h0, c0, out, hn, cn, G, T, L,
                                             stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaOccupancyMaxActiveClusters of the cluster kernel at (H, L) into *clusters
extern "C" int evfly_lstm_cluster_occupancy(int H, int L, int wave, int* clusters) {
  if (H == 128) {
    return wave ? occupancy_cluster<128, true>(L, clusters)
                : occupancy_cluster<128, false>(L, clusters);
  }
  if (H == 256) {
    return wave ? occupancy_cluster<256, true>(L, clusters)
                : occupancy_cluster<256, false>(L, clusters);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 where the cluster route takes (H, L), else 0: ClusterShape's rule, for
// holding ops/lstm_fused.cluster_fits against it
extern "C" int evfly_lstm_cluster_fits(int H, int L) { return cluster_fits(H, L) ? 1 : 0; }

// K4 (wave == 0) or K5 (wave != 0) on the grid route: H/8 cooperative CTAs
// for all G streams; hx (2, G, L, H) the exchange, arrivals one uint32 that
// is 0 at launch
extern "C" int evfly_lstm_grid(const void* xp0, const void* wgr, const void* bias,
                               const void* h0, const void* c0, void* out, void* hn, void* cn,
                               void* hx, void* arrivals, int G, int T, int H, int L, int wave,
                               void* stream) {
  return wave ? launch_grid<true>(xp0, wgr, bias, h0, c0, out, hn, cn, hx, arrivals, G, T, H, L,
                                  stream)
              : launch_grid<false>(xp0, wgr, bias, h0, c0, out, hn, cn, hx, arrivals, G, T, H,
                                   L, stream);
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the grid kernel at (H, L)
extern "C" int evfly_lstm_grid_occupancy(int H, int L, int wave, int* blocks_per_sm) {
  return wave ? occupancy_grid<true>(H, L, blocks_per_sm)
              : occupancy_grid<false>(H, L, blocks_per_sm);
}

// 1 where the grid kernel takes (H, L), else 0: for holding
// ops/lstm_fused.grid_fits against it
extern "C" int evfly_lstm_grid_fits(int H, int L) { return grid_fits(H, L) ? 1 : 0; }

// The route of (H, L): 1 cluster, 2 grid, 0 L2, for holding
// ops/lstm_fused.choose_route against it
extern "C" int evfly_lstm_route(int H, int L) { return choose_route(H, L); }
