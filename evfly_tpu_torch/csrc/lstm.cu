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
// T * L (K4) or T + L - 1 (K5) links long.  Each of the two routes below
// does something else about the cost of one link.
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
// The L2 route (lstm_stacked_kernel, lstm_wavefront_kernel; every other
// shape with H % 128 == 0, e.g. H = 256 with L = 3): one block per stream,
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
//   bias  ((L-1) * 4H)     b_ih + b_hh of layers 1..L-1
//   h0, c0, hn, cn (G, L, H); out (G, T, H)
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
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bytes = S::kSlice * sizeof(float);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(bytes * nblocks)
                 : "memory");
    const float* src = wcl + static_cast<size_t>(rank) * nblocks * S::kSlice;
    for (int m = 0; m < nblocks; ++m) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_u32(w + m * S::kSlice)),
          "l"(reinterpret_cast<uint64_t>(src + m * S::kSlice)), "r"(bytes), "r"(bar)
          : "memory");
    }
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
  uint32_t loaded = 0;
  while (!loaded) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(loaded)
        : "r"(bar)
        : "memory");
  }

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
