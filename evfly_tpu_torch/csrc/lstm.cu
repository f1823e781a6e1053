// K4 and K5: stacked multi-layer LSTM inference, one block per stream.
//
// K4 replaces evfly_tpu/ops/lstm_pallas.py `_lstm_fused` (kernel body
// `_make_lstm_kernel`, the "stacked" mode); K5 replaces
// `_lstm_fused_wavefront` (kernel body `_make_lstm_kernel_wavefront`, the
// "wavefront" mode).  Same inputs and math as the TPU kernels: gates
// ordered (i, f, g, o) as torch packs them, f32 throughout, the layer-0
// input projection (x_proj0 = x W_ih0^T + b_ih0 + b_hh0) hoisted out by the
// caller.  Both take a leading stream axis: G independent sequences with
// their own state and shared weights, one block each, which is what
// `jax.vmap` over the pallas_call computes for the batched streaming
// pipeline.  One unbatched sequence is G = 1.
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
// T * L (K4) or T + L - 1 (K5) steps long, each a pass over the weights of
// the live layers.  The design is the simple one: one block per stream,
// threads over the gate columns, h and c in shared memory and two
// __syncthreads() per step.  The weights (1.25 MiB at H = 128, L = 3) do not
// fit in shared memory; they are read from global memory on every step,
// where they stay in L2, column-major per thread so a warp's loads are
// coalesced, and in batches of kBatch loads into registers so that one SM
// keeps many in flight: a step is then bound by how fast one SM reads L2.
// A cluster that splits the weights over several SMs' shared memory is the
// next step.
//
// Layouts (all f32, row-major):
//   xp0   (G, T, 4H)       layer-0 gates before the recurrent term
//   whh_t (H, L * 4H)      W_hh^T of each layer, side by side
//   wih_t (H, (L-1) * 4H)  W_ih^T of layers 1..L-1 (unused when L == 1)
//   bias  ((L-1) * 4H)     b_ih + b_hh of layers 1..L-1
//   h0, c0, hn, cn (G, L, H); out (G, T, H)
//
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

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
