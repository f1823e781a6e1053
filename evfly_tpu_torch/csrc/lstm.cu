// K4: stacked multi-layer LSTM inference over one unbatched sequence.
//
// Replaces evfly_tpu/ops/lstm_pallas.py `_lstm_fused` (kernel body
// `_make_lstm_kernel`, the "stacked" mode).  Same inputs and math: gates
// ordered (i, f, g, o) as torch packs them, f32 throughout, the layer-0
// input projection (x_proj0 = x W_ih0^T + b_ih0 + b_hh0) hoisted out by the
// caller, and each time step advancing layers 0..L-1 in turn.
//
// What bounds it on the H100: neither bytes nor operations but the serial
// chain of T * L dependent matrix-vector products.  Its bound by operations
// (2 T H 4H (2L - 1) flops) is a few microseconds; the chain is T * L steps
// long, each a full pass over the layer's weights.  The design is the simple
// one: one block, one thread per gate column (a loop when 4H exceeds the
// block), h and c in shared memory and two __syncthreads() per
// (layer, step).  The weights (1.25 MiB at H = 128, L = 3) do not fit in
// shared memory; they are read from global memory on every step, where they
// stay in L2, column-major per thread so a warp's loads are coalesced, and
// in batches of kBatch loads into registers so that one SM keeps many in
// flight: a step is then bound by how fast one SM reads L2.  A cluster that
// splits the weights over several SMs' shared memory is the next step.
//
// Layouts (all f32, row-major):
//   xp0   (T, 4H)          layer-0 gates before the recurrent term
//   whh_t (H, L * 4H)      W_hh^T of each layer, side by side
//   wih_t (H, (L-1) * 4H)  W_ih^T of layers 1..L-1 (unused when L == 1)
//   bias  ((L-1) * 4H)     b_ih + b_hh of layers 1..L-1
//   h0, c0, hn, cn (L, H); out (T, H)
//
// The C entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBatch = 16;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

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
  const int whh_ld = L * G, wih_ld = (L - 1) * G;

  for (int i = tid; i < L * H; i += nthreads) { h[i] = h0[i]; c[i] = c0[i]; }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int l = 0; l < L; ++l) {
      const float* hl = h + l * H;
      // each thread's dot products read a weight column from L2: the loads
      // go out in batches of kBatch into registers before the FMAs use them,
      // so that many are in flight (H % kBatch == 0: the wrapper asks for
      // H % 128 == 0)
      for (int j = tid; j < G; j += nthreads) {
        const float* wh = whh_t + l * G + j;
        float r = 0.f;
        if (l == 0) {
          for (int k0 = 0; k0 < H; k0 += kBatch) {
            float w[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) w[u] = __ldg(wh + (k0 + u) * whh_ld);
#pragma unroll
            for (int u = 0; u < kBatch; ++u) r += hl[k0 + u] * w[u];
          }
          gates[j] = xp0[static_cast<size_t>(t) * G + j] + r;
        } else {
          const float* inp = h + (l - 1) * H;  // layer l-1's h at this step
          const float* wi = wih_t + (l - 1) * G + j;
          float s = 0.f;
          for (int k0 = 0; k0 < H; k0 += kBatch) {
            float a[kBatch], w[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              a[u] = __ldg(wi + (k0 + u) * wih_ld);
              w[u] = __ldg(wh + (k0 + u) * whh_ld);
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              s += inp[k0 + u] * a[u];
              r += hl[k0 + u] * w[u];
            }
          }
          gates[j] = (s + bias[(l - 1) * G + j]) + r;
        }
      }
      __syncthreads();
      for (int u = tid; u < H; u += nthreads) {
        const float ig = sigmoidf_(gates[u]);
        const float fg = sigmoidf_(gates[H + u]);
        const float gg = tanhf(gates[2 * H + u]);
        const float og = sigmoidf_(gates[3 * H + u]);
        const float cv = fg * c[l * H + u] + ig * gg;
        const float hv = og * tanhf(cv);
        c[l * H + u] = cv;
        h[l * H + u] = hv;
        if (l == L - 1) out[static_cast<size_t>(t) * H + u] = hv;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < L * H; i += nthreads) { hn[i] = h[i]; cn[i] = c[i]; }
}

}  // namespace

extern "C" int evfly_lstm_stacked(const void* xp0, const void* whh_t, const void* wih_t,
                                  const void* bias, const void* h0, const void* c0,
                                  void* out, void* hn, void* cn, int T, int H, int L,
                                  void* stream) {
  const size_t smem = static_cast<size_t>(2 * L * H + 4 * H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lstm_stacked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_stacked_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp0), static_cast<const float*>(whh_t),
      static_cast<const float*>(wih_t), static_cast<const float*>(bias),
      static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<float*>(out), static_cast<float*>(hn), static_cast<float*>(cn), T, H, L);
  return static_cast<int>(cudaGetLastError());
}
