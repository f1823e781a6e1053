// An empty kernel: timed beside the port's kernels, under the same harness,
// as the practical floor of one launch (a plain launch of one block, or of
// one cluster of `cluster` CTAs).

#include <cuda_runtime.h>

#include <atomic>

namespace {

__global__ void empty_kernel() {}

std::atomic<bool> g_non_portable{false};

}  // namespace

extern "C" int evfly_empty(int cluster, void* stream) {
  if (cluster > 8 && !g_non_portable.load()) {  // a cluster past 8 CTAs is non-portable
    cudaError_t err =
        cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_non_portable.store(true);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(32, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  if (cluster > 1) {
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
