// What the tiled flash kernels (flash_attention.cu), the pair grid's
// kernels (block_sparse_attention.cu) and the sweeps they share
// (tf32_sweeps.cuh, bf16_sweeps.cuh) take in common: the masked score
// NEG_INF, the 64-row query tile TILE and allow_smem. Every one of them
// runs on the tensor cores. Disallowed scores are NEG_INF = -1e30 and
// p = exp(s - m) only where s > 0.5 * NEG_INF, else 0.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;  // query rows / keys per tile

// 0 when the device can give `smem` bytes of shared memory to `kernel`,
// -1 when it cannot, else the CUDA error
template <typename K>
int allow_smem(K kernel, int smem) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > smem_max) return -1;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace
