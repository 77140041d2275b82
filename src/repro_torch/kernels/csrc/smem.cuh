// Shared memory above the default limit, for the kernels of every source
// (fold_device.cuh and masked_reduce.cuh include it).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it
// must ask).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
