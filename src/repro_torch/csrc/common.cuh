// Shared by every kernel library: each .cu is built into its own shared
// library with a plain C interface (see repro_torch/kernels/build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Human-readable text of a CUDA error code returned by a launch function.
REPRO_EXPORT const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline unsigned int blocks_for(long long work, int threads) {
  return static_cast<unsigned int>((work + threads - 1) / threads);
}
