// Shared helpers for the hand-written Hopper kernels of knpemidg_tpu_torch.
//
// Every entry point has a plain C interface (loaded with ctypes from
// knpemidg_tpu_torch/_cuda.py), launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() right after the launch, so a refused
// launch surfaces in the Python wrapper instead of disappearing.
#pragma once

#include <cuda_runtime.h>

#define KNP_THREADS 256

static inline unsigned int knp_blocks(long long n) {
  return (unsigned int)((n + KNP_THREADS - 1) / KNP_THREADS);
}
