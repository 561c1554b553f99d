// Shared helpers for the hand-written Hopper kernels of knpemidg_tpu_torch.
//
// Every entry point has a plain C interface (loaded with ctypes from
// knpemidg_tpu_torch/_cuda.py), launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() right after the launch, so a refused
// launch surfaces in the Python wrapper instead of disappearing.
#pragma once

#include <cuda_runtime.h>

#define KNP_THREADS 256

#define KNP_WARPS (KNP_THREADS / 32)

// the index bits of a packed cell-facet slot word (ops/assembly.py
// slot_words): bit 30 marks a membrane facet, bit 31 cf_is_plus
#define KNP_IDX_MASK 0x3fffffffu

static inline unsigned int knp_blocks(long long n) {
  return (unsigned int)((n + KNP_THREADS - 1) / KNP_THREADS);
}

// chunks of ``chunk`` entries covering n (the reduction kernels' blocks)
static inline int knp_chunks(long long n, int chunk) { return (int)((n + chunk - 1) / chunk); }

// Sum over a warp in a fixed shuffle tree; every lane gets the result.
template <typename T>
__device__ __forceinline__ T knp_warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one value per thread over a block of KNP_THREADS threads in a fixed
// order (each warp's shuffle tree, then the warps in index order); every
// thread gets the result.  ``red`` holds KNP_WARPS values; the block is
// synchronised before ``red`` is written, so calls may follow each other.
template <typename T>
__device__ __forceinline__ T knp_block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = knp_warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T acc = red[0];
  for (int w = 1; w < KNP_WARPS; ++w) acc += red[w];
  return acc;
}
