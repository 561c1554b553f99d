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

// The static tables of the per-cell and per-node assembly kernels (K10
// emi_cell, K11 ion_cell and alpha_sum, K14 eliminated), built and checked
// once per solver (ops/assembly.cell_tables; the public routes of alpha_sum
// and eliminated build theirs for the call) and read by their launchers
// through a pointer; each kernel gets what it uses by value.  z and zz = z * z are rounded in the tables' dtype, as the
// kernels computed them from a table in device memory before.
#define KNP_CELL_MAXI 6       // the ion counts the cell kernels are built for: 1..6
struct KnpCellTables {
  const void* G;              // (nd, d, nc)
  const void* vol;            // (nc,)
  const void* D;              // (n_ions, nc), alpha_sum's, or null
  const void* rho;            // (nc,), eliminated's, or null
  int nd, d, nc, n_ions;
  double z[KNP_CELL_MAXI], zz[KNP_CELL_MAXI];
  double phibar[4], M0[16];   // phibar (nd,), M0 (nd, nd) row by row
};

// CPT (1 or 2) consecutive cells of a row in one load or store: two cells
// are one 16-byte (double) or 8-byte (float) vector access, so the row
// offset must be even and the pointer aligned to two elements
template <typename T> struct KnpVec2;
template <> struct KnpVec2<float> { typedef float2 V; };
template <> struct KnpVec2<double> { typedef double2 V; };

template <typename T, int CPT>
__device__ __forceinline__ void knp_ld(const T* __restrict__ p, T (&v)[CPT]) {
  if constexpr (CPT == 2) {
    const typename KnpVec2<T>::V w = *reinterpret_cast<const typename KnpVec2<T>::V*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
    v[0] = *p;
  }
}

template <typename T, int CPT>
__device__ __forceinline__ void knp_st(T* __restrict__ p, const T (&v)[CPT]) {
  if constexpr (CPT == 2) {
    typename KnpVec2<T>::V w;
    w.x = v[0];
    w.y = v[1];
    *reinterpret_cast<typename KnpVec2<T>::V*>(p) = w;
  } else {
    *p = v[0];
  }
}

static inline bool knp_aligned(const void* p, size_t bytes) {
  return ((size_t)p % bytes) == 0;
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

// z[i] = sum_j P[i][j] r[j] for one cell c of an ND x ND block-Jacobi
// inverse (P's entry (i, j) at (i ND + j) ncz + c, r's j at j ncz + c): the
// row starts from its first product and adds the others in order.  K5's
// full-form apply and the two-level kernels' folded prolong-add
// (two_level.cu) both compute it here, so that nvcc contracts the sums alike
// and the two give the same bits.
template <typename T, int ND>
__device__ __forceinline__ void bj_block_apply(const T* __restrict__ P, const T* __restrict__ r,
                                               T (&z)[ND], int c, size_t ncz) {
  T rv[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) rv[j] = r[j * ncz + c];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    T a = P[(size_t)(i * ND) * ncz + c] * rv[0];
#pragma unroll
    for (int j = 1; j < ND; ++j) a += P[(size_t)(i * ND + j) * ncz + c] * rv[j];
    z[i] = a;
  }
}
