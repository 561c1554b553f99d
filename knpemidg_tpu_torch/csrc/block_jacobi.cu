// Kernel B: block-Jacobi inverse and apply.
//
// Replaces knpemidg_tpu/ops/spmv.py:102 block_jacobi_inverse (unrolled
// Gauss-Jordan over the cell axis, elementwise XLA on the TPU) and :131
// block_jacobi_apply (per-cell nd x nd GEMV), for one or m systems, at the
// cell layout's nd = 4 (3D) and nd = 3 (2D) and the 3D pair layout's
// 2nd = 8.
//
// Bound: device-memory bandwidth.  The inverse reads and writes nd*nd values
// per block with ~nd^3 flops in between; the apply, called in every
// preconditioner apply of both Krylov solves, reads nd*nd + nd values and
// writes nd.  At the pair layout's main-path shapes (63,558 pairs, one EMI
// and two KNP systems) the inverses move 0.10 / 0.20 GB and the halves-form
// applies 0.037 / 0.073 GB in float32 / float64 (29 / 58 us and 11 / 22 us
// at 3.35 TB/s).  Design: one thread per (system, block) holds its whole block
// in registers, with cells-last coalesced loads and stores.  The inverse is
// the JAX package's unpivoted Gauss-Jordan in the same elimination order,
// done in place: the inverse's column k is stored where A's column k dies
// at step k, which gives the augmented [A | I] scheme's values operation for
// operation with half its registers (64 doubles at nd = 8 instead of 128).
// The DG diagonal blocks are mass-regularised SPD, so the pivots stay
// positive; with pair_bj = 'halves' the 8 x 8 blocks are block diagonal and
// the eliminations across the halves multiply by zero, as in the JAX
// function.
//
// The apply's halves form (pair_bj = 'halves', the pair layout's main path):
// the two off-diagonal 4 x 4 blocks of each inverse are exact zeros, so a
// thread per (system, half, pair) reads only its half's 4 x 4 block and 4
// entries of r: 384 of the full form's 640 bytes a pair and system in
// float64 (each skipped row of the cells-last layout is a whole npair-long
// row, so no sector is half used).  The half is the grid's y index, so each
// half's code is straight-line and a warp never holds both.  Bits: the full
// form adds the off-diagonal block's zero products into each row; with
// nvcc's contraction fma(0, r, a) = a and fma(P, r, +-0) = P * r rounded, so
// half 0 keeps the full form's first four terms as written (a = P r, then
// a += P r, contracted alike) and half 1 starts from the rounded product
// (__dmul_rn / __fmul_rn, which nvcc does not contract) before the same
// a += P r terms.  Every value then equals the full form's, up to the sign
// of an exact zero.
#include "common.cuh"

template <typename T, int ND>
__global__ void bj_inverse_kernel(const T* __restrict__ P, T* __restrict__ Pinv,
                                  int m, int nc) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * nc) return;
  const int s = (int)(idx / nc);
  const int c = (int)(idx - (long long)s * nc);
  const size_t ncz = (size_t)nc;
  const T* Ps = P + (size_t)s * ND * ND * ncz;

  T A[ND][ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
#pragma unroll
    for (int j = 0; j < ND; ++j) A[i][j] = Ps[(size_t)(i * ND + j) * ncz + c];
  }
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const T piv = T(1) / A[k][k];
    // row k: A's columns j != k scale, column k takes I[k][k] * piv = piv
#pragma unroll
    for (int j = 0; j < ND; ++j) A[k][j] = (j == k) ? piv : A[k][j] * piv;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      if (i == k) continue;
      const T f = A[i][k];
      A[i][k] = T(0);                  // I[i][k] before step k
#pragma unroll
      for (int j = 0; j < ND; ++j) A[i][j] = A[i][j] - f * A[k][j];
    }
  }
  T* Os = Pinv + (size_t)s * ND * ND * ncz;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
#pragma unroll
    for (int j = 0; j < ND; ++j) Os[(size_t)(i * ND + j) * ncz + c] = A[i][j];
  }
}

template <typename T, int ND>
__device__ __forceinline__ void bj_apply_full(const T* __restrict__ Ps, const T* __restrict__ rs,
                                              T* __restrict__ zs, int c, size_t ncz) {
  T rv[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) rv[j] = rs[j * ncz + c];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    T a = Ps[(size_t)(i * ND) * ncz + c] * rv[0];
#pragma unroll
    for (int j = 1; j < ND; ++j) a += Ps[(size_t)(i * ND + j) * ncz + c] * rv[j];
    zs[i * ncz + c] = a;
  }
}

__device__ __forceinline__ float bj_mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double bj_mul_rn(double a, double b) { return __dmul_rn(a, b); }

// one half H of an 8 x 8 pair block: rows and columns 4H .. 4H + 3
template <typename T, int H>
__device__ __forceinline__ void bj_apply_half(const T* __restrict__ Ps,
                                              const T* __restrict__ rs, T* __restrict__ zs,
                                              int c, size_t ncz) {
  constexpr int ND = 8, NH = 4, O = H * NH;
  T rv[NH];
#pragma unroll
  for (int j = 0; j < NH; ++j) rv[j] = rs[(O + j) * ncz + c];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const T* row = Ps + (size_t)((O + i) * ND + O) * ncz + c;
    T a;
    if constexpr (H == 0) {
      a = row[0] * rv[0];
    } else {
      a = bj_mul_rn(row[0], rv[0]);
    }
#pragma unroll
    for (int j = 1; j < NH; ++j) a += row[j * ncz] * rv[j];
    zs[(O + i) * ncz + c] = a;
  }
}

// full form: a thread per (system, block); halves form (ND = 8): a thread
// per (system, pair) of half blockIdx.y
template <typename T, int ND, bool HALVES>
__global__ void bj_apply_kernel(const T* __restrict__ Pinv, const T* __restrict__ r,
                                T* __restrict__ z, int m, int nc) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * nc) return;
  const int s = (int)(idx / nc);
  const int c = (int)(idx - (long long)s * nc);
  const size_t ncz = (size_t)nc;
  const T* Ps = Pinv + (size_t)s * ND * ND * ncz;
  const T* rs = r + (size_t)s * ND * ncz;
  T* zs = z + (size_t)s * ND * ncz;
  if constexpr (!HALVES) {
    bj_apply_full<T, ND>(Ps, rs, zs, c, ncz);
  } else {
    static_assert(ND == 8, "the halves form is built for the 8 x 8 pair blocks");
    if (blockIdx.y == 0) {
      bj_apply_half<T, 0>(Ps, rs, zs, c, ncz);
    } else {
      bj_apply_half<T, 1>(Ps, rs, zs, c, ncz);
    }
  }
}

template <typename T>
static int bj_inverse_launch(const T* P, T* Pinv, int m, int nd, int nc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int grid = knp_blocks((long long)m * nc);
  if (nd == 3) {
    bj_inverse_kernel<T, 3><<<grid, KNP_THREADS, 0, st>>>(P, Pinv, m, nc);
  } else if (nd == 4) {
    bj_inverse_kernel<T, 4><<<grid, KNP_THREADS, 0, st>>>(P, Pinv, m, nc);
  } else if (nd == 8) {
    bj_inverse_kernel<T, 8><<<grid, KNP_THREADS, 0, st>>>(P, Pinv, m, nc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int bj_apply_launch(const T* Pinv, const T* r, T* z, int m, int nd, int nc, int halves,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int grid = knp_blocks((long long)m * nc);
  if (halves) {
    if (nd != 8) return (int)cudaErrorInvalidValue;
    bj_apply_kernel<T, 8, true><<<dim3(grid, 2), KNP_THREADS, 0, st>>>(Pinv, r, z, m, nc);
  } else if (nd == 3) {
    bj_apply_kernel<T, 3, false><<<grid, KNP_THREADS, 0, st>>>(Pinv, r, z, m, nc);
  } else if (nd == 4) {
    bj_apply_kernel<T, 4, false><<<grid, KNP_THREADS, 0, st>>>(Pinv, r, z, m, nc);
  } else if (nd == 8) {
    bj_apply_kernel<T, 8, false><<<grid, KNP_THREADS, 0, st>>>(Pinv, r, z, m, nc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int knp_bj_inverse_f32(const float* P, float* Pinv, int m, int nd, int nc,
                                  void* stream) {
  return bj_inverse_launch<float>(P, Pinv, m, nd, nc, stream);
}

extern "C" int knp_bj_inverse_f64(const double* P, double* Pinv, int m, int nd, int nc,
                                  void* stream) {
  return bj_inverse_launch<double>(P, Pinv, m, nd, nc, stream);
}

extern "C" int knp_bj_apply_f32(const float* Pinv, const float* r, float* z, int m,
                                int nd, int nc, int halves, void* stream) {
  return bj_apply_launch<float>(Pinv, r, z, m, nd, nc, halves, stream);
}

extern "C" int knp_bj_apply_f64(const double* Pinv, const double* r, double* z, int m,
                                int nd, int nc, int halves, void* stream) {
  return bj_apply_launch<double>(Pinv, r, z, m, nd, nc, halves, stream);
}
