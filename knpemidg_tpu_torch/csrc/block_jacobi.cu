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
// and two KNP systems) the halves-form inverses move 0.049 / 0.098 GB (the
// full form twice that) and the halves-form applies 0.037 / 0.073 GB in
// float32 / float64 (15 / 29 us and 11 / 22 us at 3.35 TB/s).  Design: one
// thread per (system, block) holds its whole block in registers, with
// cells-last coalesced loads and stores.  The inverse is
// the JAX package's unpivoted Gauss-Jordan in the same elimination order,
// done in place: the inverse's column k is stored where A's column k dies
// at step k, which gives the augmented [A | I] scheme's values operation for
// operation with half its registers (64 doubles at nd = 8 instead of 128).
// The DG diagonal blocks are mass-regularised SPD, so the pivots stay
// positive.  The input is read in place: its systems may lie any number of
// elements apart (the cell layout's KNP solve inverts slot 0 of its
// (m, K, nd, nd, nc) operator without copying it out).
//
// The inverse's halves form (pair_bj = 'halves', the pair layout's main
// path): the JAX function inverts the pair diagonal times the halves mask,
// whose eliminations across the halves multiply by exact zeros (each
// cross-half factor f is +-0, and x - (+-0) y = x for x != 0), so each half
// of its inverse equals the 4 x 4 elimination of that half's diagonal
// sub-block, up to the sign of an exact zero, and its off-diagonal blocks
// are zeros.  A thread per (system, half, pair) reads the unmasked
// diagonal's 4 x 4 sub-block, runs the same elimination (the same
// expressions, so nvcc contracts them alike) and writes that sub-block:
// 256 of the full form's 1,024 bytes a pair and system in float64, an
// eighth of its operations, and no masked copy of the diagonal.  The
// output's off-diagonal blocks are zeroed once by the caller (the step's
// buffer) and never written.
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
//
// The cell layout's two-level applies (nd = 4) do not launch the apply: its
// arithmetic (bj_block_apply, common.cuh) runs inside K6's prolong-add and
// K7's one-launch apply (two_level.cu), which write z + the coarse part
// without z's round trip through memory.  The apply's own launch stays for
// the block-Jacobi-only preconditioner, nd = 3 and the pair layout.
#include "common.cuh"

// The unpivoted Gauss-Jordan inverse of one N x N block held in registers,
// in place, in the JAX function's elimination order (K5's full form at N = nd,
// its halves form at N = 4 on each half of an 8 x 8 pair block).
template <typename T, int N>
__device__ __forceinline__ void bj_gauss_jordan(T (&A)[N][N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T piv = T(1) / A[k][k];
    // row k: A's columns j != k scale, column k takes I[k][k] * piv = piv
#pragma unroll
    for (int j = 0; j < N; ++j) A[k][j] = (j == k) ? piv : A[k][j] * piv;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == k) continue;
      const T f = A[i][k];
      A[i][k] = T(0);                  // I[i][k] before step k
#pragma unroll
      for (int j = 0; j < N; ++j) A[i][j] = A[i][j] - f * A[k][j];
    }
  }
}

// full form: a thread per (system, block).  The input's systems lie
// ``sys`` elements apart (the KNP operator's slot 0 read in place: K nd^2 nc),
// each system cells-last and contiguous; the output is contiguous.
template <typename T, int ND>
__global__ void bj_inverse_kernel(const T* __restrict__ P, T* __restrict__ Pinv,
                                  int m, int nc, long long sys) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * nc) return;
  const int s = (int)(idx / nc);
  const int c = (int)(idx - (long long)s * nc);
  const size_t ncz = (size_t)nc;
  const T* Ps = P + (size_t)s * sys;

  T A[ND][ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
#pragma unroll
    for (int j = 0; j < ND; ++j) A[i][j] = Ps[(size_t)(i * ND + j) * ncz + c];
  }
  bj_gauss_jordan<T, ND>(A);
  T* Os = Pinv + (size_t)s * ND * ND * ncz;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
#pragma unroll
    for (int j = 0; j < ND; ++j) Os[(size_t)(i * ND + j) * ncz + c] = A[i][j];
  }
}

// halves form: a thread per (system, half, pair), the half blockIdx.y; it
// reads that half's 4 x 4 diagonal sub-block of the unmasked 8 x 8 pair
// diagonal and writes the same sub-block of the output, whose two
// off-diagonal 4 x 4 blocks it never writes (the caller's buffer holds
// zeros there)
template <typename T>
__global__ void bj_inverse_halves_kernel(const T* __restrict__ P, T* __restrict__ Pinv,
                                         int m, int nc, long long sys) {
  constexpr int ND = 8, NH = 4;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * nc) return;
  const int s = (int)(idx / nc);
  const int c = (int)(idx - (long long)s * nc);
  const size_t ncz = (size_t)nc;
  const size_t o = (size_t)(blockIdx.y * NH) * (ND + 1) * ncz + c;   // element (4H, 4H)
  const T* Ps = P + (size_t)s * sys + o;

  T A[NH][NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int j = 0; j < NH; ++j) A[i][j] = Ps[(size_t)(i * ND + j) * ncz];
  }
  bj_gauss_jordan<T, NH>(A);
  T* Os = Pinv + (size_t)s * ND * ND * ncz + o;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int j = 0; j < NH; ++j) Os[(size_t)(i * ND + j) * ncz] = A[i][j];
  }
}

template <typename T, int ND>
__device__ __forceinline__ void bj_apply_full(const T* __restrict__ Ps, const T* __restrict__ rs,
                                              T* __restrict__ zs, int c, size_t ncz) {
  T z[ND];
  bj_block_apply<T, ND>(Ps, rs, z, c, ncz);
#pragma unroll
  for (int i = 0; i < ND; ++i) zs[i * ncz + c] = z[i];
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
static int bj_inverse_launch(const T* P, T* Pinv, int m, int nd, int nc, long long sys,
                             int halves, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int grid = knp_blocks((long long)m * nc);
  if (halves) {
    if (nd != 8) return (int)cudaErrorInvalidValue;
    bj_inverse_halves_kernel<T><<<dim3(grid, 2), KNP_THREADS, 0, st>>>(P, Pinv, m, nc, sys);
  } else if (nd == 3) {
    bj_inverse_kernel<T, 3><<<grid, KNP_THREADS, 0, st>>>(P, Pinv, m, nc, sys);
  } else if (nd == 4) {
    bj_inverse_kernel<T, 4><<<grid, KNP_THREADS, 0, st>>>(P, Pinv, m, nc, sys);
  } else if (nd == 8) {
    bj_inverse_kernel<T, 8><<<grid, KNP_THREADS, 0, st>>>(P, Pinv, m, nc, sys);
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
                                  long long sys, int halves, void* stream) {
  return bj_inverse_launch<float>(P, Pinv, m, nd, nc, sys, halves, stream);
}

extern "C" int knp_bj_inverse_f64(const double* P, double* Pinv, int m, int nd, int nc,
                                  long long sys, int halves, void* stream) {
  return bj_inverse_launch<double>(P, Pinv, m, nd, nc, sys, halves, stream);
}

extern "C" int knp_bj_apply_f32(const float* Pinv, const float* r, float* z, int m,
                                int nd, int nc, int halves, void* stream) {
  return bj_apply_launch<float>(Pinv, r, z, m, nd, nc, halves, stream);
}

extern "C" int knp_bj_apply_f64(const double* Pinv, const double* r, double* z, int m,
                                int nd, int nc, int halves, void* stream) {
  return bj_apply_launch<double>(Pinv, r, z, m, nd, nc, halves, stream);
}
