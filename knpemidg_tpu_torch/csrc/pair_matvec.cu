// Kernel K3: pair-block matvec, single and ion-batched.
//
// Replaces knpemidg_tpu/ops/pairs.py:344 pair_matvec and :354
// pair_matvec_multi (XLA einsum plus one external gather on the TPU):
//
//   y[s,r,p] = sum_j pd[s,r,j,p] x[s,j,p]
//            + sum_t sum_j pe[s,t,r,j,p] xv[s,j,ext_col[t,p]]
//
// for m systems sharing one gather table (m = 1 for EMI, m = 2 for KNP),
// where xv[s,j,c] = x[s, (c / npair) nd + j, c % npair] is the halves view
// of x, read in place (no concatenated copy).
//
// Bound: device-memory bandwidth.  Per pair and system the kernel streams
// (2nd)^2 + S 2nd nd = 256 block values (nd = 4, S = 6); half of each
// external slot is structural zero (the other half's rows), read as the JAX
// function reads it.  At the main-path shapes (63,558 pairs), one EMI plus
// one two-ion KNP application moves 0.21 GB in float32 and 0.42 GB in
// float64 (blocks, vectors, ext_col): 62 / 124 us at 3.35 TB/s.
// The arithmetic is 2 flops per block value, far below the card's rate.
// Design: one thread per (system, row, pair) with pairs fastest, so every
// block load is a coalesced row of a (t, r, j) plane; the gathered columns
// of x are read by the 2nd row threads of a pair and meet in L1/L2.  The
// sum keeps the JAX order: the diagonal term, then the external slots in a
// second accumulator, added last.
#include "common.cuh"

template <typename T>
__global__ void pair_matvec_kernel(const T* __restrict__ pd, const T* __restrict__ pe,
                                   const int* __restrict__ ext_col,
                                   const T* __restrict__ x, T* __restrict__ y,
                                   int m, int nd, int S, int npair) {
  const int nd2 = 2 * nd;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * nd2 * npair) return;
  const int p = (int)(idx % npair);
  const long long sr = idx / npair;
  const int r = (int)(sr % nd2);
  const int s = (int)(sr / nd2);
  const size_t np = (size_t)npair;

  const T* xs = x + (size_t)s * nd2 * np;
  const T* row = pd + ((size_t)s * nd2 + r) * nd2 * np + p;
  T acc0 = row[0] * xs[p];
  for (int j = 1; j < nd2; ++j) acc0 += row[(size_t)j * np] * xs[(size_t)j * np + p];

  T acc1 = T(0);
  const T* pes = pe + (size_t)s * S * nd2 * nd * np;
  for (int t = 0; t < S; ++t) {
    const int col = ext_col[(size_t)t * np + p];
    const int h = col / npair;
    const T* xc = xs + (size_t)h * nd * np + (col - h * npair);
    const T* blk = pes + ((size_t)t * nd2 + r) * nd * np + p;
    for (int j = 0; j < nd; ++j) acc1 += blk[(size_t)j * np] * xc[(size_t)j * np];
  }
  y[((size_t)s * nd2 + r) * np + p] = acc0 + acc1;
}

template <typename T>
static int pair_matvec_launch(const T* pd, const T* pe, const int* ext_col, const T* x,
                              T* y, int m, int nd, int S, int npair, void* stream) {
  const unsigned int grid = knp_blocks((long long)m * 2 * nd * npair);
  pair_matvec_kernel<T><<<grid, KNP_THREADS, 0, (cudaStream_t)stream>>>(
      pd, pe, ext_col, x, y, m, nd, S, npair);
  return (int)cudaGetLastError();
}

extern "C" int knp_pair_matvec_f32(const float* pd, const float* pe, const int* ext_col,
                                   const float* x, float* y, int m, int nd, int S,
                                   int npair, void* stream) {
  return pair_matvec_launch<float>(pd, pe, ext_col, x, y, m, nd, S, npair, stream);
}

extern "C" int knp_pair_matvec_f64(const double* pd, const double* pe, const int* ext_col,
                                   const double* x, double* y, int m, int nd, int S,
                                   int npair, void* stream) {
  return pair_matvec_launch<double>(pd, pe, ext_col, x, y, m, nd, S, npair, stream);
}
