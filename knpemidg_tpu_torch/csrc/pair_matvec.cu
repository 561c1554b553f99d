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
// Invariant: pe is exactly zero outside each slot's owner half.  External
// slot t of pair p couples one cell of the pair, its owner half
// h = ext_h[t,p], to a cell outside it, so pe[s,t,r,:,p] is zero for every
// row r outside rows h nd .. h nd + nd - 1 (the emit writes
// where(h0, off, 0) and its twin; the static KNP operator added to it has
// the same pattern).  The owner halves reach the kernel as one bit a slot,
// hmask[p] bit t = ext_h[t,p] (S <= 8), and the kernel never reads the
// other half's rows.
//
// Bound: device-memory bandwidth.  Per pair and system the kernel must read
// (2nd)^2 + S nd nd = 160 block values (nd = 4, S = 6; the 96 zero values
// of the other halves are not read), the pair's x column, the gathered
// columns, ext_col and the mask, and write the pair's y column.  At the
// main-path shapes (63,558 pairs) one EMI plus one two-ion KNP application
// moves about 0.14 GB in float32 and 0.27 GB in float64: about 41 / 80 us
// at 3.35 TB/s.  The arithmetic is 2 flops per block value, far below the
// card's rate.
// Design: one thread per (system, half, pair) with pairs fastest (grid.x
// the pairs, grid.y the system and half), holding the half's nd rows: the
// pair's x column is loaded once a thread, and each gathered column once,
// by its owner half only; every block load is a coalesced row of a
// (t, r, j) plane.  The owned slots' gather columns are read first, so the
// gathers wait on no load but the mask's and their own.  Slots run in the
// same order on every pair whose halves have the usual 3 + 3 external
// facets, so a warp skips the other half's rows of a slot together and
// their sectors are never fetched.
// Summation order, each row (the order of the kernel before the owner
// halves were skipped, with its multiply-adds fused as nvcc fused them):
// acc0 = the diagonal product j = 0, then fused multiply-adds j = 1..2nd-1;
// acc1 = fused multiply-adds over the external slots, t then j; y = acc0 +
// acc1.  A skipped term is a multiply-add of a zero block value, which
// leaves acc1 as it was, so y equals that kernel's output bit for bit.
#include "common.cuh"

#define KNP_MAXS 8        // external slots: one bit each in the owner-half mask

template <typename T, int ND>
__global__ void pair_matvec_kernel(const T* __restrict__ pd, const T* __restrict__ pe,
                                   const int* __restrict__ ext_col,
                                   const unsigned char* __restrict__ hmask,
                                   const T* __restrict__ x, T* __restrict__ y, int S,
                                   int npair) {
  constexpr int ND2 = 2 * ND;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npair) return;
  const int h = blockIdx.y & 1, s = blockIdx.y >> 1;     // grid.y = system * 2 + half
  const size_t np = (size_t)npair;

  // the gather columns of the slots this half owns, read before the rows
  const unsigned int bits = hmask[p];
  int cols[KNP_MAXS];
#pragma unroll
  for (int t = 0; t < KNP_MAXS; ++t)
    cols[t] = t < S && (int)((bits >> t) & 1u) == h ? ext_col[(size_t)t * np + p] : -1;

  const T* xs = x + (size_t)s * ND2 * np;
  T xo[ND2];
#pragma unroll
  for (int j = 0; j < ND2; ++j) xo[j] = xs[(size_t)j * np + p];

  T acc0[ND], acc1[ND];
  const T* pds = pd + ((size_t)s * ND2 + h * ND) * ND2 * np + p;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const T* row = pds + (size_t)i * ND2 * np;
    T a = row[0] * xo[0];
#pragma unroll
    for (int j = 1; j < ND2; ++j) a = fma(row[(size_t)j * np], xo[j], a);
    acc0[i] = a;
    acc1[i] = T(0);
  }

  const T* pes = pe + ((size_t)s * S * ND2 + h * ND) * ND * np + p;
#pragma unroll
  for (int t = 0; t < KNP_MAXS; ++t) {
    const int col = cols[t];
    if (col < 0) continue;
    const int hc = col >= npair;
    const T* xc = xs + (size_t)hc * ND * np + (col - hc * npair);
    T xe[ND];
#pragma unroll
    for (int j = 0; j < ND; ++j) xe[j] = xc[(size_t)j * np];
    const T* blk = pes + (size_t)t * ND2 * ND * np;
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int j = 0; j < ND; ++j)
        acc1[i] = fma(blk[((size_t)i * ND + j) * np], xe[j], acc1[i]);
  }
  T* ys = y + ((size_t)s * ND2 + h * ND) * np + p;
#pragma unroll
  for (int i = 0; i < ND; ++i) ys[(size_t)i * np] = acc0[i] + acc1[i];
}

template <typename T>
static int pair_matvec_launch(const T* pd, const T* pe, const int* ext_col,
                              const unsigned char* hmask, const T* x, T* y, int m, int nd,
                              int S, int npair, void* stream) {
  if (S > KNP_MAXS || 2 * m > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(knp_blocks(npair), 2 * m);
  cudaStream_t st = (cudaStream_t)stream;
  switch (nd) {
#define KNP_PAIR_MV_CASE(N)                                                              \
  case N:                                                                                \
    pair_matvec_kernel<T, N><<<grid, KNP_THREADS, 0, st>>>(pd, pe, ext_col, hmask, x, y, \
                                                           S, npair);                   \
    break;
    KNP_PAIR_MV_CASE(1)
    KNP_PAIR_MV_CASE(2)
    KNP_PAIR_MV_CASE(3)
    KNP_PAIR_MV_CASE(4)
#undef KNP_PAIR_MV_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int knp_pair_matvec_f32(const float* pd, const float* pe, const int* ext_col,
                                   const unsigned char* hmask, const float* x, float* y,
                                   int m, int nd, int S, int npair, void* stream) {
  return pair_matvec_launch<float>(pd, pe, ext_col, hmask, x, y, m, nd, S, npair, stream);
}

extern "C" int knp_pair_matvec_f64(const double* pd, const double* pe, const int* ext_col,
                                   const unsigned char* hmask, const double* x, double* y,
                                   int m, int nd, int S, int npair, void* stream) {
  return pair_matvec_launch<double>(pd, pe, ext_col, hmask, x, y, m, nd, S, npair, stream);
}
