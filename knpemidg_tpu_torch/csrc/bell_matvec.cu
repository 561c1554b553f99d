// Kernel A: block-ELL matvec, single and ion-batched, for the 3D (nd = 4,
// K = 5) and the 2D (nd = 3, K = 4) DG1 operators.
//
// Replaces knpemidg_tpu/ops/spmv.py:17 bell_matvec and :37 bell_matvec_multi
// (XLA-lowered einsum + neighbour gather on the TPU):
//
//   y[s,i,c] = sum_k sum_j B[s,k,i,j,c] * x[s,j,nbr[k,c]]
//
// for m systems sharing one neighbour table (m = 1 for EMI, m = 2 for KNP).
//
// Bound: device-memory bandwidth.  Per cell and system the kernel streams
// K*nd*nd block values (640 B in f64 at K = 5, nd = 4) and gathers K-1
// neighbour rows of nd values; the arithmetic is 2*K*nd*nd flops, far below
// the card's flop rate.  At the main path's size (124,416 cells) one thread
// per (system, cell) was a single wave of 486 blocks, each thread a chain of
// K-1 dependent (neighbour index -> gather) loads beside its 80 block loads:
// half the cells took 73% of the time, and coalesced gathers (every slot
// the cell itself) took none off (time_wrappers.py --only k1).  Design:
//   * one thread per (system, row i, cell): a block is 64 cells x nd rows,
//     warp w serving row w % nd of 32 consecutive cells, so every block
//     load of a warp is 32 consecutive addresses of one (k, i, j) plane
//     (coalesced), each thread streams K*nd values, not K*nd*nd, and the
//     EMI launch is four times the threads in about two waves;
//   * K and nd are template parameters (K = 5, nd = 4: the 3D DG1
//     operator; K = 4, nd = 3: the 2D one, triangles, whose block is 64
//     cells x 3 rows, 6 warps): a thread issues its K-1 neighbour indices
//     first, then its nd*K gathers and block loads, so the chain is one
//     index load and one gather deep;
//   * the blocks are read once, with the streaming (evict-first) cache
//     hint, so they do not push x and the neighbour table out of L1 / L2:
//     the four row threads of a cell gather the same x values, in the same
//     block.
// The sum keeps the JAX order and the parent kernel's expression forms
// (whose contractions nvcc makes the same way): the diagonal slot 0 over j
// in order, then slots 1..K-1, each over j in order, accumulated
// separately and added last.  No atomics: every output has one writer.
#include "common.cuh"

#define BELL_CELLS 64     // cells of a block: BELL_CELLS / 32 warps of 32 for each of nd rows
static_assert(KNP_THREADS / (32 * 4) * 32 == BELL_CELLS, "a 3D block is 64 cells x 4 rows");

template <typename T, int K, int ND>
__global__ void __launch_bounds__(KNP_THREADS)
bell_matvec_kernel(const T* __restrict__ B, const int* __restrict__ nbr,
                   const T* __restrict__ x, T* __restrict__ y, int nc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = warp % ND;
  const int c = blockIdx.x * BELL_CELLS + (warp / ND) * 32 + lane;
  if (c >= nc) return;
  const int s = blockIdx.y;
  const size_t n = (size_t)nc;
  const T* xs = x + (size_t)s * ND * n;
  const T* Bi = B + ((size_t)s * K * ND * ND + (size_t)i * ND) * n + c;  // B[s,0,i,0,c]

  int nb[K];
#pragma unroll
  for (int k = 1; k < K; ++k) nb[k] = nbr[(size_t)k * n + c];
  T xv[K][ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) xv[0][j] = xs[j * n + c];
#pragma unroll
  for (int k = 1; k < K; ++k)
#pragma unroll
    for (int j = 0; j < ND; ++j) xv[k][j] = xs[j * n + nb[k]];

  T acc0 = __ldcs(Bi) * xv[0][0];
#pragma unroll
  for (int j = 1; j < ND; ++j) acc0 += __ldcs(Bi + (size_t)j * n) * xv[0][j];
  T acc1 = T(0);
#pragma unroll
  for (int k = 1; k < K; ++k)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc1 += __ldcs(Bi + (size_t)(k * ND * ND + j) * n) * xv[k][j];
  y[((size_t)s * ND + i) * n + c] = acc0 + acc1;
}

template <typename T>
static int bell_matvec_launch(const T* B, const int* nbr, const T* x, T* y,
                              int m, int K, int nd, int nc, void* stream) {
  const dim3 grid((unsigned int)((nc + BELL_CELLS - 1) / BELL_CELLS), (unsigned int)m);
  cudaStream_t st = (cudaStream_t)stream;
  if (nd == 4 && K == 5) {
    bell_matvec_kernel<T, 5, 4><<<grid, KNP_THREADS, 0, st>>>(B, nbr, x, y, nc);
  } else if (nd == 3 && K == 4) {
    bell_matvec_kernel<T, 4, 3><<<grid, BELL_CELLS * 3, 0, st>>>(B, nbr, x, y, nc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int knp_bell_matvec_f32(const float* B, const int* nbr, const float* x,
                                   float* y, int m, int K, int nd, int nc, void* stream) {
  return bell_matvec_launch<float>(B, nbr, x, y, m, K, nd, nc, stream);
}

extern "C" int knp_bell_matvec_f64(const double* B, const int* nbr, const double* x,
                                   double* y, int m, int K, int nd, int nc, void* stream) {
  return bell_matvec_launch<double>(B, nbr, x, y, m, K, nd, nc, stream);
}
