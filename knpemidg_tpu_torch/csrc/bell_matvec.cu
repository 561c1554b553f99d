// Kernel A: block-ELL matvec, single and ion-batched.
//
// Replaces knpemidg_tpu/ops/spmv.py:17 bell_matvec and :37 bell_matvec_multi
// (XLA-lowered einsum + neighbour gather on the TPU):
//
//   y[s,i,c] = sum_k sum_j B[s,k,i,j,c] * x[s,j,nbr[k,c]]
//
// for m systems sharing one neighbour table (m = 1 for EMI, m = 2 for KNP).
//
// Bound: device-memory bandwidth.  Per cell and system the kernel streams
// K*nd*nd block values (320 B in f32 at K = 5, nd = 4) and gathers K-1
// neighbour rows of nd values; the arithmetic is 2*K*nd*nd flops, far below
// the card's flop rate.  Design: one thread per (system, cell) with the
// cells-last layout, so a warp's block loads are 32 consecutive addresses of
// each (k, i, j) plane (fully coalesced); only the x reads are a random
// gather, and Morton-ordered cells keep most neighbours in nearby lines.
// The sum keeps the JAX order: the diagonal slot 0 first, then slots
// 1..K-1 accumulated separately and added last.
#include "common.cuh"

template <typename T, int ND>
__global__ void bell_matvec_kernel(const T* __restrict__ B,
                                   const int* __restrict__ nbr,
                                   const T* __restrict__ x,
                                   T* __restrict__ y, int m, int K, int nc) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * nc) return;
  const int s = (int)(idx / nc);
  const int c = (int)(idx - (long long)s * nc);
  const size_t ncz = (size_t)nc;
  const T* Bs = B + (size_t)s * K * ND * ND * ncz;
  const T* xs = x + (size_t)s * ND * ncz;

  T xv[ND];
  T acc0[ND];
  T acc1[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) xv[j] = xs[j * ncz + c];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    T a = Bs[(size_t)(i * ND) * ncz + c] * xv[0];
#pragma unroll
    for (int j = 1; j < ND; ++j) a += Bs[(size_t)(i * ND + j) * ncz + c] * xv[j];
    acc0[i] = a;
    acc1[i] = T(0);
  }
  for (int k = 1; k < K; ++k) {
    const int nb = nbr[(size_t)k * ncz + c];
#pragma unroll
    for (int j = 0; j < ND; ++j) xv[j] = xs[j * ncz + nb];
    const T* Bk = Bs + (size_t)k * ND * ND * ncz;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
#pragma unroll
      for (int j = 0; j < ND; ++j) acc1[i] += Bk[(size_t)(i * ND + j) * ncz + c] * xv[j];
    }
  }
  T* ys = y + (size_t)s * ND * ncz;
#pragma unroll
  for (int i = 0; i < ND; ++i) ys[i * ncz + c] = acc0[i] + acc1[i];
}

template <typename T>
static int bell_matvec_launch(const T* B, const int* nbr, const T* x, T* y,
                              int m, int K, int nd, int nc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int grid = knp_blocks((long long)m * nc);
  if (nd == 4) {
    bell_matvec_kernel<T, 4><<<grid, KNP_THREADS, 0, st>>>(B, nbr, x, y, m, K, nc);
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
