// Kernel K8: the vector work of one preconditioned-CG iteration, with the
// iteration's scalars kept on the device.
//
// Replaces the loop body of knpemidg_tpu/solvers/krylov.py:39 pcg
// (:101-111), which XLA runs as two dots, two axpys, two nullspace
// projections (a mean, or a masked mean on the pair layout), two more dots
// and the direction update around the matvec and the preconditioner apply.
// The scalars live in sc = [rz, zz, alpha, beta, tol^2, wsum]:
//
//   dot        alpha = rz / (p . Ap)
//   update     x += alpha p, r -= alpha Ap, then (mode 1) v -= sum(v) / wsum
//              or (mode 2) v = (v - sum(w v) / wsum) w for v = x, r
//              (wsum = the entry count in mode 1, sum of the mask in mode 2)
//   dot2       rz' = r . z, zz = z . z, beta = rz' / rz, rz = rz', and the
//              flag zz > tol^2 (the while-loop test the host reads)
//   direction  p = z + beta p
//
// Bound: device-memory bandwidth (a few flops per 8 bytes).  Every sum is
// per-block partials over fixed chunks, block trees, then the chunks in
// index order: no floating-point atomics, so results and iteration counts
// repeat from call to call.  The projection is a second kernel in which
// every block sums the update's partials itself (the same sum in the same
// order in every block) and projects its own chunk.  The source compiles
// with -fmad=false, so the updates round as the plain versions do.
#include "common.cuh"

enum { PCG_RZ = 0, PCG_ZZ, PCG_ALPHA, PCG_BETA, PCG_TOL2, PCG_WSUM };

// partial[b NV + v] = sum over chunk b of a_v . b_v, for NV = 1 or 2 products
template <typename T, int NV>
__global__ void pcg_dot_partial_kernel(const T* __restrict__ a0, const T* __restrict__ b0,
                                       const T* __restrict__ a1, const T* __restrict__ b1,
                                       T* __restrict__ partial, long long n, int chunk) {
  __shared__ T red[KNP_WARPS];
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  T acc0 = T(0), acc1 = T(0);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    acc0 += a0[i] * b0[i];
    if (NV == 2) acc1 += a1[i] * b1[i];
  }
  acc0 = knp_block_sum(acc0, red);
  if (NV == 2) acc1 = knp_block_sum(acc1, red);
  if (threadIdx.x == 0) {
    partial[(long long)blockIdx.x * NV] = acc0;
    if (NV == 2) partial[(long long)blockIdx.x * NV + 1] = acc1;
  }
}

// One block: the partial sums in index order, then the scalar update.
// which 0: alpha = rz / sum.  which 1: rz', zz, beta, rz, flag.
template <typename T>
__global__ void pcg_finish_kernel(const T* __restrict__ partial, int nblk, T* __restrict__ sc,
                                  int* __restrict__ flag, int which) {
  __shared__ T red[KNP_WARPS];
  const int nv = which == 0 ? 1 : 2;
  T a = T(0), b = T(0);
  for (int q = threadIdx.x; q < nblk; q += blockDim.x) {
    a += partial[(long long)q * nv];
    if (which) b += partial[(long long)q * nv + 1];
  }
  a = knp_block_sum(a, red);
  if (which) b = knp_block_sum(b, red);
  if (threadIdx.x != 0) return;
  if (which == 0) {
    sc[PCG_ALPHA] = sc[PCG_RZ] / a;
  } else {
    sc[PCG_BETA] = a / sc[PCG_RZ];
    sc[PCG_RZ] = a;
    sc[PCG_ZZ] = b;
    *flag = b > sc[PCG_TOL2];
  }
}

// x += alpha p, r -= alpha Ap over chunk b, and (mode > 0) the partials of
// sum w x and sum w r (w = 1 in mode 1)
template <typename T>
__global__ void pcg_update_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
                                  const T* __restrict__ Ap, const T* __restrict__ sc,
                                  const T* __restrict__ w, T* __restrict__ partial, long long n,
                                  int chunk, int mode) {
  __shared__ T red[KNP_WARPS];
  const T alpha = sc[PCG_ALPHA];
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  T sx = T(0), sr = T(0);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const T xn = x[i] + alpha * p[i];
    const T rn = r[i] - alpha * Ap[i];
    x[i] = xn;
    r[i] = rn;
    if (mode == 1) {
      sx += xn;
      sr += rn;
    } else if (mode == 2) {
      sx += xn * w[i];
      sr += rn * w[i];
    }
  }
  if (mode == 0) return;
  sx = knp_block_sum(sx, red);
  sr = knp_block_sum(sr, red);
  if (threadIdx.x == 0) {
    partial[2 * (long long)blockIdx.x] = sx;
    partial[2 * (long long)blockIdx.x + 1] = sr;
  }
}

// The projection of x and r over chunk b; every block sums all partials
template <typename T>
__global__ void pcg_project_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ w,
                                   const T* __restrict__ partial, const T* __restrict__ sc,
                                   long long n, int chunk, int mode) {
  __shared__ T red[KNP_WARPS];
  const int nblk = gridDim.x;
  T sx = T(0), sr = T(0);
  for (int q = threadIdx.x; q < nblk; q += blockDim.x) {
    sx += partial[2 * (long long)q];
    sr += partial[2 * (long long)q + 1];
  }
  sx = knp_block_sum(sx, red);
  sr = knp_block_sum(sr, red);
  const T mx = sx / sc[PCG_WSUM], mr = sr / sc[PCG_WSUM];
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    if (mode == 1) {
      x[i] = x[i] - mx;
      r[i] = r[i] - mr;
    } else {
      x[i] = (x[i] - mx) * w[i];
      r[i] = (r[i] - mr) * w[i];
    }
  }
}

// p = z + beta p
template <typename T>
__global__ void pcg_direction_kernel(T* __restrict__ p, const T* __restrict__ z,
                                     const T* __restrict__ sc, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  p[i] = z[i] + sc[PCG_BETA] * p[i];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
static int pcg_dot_launch(const T* p, const T* Ap, T* partial, T* sc, int n, int chunk,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int nblk = knp_chunks(n, chunk);
  pcg_dot_partial_kernel<T, 1><<<nblk, KNP_THREADS, 0, st>>>(p, Ap, nullptr, nullptr, partial,
                                                             n, chunk);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  pcg_finish_kernel<T><<<1, KNP_THREADS, 0, st>>>(partial, nblk, sc, nullptr, 0);
  return (int)cudaGetLastError();
}

template <typename T>
static int pcg_update_launch(T* x, T* r, const T* p, const T* Ap, const T* sc, const T* w,
                             T* partial, int n, int chunk, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 1 || mode < 0 || mode > 2 || (mode == 2 && w == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nblk = knp_chunks(n, chunk);
  pcg_update_kernel<T><<<nblk, KNP_THREADS, 0, st>>>(x, r, p, Ap, sc, w, partial, n, chunk,
                                                     mode);
  int err = (int)cudaGetLastError();
  if (err != 0 || mode == 0) return err;
  pcg_project_kernel<T><<<nblk, KNP_THREADS, 0, st>>>(x, r, w, partial, sc, n, chunk, mode);
  return (int)cudaGetLastError();
}

template <typename T>
static int pcg_dot2_launch(const T* r, const T* z, T* partial, T* sc, int* flag, int n,
                           int chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int nblk = knp_chunks(n, chunk);
  pcg_dot_partial_kernel<T, 2><<<nblk, KNP_THREADS, 0, st>>>(r, z, z, z, partial, n, chunk);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  pcg_finish_kernel<T><<<1, KNP_THREADS, 0, st>>>(partial, nblk, sc, flag, 1);
  return (int)cudaGetLastError();
}

template <typename T>
static int pcg_direction_launch(T* p, const T* z, const T* sc, int n, void* stream) {
  pcg_direction_kernel<T><<<knp_blocks(n), KNP_THREADS, 0, (cudaStream_t)stream>>>(p, z, sc, n);
  return (int)cudaGetLastError();
}

#define PCG_ENTRIES(T, SFX)                                                                  \
  extern "C" int knp_pcg_dot_##SFX(const T* p, const T* Ap, T* partial, T* sc, int n,       \
                                   int chunk, void* stream) {                                \
    return pcg_dot_launch<T>(p, Ap, partial, sc, n, chunk, stream);                          \
  }                                                                                          \
  extern "C" int knp_pcg_update_##SFX(T* x, T* r, const T* p, const T* Ap, const T* sc,     \
                                      const T* w, T* partial, int n, int chunk, int mode,    \
                                      void* stream) {                                        \
    return pcg_update_launch<T>(x, r, p, Ap, sc, w, partial, n, chunk, mode, stream);        \
  }                                                                                          \
  extern "C" int knp_pcg_dot2_##SFX(const T* r, const T* z, T* partial, T* sc, int* flag,   \
                                    int n, int chunk, void* stream) {                        \
    return pcg_dot2_launch<T>(r, z, partial, sc, flag, n, chunk, stream);                    \
  }                                                                                          \
  extern "C" int knp_pcg_direction_##SFX(T* p, const T* z, const T* sc, int n,              \
                                         void* stream) {                                     \
    return pcg_direction_launch<T>(p, z, sc, n, stream);                                     \
  }

PCG_ENTRIES(float, f32)
PCG_ENTRIES(double, f64)
