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
// repeat from call to call.  The two dot entries are one launch each: the
// block that finishes last (an int32 ticket, the only atomic) sums the
// partials and writes the scalars, so the finish pass costs no second launch
// and no dependency gap.  The projection is a second kernel in
// which every block sums the update's partials itself (the same sum in the
// same order in every block) and projects its own chunk.  The source
// compiles with -fmad=false, so the updates round as the plain versions do.
#include <cuda/atomic>

#include "common.cuh"

enum { PCG_RZ = 0, PCG_ZZ, PCG_ALPHA, PCG_BETA, PCG_TOL2, PCG_WSUM };

// entries a thread of the dot kernel sums (RED_CHUNK = 2048 of
// ops/krylov_ops.py is PCG_PER x KNP_THREADS)
#define PCG_PER 8

// NV = 1: alpha = rz / (a . b).  NV = 2: rz' = a . b, zz = b . b,
// beta = rz' / rz, rz = rz', *flag = zz > tol^2.
//
// Block q sums chunk q into partial[q NV + v]: thread t adds its entries
// lo + t + 256 k, k = 0..7, in order, then the block tree.  All of a
// thread's loads are issued before its first add (the adds keep their
// order, so the sum is the same; the loads' latency is paid once, not
// eight times).  Thread 0 then publishes the partials with a release
// ticket (an int32 atomic, the only one); the block that draws nblk - 1
// has acquired every partial, sums them in index order (thread t takes
// partials t + 256 k, then the block tree), writes the scalars and resets
// the ticket for the next launch on the stream.  Both sums are in the order
// of a partial pass followed by a one-block finish pass.
template <typename T, int NV>
__global__ void __launch_bounds__(KNP_THREADS)
    pcg_dot_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ partial,
                   int* __restrict__ ticket, T* __restrict__ sc, int* __restrict__ flag,
                   long long n) {
  __shared__ T red[KNP_WARPS];
  __shared__ bool last;
  const int nblk = gridDim.x;
  // the scalars the finishing block reads, loaded while the chunk streams in
  T rz = T(0), tol2 = T(0);
  if (threadIdx.x == 0) {
    rz = sc[PCG_RZ];
    if (NV == 2) tol2 = sc[PCG_TOL2];
  }
  const long long lo = (long long)blockIdx.x * (PCG_PER * KNP_THREADS) + threadIdx.x;
  T va[PCG_PER], vb[PCG_PER];
#pragma unroll
  for (int k = 0; k < PCG_PER; ++k) {
    const long long i = lo + (long long)k * KNP_THREADS;
    va[k] = i < n ? a[i] : T(0);
    vb[k] = i < n ? b[i] : T(0);
  }
  T acc0 = T(0), acc1 = T(0);
#pragma unroll
  for (int k = 0; k < PCG_PER; ++k) {
    if (lo + (long long)k * KNP_THREADS < n) {
      acc0 += va[k] * vb[k];
      if (NV == 2) acc1 += vb[k] * vb[k];
    }
  }
  acc0 = knp_block_sum(acc0, red);
  if (NV == 2) acc1 = knp_block_sum(acc1, red);
  if (threadIdx.x == 0) {
    partial[(long long)blockIdx.x * NV] = acc0;
    if (NV == 2) partial[(long long)blockIdx.x * NV + 1] = acc1;
    cuda::atomic_ref<int, cuda::thread_scope_device> done(*ticket);
    last = done.fetch_add(1, cuda::memory_order_acq_rel) == nblk - 1;
  }
  __syncthreads();
  if (!last) return;
  // volatile: read where the other blocks wrote (no L1 copy), and not
  // moved above the barrier
  const volatile T* part = partial;
  T s0 = T(0), s1 = T(0);
  for (int q = threadIdx.x; q < nblk; q += blockDim.x) {
    s0 += part[(long long)q * NV];
    if (NV == 2) s1 += part[(long long)q * NV + 1];
  }
  s0 = knp_block_sum(s0, red);
  if (NV == 2) s1 = knp_block_sum(s1, red);
  if (threadIdx.x != 0) return;
  if (NV == 1) {
    sc[PCG_ALPHA] = rz / s0;
  } else {
    sc[PCG_BETA] = s0 / rz;
    sc[PCG_RZ] = s0;
    sc[PCG_ZZ] = s1;
    *flag = s1 > tol2;
  }
  *ticket = 0;
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

// One launch of the dot kernel over n entries; the ticket must be 0
template <typename T, int NV>
static int pcg_dot_launch(const T* a, const T* b, T* partial, int* ticket, T* sc, int* flag,
                          int n, int chunk, void* stream) {
  if (chunk != PCG_PER * KNP_THREADS || n < 1) return (int)cudaErrorInvalidValue;
  pcg_dot_kernel<T, NV><<<knp_chunks(n, chunk), KNP_THREADS, 0, (cudaStream_t)stream>>>(
      a, b, partial, ticket, sc, flag, n);
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
static int pcg_direction_launch(T* p, const T* z, const T* sc, int n, void* stream) {
  pcg_direction_kernel<T><<<knp_blocks(n), KNP_THREADS, 0, (cudaStream_t)stream>>>(p, z, sc, n);
  return (int)cudaGetLastError();
}

#define PCG_ENTRIES(T, SFX)                                                                  \
  extern "C" int knp_pcg_dot_##SFX(const T* p, const T* Ap, T* partial, int* ticket, T* sc, \
                                   int n, int chunk, void* stream) {                         \
    return pcg_dot_launch<T, 1>(p, Ap, partial, ticket, sc, nullptr, n, chunk, stream);      \
  }                                                                                          \
  extern "C" int knp_pcg_update_##SFX(T* x, T* r, const T* p, const T* Ap, const T* sc,     \
                                      const T* w, T* partial, int n, int chunk, int mode,    \
                                      void* stream) {                                        \
    return pcg_update_launch<T>(x, r, p, Ap, sc, w, partial, n, chunk, mode, stream);        \
  }                                                                                          \
  extern "C" int knp_pcg_dot2_##SFX(const T* r, const T* z, T* partial, int* ticket, T* sc, \
                                    int* flag, int n, int chunk, void* stream) {             \
    return pcg_dot_launch<T, 2>(r, z, partial, ticket, sc, flag, n, chunk, stream);           \
  }                                                                                          \
  extern "C" int knp_pcg_direction_##SFX(T* p, const T* z, const T* sc, int n,              \
                                         void* stream) {                                     \
    return pcg_direction_launch<T>(p, z, sc, n, stream);                                     \
  }

PCG_ENTRIES(float, f32)
PCG_ENTRIES(double, f64)
