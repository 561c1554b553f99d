// Kernel K8: the vector work of one preconditioned-CG iteration, with the
// iteration's scalars, its count and its exit test kept on the device.
//
// Replaces the loop body of knpemidg_tpu/solvers/krylov.py:39 pcg
// (:101-111), which XLA runs as two dots, two axpys, two nullspace
// projections (a mean, or a masked mean on the pair layout), two more dots
// and the direction update around the matvec and the preconditioner apply,
// and the test of its lax.while_loop (:97-99, :113).  The scalars live in
// sc = [rz, zz, alpha, beta, tol^2, wsum]:
//
//   dot             alpha = rz / (p . Ap)
//   update          x += alpha p, r -= alpha Ap, then (mode 1) v -= sum(v) / wsum
//                   or (mode 2) v = (v - sum(w v) / wsum) w for v = x, r
//                   (wsum = the entry count in mode 1, sum of the mask in mode 2)
//   dot2_direction  rz' = r . z, zz = z . z, beta = rz' / rz, rz = rz', the
//                   count k += 1, the flag zz > tol^2 and k < max_it (the
//                   while-loop's test), then p = z + beta p
//
// Every entry reads the flag first and, where it is 0, returns without a
// write: an iteration queued after the loop's exit leaves x, r, p, sc, the
// count, the partials and the ticket as they are.  So the host may queue
// iteration j before it reads the flag of iteration j - 1.
//
// Bound: device-memory bandwidth (a few flops per 8 bytes).  Every sum is
// per-block partials over fixed chunks of PCG_CHUNK entries, block trees,
// then the chunks in index order: no floating-point atomics, so results and
// iteration counts repeat from call to call.  The dot entry is one launch:
// the block that finishes last (an int32 ticket, the only atomic) sums the
// partials and writes alpha, so the finish pass costs no second launch and
// no dependency gap.  update and dot2_direction are one cooperative launch
// each on the co-resident grid (block b taking chunks b, b + gridDim.x,
// ...): the blocks write their partials, meet at a grid barrier, each sums
// all partials itself (the same sum in the same order in every block, so
// the means and beta are the same bits everywhere) and finishes its own
// chunks, those of its first chunk from the registers they were loaded
// into before the barrier.  Where one grid covers the chunks (the main
// path's EMI vectors) the update thus reads x, r, p, Ap (and w) once and
// writes x and r once; the chunks past a block's first are written before
// the barrier and read again after it.  The source compiles with
// -fmad=false, so the updates round as the plain versions do.
#include <cooperative_groups.h>
#include <cuda/atomic>

#include "common.cuh"

enum { PCG_RZ = 0, PCG_ZZ, PCG_ALPHA, PCG_BETA, PCG_TOL2, PCG_WSUM };

// entries a thread of the dot kernels sums; a chunk is one block's share
// (RED_CHUNK = 2048 of ops/krylov_ops.py)
#define PCG_PER 8
#define PCG_CHUNK (PCG_PER * KNP_THREADS)

// The block sums of a . b (and, NV = 2, b . b) over the chunk whose first
// entry is lo - threadIdx.x: thread t adds its entries lo + 256 k, k = 0..7,
// in order, then the block tree; every thread gets the sums.  All of a
// thread's loads are issued before its first add (the adds keep their
// order, so the sum is the same; the loads' latency is paid once, not eight
// times).  vb keeps the thread's entries of b (zero beyond n).
template <typename T, int NV>
__device__ __forceinline__ void pcg_chunk_sums(const T* __restrict__ a, const T* __restrict__ b,
                                               long long lo, long long n, T (&vb)[PCG_PER],
                                               T* red, T& s0, T& s1) {
  T va[PCG_PER];
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
  s0 = knp_block_sum(acc0, red);
  if (NV == 2) s1 = knp_block_sum(acc1, red);
}

// The sums of the nchunk partials part[q NV + v] in index order, as one
// block forms them: thread t takes partials t + 256 k, then the block tree.
// volatile: read where the other blocks wrote (no L1 copy), and not moved
// above the barrier that made them visible.
template <typename T, int NV>
__device__ __forceinline__ void pcg_finish_sums(const volatile T* part, int nchunk, T* red,
                                                T& s0, T& s1) {
  T a0 = T(0), a1 = T(0);
  for (int q = threadIdx.x; q < nchunk; q += blockDim.x) {
    a0 += part[(long long)q * NV];
    if (NV == 2) a1 += part[(long long)q * NV + 1];
  }
  s0 = knp_block_sum(a0, red);
  if (NV == 2) s1 = knp_block_sum(a1, red);
}

// alpha = rz / (p . Ap).  Block q sums chunk q into partial[q]; thread 0
// publishes it with a release ticket (an int32 atomic, the only one); the
// block that draws nblk - 1 has acquired every partial, sums them in index
// order, writes alpha and resets the ticket for the next launch on the
// stream.  A frozen launch (flag 0) writes nothing.
template <typename T>
__global__ void __launch_bounds__(KNP_THREADS)
    pcg_dot_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ partial,
                   int* __restrict__ ticket, T* __restrict__ sc, const int* __restrict__ flag,
                   long long n) {
  __shared__ T red[KNP_WARPS];
  __shared__ bool last;
  if (*flag == 0) return;
  const int nblk = gridDim.x;
  // the scalar the finishing block reads, loaded while the chunk streams in
  const T rz = threadIdx.x == 0 ? sc[PCG_RZ] : T(0);
  T vb[PCG_PER], s0, s1;
  pcg_chunk_sums<T, 1>(a, b, (long long)blockIdx.x * PCG_CHUNK + threadIdx.x, n, vb, red, s0,
                       s1);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s0;
    cuda::atomic_ref<int, cuda::thread_scope_device> done(*ticket);
    last = done.fetch_add(1, cuda::memory_order_acq_rel) == nblk - 1;
  }
  __syncthreads();
  if (!last) return;
  pcg_finish_sums<T, 1>(partial, nblk, red, s0, s1);
  if (threadIdx.x != 0) return;
  sc[PCG_ALPHA] = rz / s0;
  *ticket = 0;
}

// rz' = r . z, zz = z . z, beta = rz' / rz, rz = rz', k += 1,
// *flag = zz > tol^2 && k < max_it, then p = z + beta p; one cooperative
// launch of at most the co-resident blocks, block b taking chunks b,
// b + gridDim.x, ...
//   1. each chunk's block sums into partial[2q], partial[2q + 1], as the
//      dot kernel forms them;
//   2. grid barrier; every block sums the nchunk partials in index order
//      (the dot kernel's finish) and forms beta; block 0 writes the scalars,
//      the count and the flag;
//   3. each block updates p over its chunks, z and p of its first chunk
//      from the registers they were loaded into before the barrier.
// The old rz and the flag are read before the barrier, since block 0
// overwrites them after it; every block reads the same flag, so a frozen
// launch returns from every block before the barrier.
template <typename T>
__global__ void __launch_bounds__(KNP_THREADS)
    pcg_dot2_direction_kernel(const T* __restrict__ r, const T* __restrict__ z,
                              T* __restrict__ p, T* partial, T* sc, int* flag, int* iters,
                              int max_it, long long n, int nchunk) {
  __shared__ T red[KNP_WARPS];
  if (*flag == 0) return;
  const T rz = sc[PCG_RZ];
  const T tol2 = sc[PCG_TOL2];
  const long long lo = (long long)blockIdx.x * PCG_CHUNK + threadIdx.x;
  T vz[PCG_PER], vp[PCG_PER], s0, s1;
#pragma unroll
  for (int k = 0; k < PCG_PER; ++k) {
    const long long i = lo + (long long)k * KNP_THREADS;
    vp[k] = i < n ? p[i] : T(0);
  }
  pcg_chunk_sums<T, 2>(r, z, lo, n, vz, red, s0, s1);
  if (threadIdx.x == 0) {
    partial[2 * (long long)blockIdx.x] = s0;
    partial[2 * (long long)blockIdx.x + 1] = s1;
  }
  for (int q = blockIdx.x + gridDim.x; q < nchunk; q += gridDim.x) {
    T vb[PCG_PER];
    pcg_chunk_sums<T, 2>(r, z, (long long)q * PCG_CHUNK + threadIdx.x, n, vb, red, s0, s1);
    if (threadIdx.x == 0) {
      partial[2 * (long long)q] = s0;
      partial[2 * (long long)q + 1] = s1;
    }
  }
  cooperative_groups::this_grid().sync();
  pcg_finish_sums<T, 2>(partial, nchunk, red, s0, s1);
  const T beta = s0 / rz;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int k = *iters + 1;
    sc[PCG_BETA] = beta;
    sc[PCG_RZ] = s0;
    sc[PCG_ZZ] = s1;
    *iters = k;
    *flag = s1 > tol2 && k < max_it;
  }
#pragma unroll
  for (int k = 0; k < PCG_PER; ++k) {
    const long long i = lo + (long long)k * KNP_THREADS;
    if (i < n) p[i] = vz[k] + beta * vp[k];
  }
  for (int q = blockIdx.x + gridDim.x; q < nchunk; q += gridDim.x) {
    const long long lq = (long long)q * PCG_CHUNK + threadIdx.x;
#pragma unroll
    for (int k = 0; k < PCG_PER; ++k) {
      const long long i = lq + (long long)k * KNP_THREADS;
      if (i < n) p[i] = z[i] + beta * p[i];
    }
  }
}

// x += alpha p, r -= alpha Ap over the chunk whose first entry is
// lo - threadIdx.x, the thread's entries lo + 256 k kept in vx, vr (and the
// mask's in vw, mode 2); in mode > 0 the block sums of sum w x and sum w r
// (w = 1 in mode 1), each thread adding its entries in order, then the
// block trees (x's first).
template <typename T>
__device__ __forceinline__ void pcg_update_chunk(const T* __restrict__ x, const T* __restrict__ r,
                                                 const T* __restrict__ p,
                                                 const T* __restrict__ Ap,
                                                 const T* __restrict__ w, T alpha, long long lo,
                                                 long long n, int mode, T (&vx)[PCG_PER],
                                                 T (&vr)[PCG_PER], T (&vw)[PCG_PER], T* red,
                                                 T& sx, T& sr) {
  T vp[PCG_PER], va[PCG_PER];
#pragma unroll
  for (int k = 0; k < PCG_PER; ++k) {
    const long long i = lo + (long long)k * KNP_THREADS;
    const bool in = i < n;
    vx[k] = in ? x[i] : T(0);
    vr[k] = in ? r[i] : T(0);
    vp[k] = in ? p[i] : T(0);
    va[k] = in ? Ap[i] : T(0);
    vw[k] = in && mode == 2 ? w[i] : T(1);
  }
  T ax = T(0), ar = T(0);
#pragma unroll
  for (int k = 0; k < PCG_PER; ++k) {
    vx[k] = vx[k] + alpha * vp[k];
    vr[k] = vr[k] - alpha * va[k];
    if (lo + (long long)k * KNP_THREADS < n) {
      if (mode == 1) {
        ax += vx[k];
        ar += vr[k];
      } else if (mode == 2) {
        ax += vx[k] * vw[k];
        ar += vr[k] * vw[k];
      }
    }
  }
  if (mode == 0) return;
  sx = knp_block_sum(ax, red);
  sr = knp_block_sum(ar, red);
}

// The projection of one chunk's updated entries: v - mean (mode 1) or
// (v - mean) w (mode 2), written to x and r
template <typename T>
__device__ __forceinline__ void pcg_project_store(T* __restrict__ x, T* __restrict__ r,
                                                  const T (&vx)[PCG_PER],
                                                  const T (&vr)[PCG_PER],
                                                  const T (&vw)[PCG_PER], T mx, T mr,
                                                  long long lo, long long n, int mode) {
#pragma unroll
  for (int k = 0; k < PCG_PER; ++k) {
    const long long i = lo + (long long)k * KNP_THREADS;
    if (i >= n) continue;
    if (mode == 1) {
      x[i] = vx[k] - mx;
      r[i] = vr[k] - mr;
    } else {
      x[i] = (vx[k] - mx) * vw[k];
      r[i] = (vr[k] - mr) * vw[k];
    }
  }
}

// x += alpha p, r -= alpha Ap and (mode > 0) their projection in one
// cooperative launch of at most the co-resident blocks, block b taking
// chunks b, b + gridDim.x, ...:
//   1. the update of each chunk and its partials partial[2q] (x) and
//      partial[2q + 1] (r): the chunks past the block's first written to x
//      and r, then the first chunk, whose updated entries stay in registers
//      (last, so that no other chunk's loads are in flight beside them);
//   2. grid barrier; every block sums the nchunk partials in index order
//      and forms the means (the same bits in every block);
//   3. the projection: the first chunk from the registers, the others read
//      back; x and r written.
// Mode 0 writes the update and stops (no partials, no barrier).  A frozen
// launch (flag 0) returns from every block before the barrier.  Two blocks
// an SM at least (the registers bounded), so that one grid covers the
// chunks of the main path's EMI vectors.
template <typename T>
__global__ void __launch_bounds__(KNP_THREADS, 2)
    pcg_update_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
                      const T* __restrict__ Ap, const T* __restrict__ sc,
                      const T* __restrict__ w, T* partial, const int* __restrict__ flag,
                      long long n, int nchunk, int mode) {
  __shared__ T red[KNP_WARPS];
  if (*flag == 0) return;
  const T alpha = sc[PCG_ALPHA];
  T sx, sr;
  for (int q = blockIdx.x + gridDim.x; q < nchunk; q += gridDim.x) {
    const long long lq = (long long)q * PCG_CHUNK + threadIdx.x;
    T ux[PCG_PER], ur[PCG_PER], uw[PCG_PER];
    pcg_update_chunk<T>(x, r, p, Ap, w, alpha, lq, n, mode, ux, ur, uw, red, sx, sr);
#pragma unroll
    for (int k = 0; k < PCG_PER; ++k) {
      const long long i = lq + (long long)k * KNP_THREADS;
      if (i < n) {
        x[i] = ux[k];
        r[i] = ur[k];
      }
    }
    if (mode != 0 && threadIdx.x == 0) {
      partial[2 * (long long)q] = sx;
      partial[2 * (long long)q + 1] = sr;
    }
  }
  const long long lo = (long long)blockIdx.x * PCG_CHUNK + threadIdx.x;
  T vx[PCG_PER], vr[PCG_PER], vw[PCG_PER];
  pcg_update_chunk<T>(x, r, p, Ap, w, alpha, lo, n, mode, vx, vr, vw, red, sx, sr);
  if (mode == 0) {
#pragma unroll
    for (int k = 0; k < PCG_PER; ++k) {
      const long long i = lo + (long long)k * KNP_THREADS;
      if (i < n) {
        x[i] = vx[k];
        r[i] = vr[k];
      }
    }
    return;
  }
  if (threadIdx.x == 0) {
    partial[2 * (long long)blockIdx.x] = sx;
    partial[2 * (long long)blockIdx.x + 1] = sr;
  }
  cooperative_groups::this_grid().sync();
  pcg_finish_sums<T, 2>(partial, nchunk, red, sx, sr);
  const T mx = sx / sc[PCG_WSUM], mr = sr / sc[PCG_WSUM];
  pcg_project_store<T>(x, r, vx, vr, vw, mx, mr, lo, n, mode);
  for (int q = blockIdx.x + gridDim.x; q < nchunk; q += gridDim.x) {
    const long long lq = (long long)q * PCG_CHUNK + threadIdx.x;
    T ux[PCG_PER], ur[PCG_PER], uw[PCG_PER];
#pragma unroll
    for (int k = 0; k < PCG_PER; ++k) {
      const long long i = lq + (long long)k * KNP_THREADS;
      ux[k] = i < n ? x[i] : T(0);
      ur[k] = i < n ? r[i] : T(0);
      uw[k] = i < n && mode == 2 ? w[i] : T(1);
    }
    pcg_project_store<T>(x, r, ux, ur, uw, mx, mr, lq, n, mode);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// One launch of the dot kernel over n entries; the ticket must be 0
template <typename T>
static int pcg_dot_launch(const T* a, const T* b, T* partial, int* ticket, T* sc,
                          const int* flag, int n, int chunk, void* stream) {
  if (chunk != PCG_CHUNK || n < 1) return (int)cudaErrorInvalidValue;
  pcg_dot_kernel<T><<<knp_chunks(n, chunk), KNP_THREADS, 0, (cudaStream_t)stream>>>(
      a, b, partial, ticket, sc, flag, n);
  return (int)cudaGetLastError();
}

// The grid of the cooperative entries (update, dot2_direction) over n
// entries on the current device: the chunks, at most the blocks that both
// kernels can hold resident together
template <typename T>
static int pcg_grid(int n, int chunk, int* grid) {
  if (chunk != PCG_CHUNK || n < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_dir = 0, per_upd = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_dir, pcg_dot2_direction_kernel<T>,
                                                      KNP_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_upd, pcg_update_kernel<T>,
                                                      KNP_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const int per_sm = per_dir < per_upd ? per_dir : per_upd;
  if (!coop || per_sm < 1) return (int)cudaErrorNotSupported;
  const int nchunk = knp_chunks(n, chunk);
  *grid = per_sm * sms < nchunk ? per_sm * sms : nchunk;
  return 0;
}

// One cooperative launch of ``kernel`` on ``grid`` blocks (from pcg_grid);
// a refused launch returns its error and leaves none behind
static int pcg_coop_launch(const void* kernel, int grid, int nchunk, void** args,
                           void* stream) {
  if (grid < 1 || grid > nchunk) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(KNP_THREADS), args,
                                                    0, (cudaStream_t)stream);
  // a refused launch also sets the runtime's last error: read it here, or
  // the next launch of any kernel would report it
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? (int)e : (int)last;
}

template <typename T>
static int pcg_update_launch(T* x, T* r, const T* p, const T* Ap, const T* sc, const T* w,
                             T* partial, const int* flag, int n, int grid, int mode,
                             void* stream) {
  if (n < 1 || mode < 0 || mode > 2 || (mode == 2 && w == nullptr))
    return (int)cudaErrorInvalidValue;
  int nchunk = knp_chunks(n, PCG_CHUNK);
  long long nn = n;
  void* args[] = {(void*)&x,       (void*)&r,    (void*)&p,  (void*)&Ap,     (void*)&sc,
                  (void*)&w,       (void*)&partial, (void*)&flag, (void*)&nn, (void*)&nchunk,
                  (void*)&mode};
  return pcg_coop_launch((const void*)pcg_update_kernel<T>, grid, nchunk, args, stream);
}

template <typename T>
static int pcg_dot2_direction_launch(const T* r, const T* z, T* p, T* partial, T* sc, int* flag,
                                     int* iters, int max_it, int n, int grid, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int nchunk = knp_chunks(n, PCG_CHUNK);
  long long nn = n;
  void* args[] = {(void*)&r,     (void*)&z,      (void*)&p,  (void*)&partial,
                  (void*)&sc,    (void*)&flag,   (void*)&iters, (void*)&max_it,
                  (void*)&nn,    (void*)&nchunk};
  return pcg_coop_launch((const void*)pcg_dot2_direction_kernel<T>, grid, nchunk, args, stream);
}

#define PCG_ENTRIES(T, SFX)                                                                  \
  extern "C" int knp_pcg_dot_##SFX(const T* p, const T* Ap, T* partial, int* ticket, T* sc, \
                                   const int* flag, int n, int chunk, void* stream) {        \
    return pcg_dot_launch<T>(p, Ap, partial, ticket, sc, flag, n, chunk, stream);            \
  }                                                                                          \
  extern "C" int knp_pcg_update_##SFX(T* x, T* r, const T* p, const T* Ap, const T* sc,     \
                                      const T* w, T* partial, const int* flag, int n,        \
                                      int grid, int mode, void* stream) {                    \
    return pcg_update_launch<T>(x, r, p, Ap, sc, w, partial, flag, n, grid, mode, stream);   \
  }                                                                                          \
  extern "C" int knp_pcg_grid_##SFX(int n, int chunk, int* grid) {                          \
    return pcg_grid<T>(n, chunk, grid);                                                      \
  }                                                                                          \
  extern "C" int knp_pcg_dot2_direction_##SFX(const T* r, const T* z, T* p, T* partial,     \
                                              T* sc, int* flag, int* iters, int max_it,      \
                                              int n, int grid, void* stream) {               \
    return pcg_dot2_direction_launch<T>(r, z, p, partial, sc, flag, iters, max_it, n, grid,  \
                                        stream);                                             \
  }

PCG_ENTRIES(float, f32)
PCG_ENTRIES(double, f64)
