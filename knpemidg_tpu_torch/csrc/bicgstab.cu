// Kernel K15: the vector work of the batched BiCGStab loop, with the loop's
// scalars, the freeze of converged systems and the convergence flag kept on
// the device.
//
// Replaces the loop body of knpemidg_tpu/solvers/krylov.py:472
// bicgstab_batched (:523-552): mb independent left-preconditioned systems
// of n entries each, the vectors laid out (mb, n), sharing one loop.  An
// iteration is two applies of A = M^-1 K, which stay outside, and two
// launches of this file around them:
//
//   start  r = rhat = r0, v = 0; per system tol = max(rtol ||bz||, atol),
//          rr = r . r, rho' = rhat . r, rho = alpha = omega = 1, ks = 0,
//          live = sqrt(rr) > tol, the flag any live, and the first
//          direction p = live ? r + beta (0 - omega 0) : 0
//   alpha  after v = A p:  ks += live, alpha' = rho' / (rhat . v) (0 where
//          the dot is 0 or the system is frozen), s = r - alpha' v, and v
//          kept (the caller's apply may hand back a buffer it reuses)
//   omega  after t = A s:  omega' = (t . s) / (t . t) (0 where t . t is 0;
//          the carried omega where frozen), x += alpha' p + omega' s,
//          r = live ? s - omega' t : r; then rr and rho' of the new r, the
//          carried rho, alpha, omega, live and the flag, and the next
//          direction p = live ? r + beta (p - omega v) : p with the breakdown
//          guard beta = 0 unless |rho| > 0, |omega| > 0 and live
//
// so the host reads one int32 flag an iteration, as the JAX while-loop's
// test reads it on the device.  The direction update of iteration k + 1
// runs in iteration k's omega launch; ks counts in the alpha launch, which
// runs only for an iteration that happens, so the counts are the JAX
// loop's.
//
// Each entry is one cooperative launch of at most the co-resident blocks:
// block b takes the units (a system's chunk of BI_CHUNK entries) b, b +
// gridDim.x, ...; each unit's block sums go into the partials, a grid
// barrier, then every block sums every system's partials in index order
// (the same sum in the same order in every block, so every block holds the
// same scalar bits) and updates its units; block 0 writes the scalars.
// Every sum is a fixed-order tree (thread t adds its entries t + 256 k of a
// chunk from zero, the block tree, then the chunk sums the same way): no
// floating-point atomics, so the iteration counts repeat from call to call,
// and ops/krylov_ops.py's ordered plain versions replay the order to the
// last bit.  The source compiles with -fmad=false, so the updates round as
// the plain versions' separate operations do.
//
// Bound: device-memory bandwidth (a few flops per 8 bytes).
#include <cooperative_groups.h>

#include "common.cuh"

// entries a thread of a unit sums; a unit is one block's share of a system
// (RED_CHUNK = 2048 of ops/krylov_ops.py)
#define BI_PER 8
#define BI_CHUNK (BI_PER * KNP_THREADS)
// systems of a batch (ops/krylov_ops.py MAX_SYSTEMS)
#define BI_MAX_SYS 32

// the per-system scalars, sc[s * BI_NSC + k] (ops/krylov_ops.py BI_*)
enum { BI_RHO = 0, BI_ALPHA, BI_OMEGA, BI_TOL, BI_RR, BI_RHON, BI_ALPHAN, BI_NSC = 8 };

// The block sums a . b and (NV = 2) c . d over the unit whose thread-t
// entry is lo (offsets within one system's n entries, at base): thread t
// adds its products lo + 256 k, k = 0..7, in order from zero, then the block
// tree; every thread gets the sums.  The loads are issued before the adds.
// The pointers are not __restrict__: the omega kernel sums an r its threads
// have just written, which a non-coherent load could miss.
template <typename T, int NV>
__device__ __forceinline__ void bi_unit_sums(const T* a, const T* b, const T* c, const T* d,
                                             long long lo, long long n, T* red, T& s0, T& s1) {
  T va[BI_PER], vb[BI_PER], vc[BI_PER], vd[BI_PER];
#pragma unroll
  for (int k = 0; k < BI_PER; ++k) {
    const long long i = lo + (long long)k * KNP_THREADS;
    va[k] = i < n ? a[i] : T(0);
    vb[k] = i < n ? b[i] : T(0);
    if (NV == 2) {
      vc[k] = i < n ? c[i] : T(0);
      vd[k] = i < n ? d[i] : T(0);
    }
  }
  T acc0 = T(0), acc1 = T(0);
#pragma unroll
  for (int k = 0; k < BI_PER; ++k) {
    if (lo + (long long)k * KNP_THREADS < n) {
      acc0 += va[k] * vb[k];
      if (NV == 2) acc1 += vc[k] * vd[k];
    }
  }
  s0 = knp_block_sum(acc0, red);
  if (NV == 2) s1 = knp_block_sum(acc1, red);
}

// The sums of system s's nblk partials part[(s nblk + q) NV + v] in index
// order, as one block forms them: thread t takes q = t + 256 k, then the
// block tree.  volatile: read where the other blocks wrote, after the
// barrier that made them visible.
template <typename T, int NV>
__device__ __forceinline__ void bi_finish(const volatile T* part, int s, int nblk, T* red,
                                          T& s0, T& s1) {
  T a0 = T(0), a1 = T(0);
  const long long b0 = (long long)s * nblk;
  for (int q = threadIdx.x; q < nblk; q += blockDim.x) {
    a0 += part[(b0 + q) * NV];
    if (NV == 2) a1 += part[(b0 + q) * NV + 1];
  }
  s0 = knp_block_sum(a0, red);
  if (NV == 2) s1 = knp_block_sum(a1, red);
}

template <typename T>
__device__ __forceinline__ T bi_abs(T v) {
  return v < T(0) ? -v : v;
}

// start: the partials of r0 . r0 and bz . bz, a grid barrier, the scalars,
// then r = rhat = r0, v = 0 and the first direction over the block's units
template <typename T>
__global__ void __launch_bounds__(KNP_THREADS)
    bi_start_kernel(const T* __restrict__ r0, const T* __restrict__ bz, T* __restrict__ r,
                    T* __restrict__ rhat, T* __restrict__ p, T* __restrict__ v, T* part, T* sc,
                    int* __restrict__ ks, int* __restrict__ live, int* __restrict__ flag, int mb,
                    long long n, int nblk, T rtol, T atol) {
  __shared__ T red[KNP_WARPS];
  __shared__ T s_beta[BI_MAX_SYS];
  __shared__ int s_live[BI_MAX_SYS];
  const int tid = threadIdx.x;
  const long long units = (long long)mb * nblk;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long base = (u / nblk) * n, lo = (u % nblk) * BI_CHUNK + tid;
    T s0, s1;
    bi_unit_sums<T, 2>(r0 + base, r0 + base, bz + base, bz + base, lo, n, red, s0, s1);
    if (tid == 0) {
      part[2 * u] = s0;
      part[2 * u + 1] = s1;
    }
  }
  cooperative_groups::this_grid().sync();
  int any = 0;
  for (int s = 0; s < mb; ++s) {
    T rr, bb;
    bi_finish<T, 2>(part, s, nblk, red, rr, bb);
    const T tb = rtol * sqrt(bb);
    const T tol = tb < atol ? atol : tb;  // NaN stays NaN, as torch.clamp keeps it
    const T rhon = rr;                   // rhat = r0: the same products in the same order
    const int lv = sqrt(rr) > tol;
    const T rho = T(1), alpha = T(1), omega = T(1);
    const bool safe = bi_abs(rho) > T(0) && bi_abs(omega) > T(0) && lv;
    const T beta = safe ? (rhon / rho) * (alpha / omega) : T(0);
    any |= lv;
    if (tid == 0) {
      s_beta[s] = beta;
      s_live[s] = lv;
      if (blockIdx.x == 0) {
        T* q = sc + (long long)s * BI_NSC;
        q[BI_RHO] = rho;
        q[BI_ALPHA] = alpha;
        q[BI_OMEGA] = omega;
        q[BI_TOL] = tol;
        q[BI_RR] = rr;
        q[BI_RHON] = rhon;
        q[BI_ALPHAN] = T(0);
        ks[s] = 0;
        live[s] = lv;
      }
    }
  }
  if (blockIdx.x == 0 && tid == 0) *flag = any;
  __syncthreads();
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int s = (int)(u / nblk);
    const long long base = s * n, lo = (u % nblk) * BI_CHUNK + tid;
    const T beta = s_beta[s], zero = T(0), omega = T(1);
#pragma unroll
    for (int k = 0; k < BI_PER; ++k) {
      const long long i = lo + (long long)k * KNP_THREADS;
      if (i < n) {
        const T rv = r0[base + i];
        r[base + i] = rv;
        rhat[base + i] = rv;
        v[base + i] = zero;
        p[base + i] = s_live[s] ? rv + beta * (zero - omega * zero) : zero;
      }
    }
  }
}

// alpha: ks += live, the partials of rhat . vin, a grid barrier, alpha',
// then s = r - alpha' vin and v = vin over the block's units
template <typename T>
__global__ void __launch_bounds__(KNP_THREADS)
    bi_alpha_kernel(const T* __restrict__ vin, const T* __restrict__ r,
                    const T* __restrict__ rhat, T* __restrict__ v, T* __restrict__ sv, T* part,
                    T* sc, int* __restrict__ ks, const int* __restrict__ live, int mb,
                    long long n, int nblk) {
  __shared__ T red[KNP_WARPS];
  __shared__ T s_an[BI_MAX_SYS];
  const int tid = threadIdx.x;
  const long long units = (long long)mb * nblk;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long base = (u / nblk) * n, lo = (u % nblk) * BI_CHUNK + tid;
    T s0, s1;
    bi_unit_sums<T, 1>(rhat + base, vin + base, nullptr, nullptr, lo, n, red, s0, s1);
    if (tid == 0) part[u] = s0;
  }
  cooperative_groups::this_grid().sync();
  for (int s = 0; s < mb; ++s) {
    T denom, unused;
    bi_finish<T, 1>(part, s, nblk, red, denom, unused);
    T* q = sc + (long long)s * BI_NSC;
    const int lv = live[s];
    T an = bi_abs(denom) > T(0) ? q[BI_RHON] / denom : T(0);
    an = lv ? an : T(0);
    if (tid == 0) {
      s_an[s] = an;
      if (blockIdx.x == 0) {
        q[BI_ALPHAN] = an;
        ks[s] += lv;
      }
    }
  }
  __syncthreads();
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int s = (int)(u / nblk);
    const long long base = s * n, lo = (u % nblk) * BI_CHUNK + tid;
    const T an = s_an[s];
#pragma unroll
    for (int k = 0; k < BI_PER; ++k) {
      const long long i = lo + (long long)k * KNP_THREADS;
      if (i < n) {
        const T vv = vin[base + i];
        sv[base + i] = r[base + i] - an * vv;
        v[base + i] = vv;
      }
    }
  }
}

// omega: the partials of t . t and t . s, a grid barrier, omega'; x and r
// updated with the partials of r . r and rhat . r, a second barrier, the
// carried scalars, live and the flag; then the next direction over the
// block's units (each thread reads back only the r it wrote).  Every block
// reads the scalars into shared memory before the first barrier; block 0
// writes them only after the second.
template <typename T>
__global__ void __launch_bounds__(KNP_THREADS)
    bi_omega_kernel(const T* __restrict__ t, T* __restrict__ x, T* __restrict__ r,
                    const T* __restrict__ rhat, T* __restrict__ p, const T* __restrict__ v,
                    const T* __restrict__ sv, T* part, T* sc, int* __restrict__ live,
                    int* __restrict__ flag, int mb, long long n, int nblk) {
  __shared__ T red[KNP_WARPS];
  __shared__ T c_rho[BI_MAX_SYS], c_alpha[BI_MAX_SYS], c_omega[BI_MAX_SYS], c_tol[BI_MAX_SYS],
      c_rhon[BI_MAX_SYS], c_an[BI_MAX_SYS];
  __shared__ T s_om[BI_MAX_SYS], s_oml[BI_MAX_SYS], s_beta[BI_MAX_SYS];
  __shared__ int c_live[BI_MAX_SYS], s_next[BI_MAX_SYS];
  const int tid = threadIdx.x;
  const long long units = (long long)mb * nblk;
  T* part2 = part + 2 * units;
  if (tid < mb) {
    const T* q = sc + (long long)tid * BI_NSC;
    c_rho[tid] = q[BI_RHO];
    c_alpha[tid] = q[BI_ALPHA];
    c_omega[tid] = q[BI_OMEGA];
    c_tol[tid] = q[BI_TOL];
    c_rhon[tid] = q[BI_RHON];
    c_an[tid] = q[BI_ALPHAN];
    c_live[tid] = live[tid];
  }
  __syncthreads();
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long base = (u / nblk) * n, lo = (u % nblk) * BI_CHUNK + tid;
    T s0, s1;
    bi_unit_sums<T, 2>(t + base, t + base, t + base, sv + base, lo, n, red, s0, s1);
    if (tid == 0) {
      part[2 * u] = s0;
      part[2 * u + 1] = s1;
    }
  }
  cooperative_groups::this_grid().sync();
  for (int s = 0; s < mb; ++s) {
    T tt, ts;
    bi_finish<T, 2>(part, s, nblk, red, tt, ts);
    const int lv = c_live[s];
    T om = tt > T(0) ? ts / tt : T(0);
    om = lv ? om : c_omega[s];
    if (tid == 0) {
      s_om[s] = om;
      s_oml[s] = lv ? om : T(0);
    }
  }
  __syncthreads();
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int s = (int)(u / nblk);
    const long long base = s * n, lo = (u % nblk) * BI_CHUNK + tid;
    const T an = c_an[s], om = s_om[s], oml = s_oml[s];
    const int lv = c_live[s];
#pragma unroll
    for (int k = 0; k < BI_PER; ++k) {
      const long long i = lo + (long long)k * KNP_THREADS;
      if (i < n) {
        const T svv = sv[base + i];
        x[base + i] = x[base + i] + an * p[base + i] + oml * svv;
        if (lv) r[base + i] = svv - om * t[base + i];
      }
    }
    T s0, s1;
    bi_unit_sums<T, 2>(r + base, r + base, rhat + base, r + base, lo, n, red, s0, s1);
    if (tid == 0) {
      part2[2 * u] = s0;
      part2[2 * u + 1] = s1;
    }
  }
  cooperative_groups::this_grid().sync();
  int any = 0;
  for (int s = 0; s < mb; ++s) {
    T rr, rhon;
    bi_finish<T, 2>(part2, s, nblk, red, rr, rhon);
    const int lv = c_live[s];
    const T rho = lv ? c_rhon[s] : c_rho[s];
    const T alpha = c_an[s] + T(lv ? 0 : 1) * c_alpha[s];
    const T omega = s_om[s];
    const int next = sqrt(rr) > c_tol[s];
    const bool safe = bi_abs(rho) > T(0) && bi_abs(omega) > T(0) && next;
    const T beta = safe ? (rhon / rho) * (alpha / omega) : T(0);
    any |= next;
    if (tid == 0) {
      s_beta[s] = beta;
      s_next[s] = next;
      if (blockIdx.x == 0) {
        T* q = sc + (long long)s * BI_NSC;
        q[BI_RHO] = rho;
        q[BI_ALPHA] = alpha;
        q[BI_OMEGA] = omega;
        q[BI_RR] = rr;
        q[BI_RHON] = rhon;
        live[s] = next;
      }
    }
  }
  if (blockIdx.x == 0 && tid == 0) *flag = any;
  __syncthreads();
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int s = (int)(u / nblk);
    if (!s_next[s]) continue;
    const long long base = s * n, lo = (u % nblk) * BI_CHUNK + tid;
    const T beta = s_beta[s], om = s_om[s];
#pragma unroll
    for (int k = 0; k < BI_PER; ++k) {
      const long long i = lo + (long long)k * KNP_THREADS;
      if (i < n) p[base + i] = r[base + i] + beta * (p[base + i] - om * v[base + i]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// The grid of the three kernels for mb systems of n entries on the current
// device: the units, at most the blocks each kernel can hold resident (a
// cooperative launch needs them all)
template <typename T>
static int bi_grid(int mb, int n, int* grid) {
  if (mb < 1 || mb > BI_MAX_SYS || n < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  const void* fns[3] = {(const void*)bi_start_kernel<T>, (const void*)bi_alpha_kernel<T>,
                        (const void*)bi_omega_kernel<T>};
  int per_sm = 1 << 30;
  for (int f = 0; f < 3 && e == cudaSuccess; ++f) {
    int k = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, fns[f], KNP_THREADS, 0);
    per_sm = k < per_sm ? k : per_sm;
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (!coop || per_sm < 1) return (int)cudaErrorNotSupported;
  const long long units = (long long)mb * knp_chunks(n, BI_CHUNK);
  *grid = (long long)per_sm * sms < units ? per_sm * sms : (int)units;
  return 0;
}

// One cooperative launch of ``fn`` on ``grid`` blocks; a refused launch
// returns its error and leaves none behind
static int bi_launch(const void* fn, int grid, int mb, int n, void** args, void* stream) {
  const long long units = (long long)mb * knp_chunks(n, BI_CHUNK);
  if (mb < 1 || mb > BI_MAX_SYS || n < 1 || grid < 1 || grid > units)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(KNP_THREADS), args, 0,
                                                    (cudaStream_t)stream);
  // a refused launch also sets the runtime's last error: read it here, or
  // the next launch of any kernel would report it
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? (int)e : (int)last;
}

template <typename T>
static int bi_start_launch(const T* r0, const T* bz, T* r, T* rhat, T* p, T* v, T* part, T* sc,
                           int* ks, int* live, int* flag, int mb, int n, int grid, double rtol,
                           double atol, void* stream) {
  long long nn = n;
  int nblk = knp_chunks(n, BI_CHUNK);
  T rt = (T)rtol, at = (T)atol;
  void* args[] = {(void*)&r0, (void*)&bz, (void*)&r, (void*)&rhat, (void*)&p,
                  (void*)&v, (void*)&part, (void*)&sc, (void*)&ks, (void*)&live,
                  (void*)&flag, (void*)&mb, (void*)&nn, (void*)&nblk, (void*)&rt,
                  (void*)&at};
  return bi_launch((const void*)bi_start_kernel<T>, grid, mb, n, args, stream);
}

template <typename T>
static int bi_alpha_launch(const T* vin, const T* r, const T* rhat, T* v, T* sv, T* part, T* sc,
                           int* ks, const int* live, int mb, int n, int grid, void* stream) {
  long long nn = n;
  int nblk = knp_chunks(n, BI_CHUNK);
  void* args[] = {(void*)&vin, (void*)&r, (void*)&rhat, (void*)&v, (void*)&sv,
                  (void*)&part, (void*)&sc, (void*)&ks, (void*)&live, (void*)&mb,
                  (void*)&nn, (void*)&nblk};
  return bi_launch((const void*)bi_alpha_kernel<T>, grid, mb, n, args, stream);
}

template <typename T>
static int bi_omega_launch(const T* t, T* x, T* r, const T* rhat, T* p, const T* v, const T* sv,
                           T* part, T* sc, int* live, int* flag, int mb, int n, int grid,
                           void* stream) {
  long long nn = n;
  int nblk = knp_chunks(n, BI_CHUNK);
  void* args[] = {(void*)&t, (void*)&x, (void*)&r, (void*)&rhat, (void*)&p,
                  (void*)&v, (void*)&sv, (void*)&part, (void*)&sc, (void*)&live,
                  (void*)&flag, (void*)&mb, (void*)&nn, (void*)&nblk};
  return bi_launch((const void*)bi_omega_kernel<T>, grid, mb, n, args, stream);
}

#define BI_ENTRIES(T, SFX)                                                                    \
  extern "C" int knp_bicgstab_grid_##SFX(int mb, int n, int* grid) {                         \
    return bi_grid<T>(mb, n, grid);                                                           \
  }                                                                                           \
  extern "C" int knp_bicgstab_start_##SFX(const T* r0, const T* bz, T* r, T* rhat, T* p,     \
                                          T* v, T* part, T* sc, int* ks, int* live,           \
                                          int* flag, int mb, int n, int grid, double rtol,    \
                                          double atol, void* stream) {                        \
    return bi_start_launch<T>(r0, bz, r, rhat, p, v, part, sc, ks, live, flag, mb, n, grid,  \
                              rtol, atol, stream);                                            \
  }                                                                                           \
  extern "C" int knp_bicgstab_alpha_##SFX(const T* vin, const T* r, const T* rhat, T* v,     \
                                          T* sv, T* part, T* sc, int* ks, const int* live,    \
                                          int mb, int n, int grid, void* stream) {            \
    return bi_alpha_launch<T>(vin, r, rhat, v, sv, part, sc, ks, live, mb, n, grid, stream); \
  }                                                                                           \
  extern "C" int knp_bicgstab_omega_##SFX(const T* t, T* x, T* r, const T* rhat, T* p,       \
                                          const T* v, const T* sv, T* part, T* sc, int* live, \
                                          int* flag, int mb, int n, int grid, void* stream) { \
    return bi_omega_launch<T>(t, x, r, rhat, p, v, sv, part, sc, live, flag, mb, n, grid,    \
                              stream);                                                        \
  }

BI_ENTRIES(float, f32)
BI_ENTRIES(double, f64)
