// Kernel K9: the vector and scalar work of the batched restarted GMRES cycle
// (CGS2 Arnoldi, Givens rotations replayed per column, per-system freeze,
// triangular solve and update) for mb systems sharing one Krylov loop.
//
// Replaces knpemidg_tpu/solvers/krylov.py:260 gmres_batched, its cycle
// (:318) with orth="cgs2" (:385-389), rot="replay" (:403-410), the freeze
// (:418-439) and the triangular solve and update (:445-452), which XLA runs
// as four whole-basis einsums per Arnoldi step plus scalar work.
//
// The basis is stored rows first, V (m+1, mb, n): V[(k mb + s) n + i], so
// that row j of all systems is one contiguous (mb, n) slab the matvec takes
// without a copy.  Arnoldi step j (rows 0..j populated) is one cooperative
// launch, gm_arnoldi_kernel, in four phases split by grid barriers:
//
//   1. w staged in shared memory (cp.async), the dot partials of rows 0..j;
//   2. h1 = the partials summed, w -= sum_k h1[k] V[k], the second dot's
//      partials;
//   3. h2, w -= sum_k h2[k] V[k], the norm partials of w;
//   4. hj1 = ||w||, V[j+1] = live ? (hj1 > 1e-300 ? w / hj1 : 0) : 0, and in
//      block 0 the scalar work, one thread per system: h = h1 + h2,
//      h[j+1] = hj1, the j stored rotations replayed, the new one, the
//      freeze of systems that are no longer live, ks += live and the flag
//      any |g[:, j+1]| > tol the host loop reads (one step behind: a step
//      launched with the flag 0 returns before it writes anything);
//
// and at the cycle's ends start (beta = ||r||, V[0] = r / beta, the scalars
// zeroed, the flag any beta > tol: one cooperative launch on the step's
// shape, r read once and kept in shared memory across its grid barrier,
// bitwise the earlier partial, scale and init launches) and solve_update
// (one launch: each block issues the 16-byte loads of its chunk of x and
// of the first basis rows, and meanwhile one warp back-substitutes R[:ks,
// :ks] y = g[:ks] in shared memory; then x += sum_{k<ks} y_k V[k], bitwise
// the earlier back-substitution and update launches; bound: the ks rows and
// x read once, x written once).  The dot kernel gives the solve's tolerance
// (||M^-1 b|| per system) in one launch: its partials, then the block that
// finishes each sum last (an int32 ticket, no floating-point atomics) adds
// them in index order, so no second launch waits on the first.
//
// Bound: device-memory bandwidth.  The whole-basis einsums read all m+1 = 31
// rows of V four times a step whatever j is (0.99 GB in float64 at the cell
// layout's n = 497,664, mb = 2); a step must read the j+1 populated rows and
// w once and write V[j+1] once.  The step kernel reads the rows four times
// (the two dots and the two updates; the dots from the last row to the
// first, so that each pass starts on the rows the one before read last,
// still in the 50 MB L2 or in L1) and w once: each block keeps its chunks
// of w in shared memory through the four phases and never writes w back.  Where the blocks' chunks do not fit in shared memory beside the
// co-resident limit (meshes several times chip_smoke.py's), the same kernel
// reads and updates w in device memory, with the same bits.  No kernel reads
// a row it has not written, so V needs no zeroing.  Every sum is a
// fixed-order reduction (block trees, then the blocks in index order, the
// finishing block's order replayed by one warp after a grid barrier): no
// floating-point atomics, so results and Krylov counts repeat from call to
// call, and the step's outputs are bitwise those of the earlier nine
// launches a step.  The source compiles with -fmad=false: the Givens
// arithmetic and the elementwise updates round as the plain versions do.
#include <cooperative_groups.h>
#include <cuda/atomic>

#include <algorithm>

#include "common.cuh"

#define GM_MAX_ROWS 64   // restart + 1 at most
#define GM_MAX_SYS 32    // systems in one batch at most
// entries a thread of the step kernel takes in a chunk; a chunk is one
// reduction block's share (RED_CHUNK = 2048 of ops/krylov_ops.py)
#define GM_PER 8
#define GM_CHUNK (GM_PER * KNP_THREADS)

// out[s ldo + k] = V[k,s,:] . w[s,:] for k < rows in one launch, a block a
// chunk b, row k and system s (grid (nblk, rows, mb)): thread t adds its
// products b chunk + t + 256 e, e = 0..7, in order from zero (all its
// loads issued before its first add), then the block tree, into
// partial[(s rows + k) nblk + b]; thread 0 publishes the partial with a
// release ticket of its (s, k) (an int32 atomic, the only one).  The block
// that draws nblk - 1 has acquired the row's partials, sums them in index
// order (thread t adds partials t, t + 256, ... from zero, then the block
// tree), writes out and resets the ticket for the next launch on the
// stream.  A system of one chunk takes no ticket.
template <typename T>
__global__ void __launch_bounds__(KNP_THREADS)
    gm_dot_kernel(const T* __restrict__ V, const T* __restrict__ w, T* __restrict__ partial,
                  int* __restrict__ ticket, T* __restrict__ out, int mb, long long n, int ldo) {
  __shared__ T red[KNP_WARPS];
  __shared__ bool last;
  const int b = blockIdx.x, k = blockIdx.y, s = blockIdx.z, nblk = gridDim.x;
  const long long lo = (long long)b * GM_CHUNK + threadIdx.x;
  const T* v = V + ((long long)k * mb + s) * n;
  const T* ws = w + (long long)s * n;
  T va[GM_PER], vb[GM_PER];
#pragma unroll
  for (int e = 0; e < GM_PER; ++e) {
    const long long i = lo + (long long)e * KNP_THREADS;
    va[e] = i < n ? v[i] : T(0);
    vb[e] = i < n ? ws[i] : T(0);
  }
  T acc = T(0);
#pragma unroll
  for (int e = 0; e < GM_PER; ++e)
    if (lo + (long long)e * KNP_THREADS < n) acc += va[e] * vb[e];
  acc = knp_block_sum(acc, red);
  const long long row = (long long)s * gridDim.y + k;
  if (threadIdx.x == 0) {
    partial[row * nblk + b] = acc;
    if (nblk == 1) {
      last = true;
    } else {
      cuda::atomic_ref<int, cuda::thread_scope_device> done(ticket[row]);
      last = done.fetch_add(1, cuda::memory_order_acq_rel) == nblk - 1;
    }
  }
  __syncthreads();
  if (!last) return;
  // volatile: the partials the other blocks wrote, read where they wrote
  const volatile T* p = partial + row * nblk;
  T tot = T(0);
  for (int q = threadIdx.x; q < nblk; q += blockDim.x) tot += p[q];
  tot = knp_block_sum(tot, red);
  if (threadIdx.x != 0) return;
  out[(long long)s * ldo + k] = tot;
  if (nblk > 1) ticket[row] = 0;
}

// ---------------------------------------------------------------------------
// the cycle's end: y and the update x += sum_{k < ks} y_k V[k], one launch
// ---------------------------------------------------------------------------

// bytes of a basis row a thread of the update takes in a unit: two 16-byte
// vectors (4 doubles or 8 floats)
#define GMU_BYTES 32
// rows of V whose loads a thread has in flight together
#define GMU_ROWS 4

template <typename T> struct GmVec16;
template <> struct GmVec16<float> { typedef float4 V; };
template <> struct GmVec16<double> { typedef double2 V; };

__device__ __forceinline__ void gm_unpack(const double2& w, double (&v)[2]) {
  v[0] = w.x;
  v[1] = w.y;
}
__device__ __forceinline__ void gm_unpack(const float4& w, float (&v)[4]) {
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ double2 gm_pack(const double (&v)[2]) { return make_double2(v[0], v[1]); }
__device__ __forceinline__ float4 gm_pack(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// VEC consecutive entries at p: one 16-byte access (VEC = 16 / sizeof(T), p
// aligned to 16 bytes) or one entry; STREAM: the evict-first hint (a basis
// row read for the last time)
template <typename T, int VEC, bool STREAM>
__device__ __forceinline__ void gm_ldv(const T* p, T (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = STREAM ? __ldcs(p) : *p;
  } else {
    typedef typename GmVec16<T>::V V;
    const V* q = reinterpret_cast<const V*>(p);
    gm_unpack(STREAM ? __ldcs(q) : *q, v);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void gm_stv(T* p, const T (&v)[VEC]) {
  if constexpr (VEC == 1)
    *p = v[0];
  else
    *reinterpret_cast<typename GmVec16<T>::V*>(p) = gm_pack(v);
}

// One unit of the update: chunk c (CHUNK entries) of one system.  Thread
// t's vectors q < NV start at entry c CHUNK + (q KNP_THREADS + t) VEC, so a
// warp's accesses are consecutive; with VEC > 1, n is a multiple of VEC and
// a vector lies wholly inside or outside the system.  The registers hold x
// and GMU_ROWS rows of V.
template <typename T, int VEC>
struct GmUnit {
  static constexpr int EPT = GMU_BYTES / sizeof(T);
  static constexpr int NV = EPT / VEC;
  static constexpr int CHUNK = EPT * KNP_THREADS;
  T xv[NV][VEC];
  T vv[GMU_ROWS][NV][VEC];
  long long i0;   // the thread's first entry

  __device__ __forceinline__ long long at(int q) const { return i0 + (long long)q * KNP_THREADS * VEC; }

  // the loads of rows l0 .. l0 + GMU_ROWS - 1 below k
  __device__ __forceinline__ void rows(const T* v, long long slab, long long n, int l0, int k) {
#pragma unroll
    for (int r = 0; r < GMU_ROWS; ++r) {
      if (l0 + r < k) {
#pragma unroll
        for (int q = 0; q < NV; ++q)
          if (at(q) < n) gm_ldv<T, VEC, true>(v + (l0 + r) * slab + at(q), vv[r][q]);
      }
    }
  }

  // chunk c of system s: the loads of x and of its first GMU_ROWS rows
  __device__ __forceinline__ void load(const T* V, const T* x, int s, long long c, long long slab,
                                       long long n, int k) {
    i0 = c * CHUNK + (long long)threadIdx.x * VEC;
    const T* xs = x + (long long)s * n;
#pragma unroll
    for (int q = 0; q < NV; ++q)
      if (at(q) < n) gm_ldv<T, VEC, false>(xs + at(q), xv[q]);
    rows(V + (long long)s * n, slab, n, 0, k);
  }

  // x = x + acc, acc = y_0 v_0 then += y_l v_l for l = 1 .. k - 1 in order
  // (the earlier update kernel's order), the later rows loaded GMU_ROWS at
  // a time; ys holds y in shared memory
  __device__ __forceinline__ void finish(const T* V, T* x, const T* ys, int s, long long slab,
                                         long long n, int k) {
    const T* v = V + (long long)s * n;
    T acc[NV][VEC];
    const T y0 = ys[0];
#pragma unroll
    for (int q = 0; q < NV; ++q)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][e] = y0 * vv[0][q][e];
#pragma unroll
    for (int r = 1; r < GMU_ROWS; ++r) {
      if (r < k) {
        const T yl = ys[r];
#pragma unroll
        for (int q = 0; q < NV; ++q)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[q][e] += yl * vv[r][q][e];
      }
    }
    for (int l0 = GMU_ROWS; l0 < k; l0 += GMU_ROWS) {
      rows(v, slab, n, l0, k);
#pragma unroll
      for (int r = 0; r < GMU_ROWS; ++r) {
        if (l0 + r < k) {
          const T yl = ys[l0 + r];
#pragma unroll
          for (int q = 0; q < NV; ++q)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[q][e] += yl * vv[r][q][e];
        }
      }
    }
    T* xs = x + (long long)s * n;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      if (at(q) < n) {
        T out[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[e] = xv[q][e] + acc[q][e];
        gm_stv<T, VEC>(xs + at(q), out);
      }
    }
  }
};

// ys[:k] = y of system s, R[s, :k, :k] y = g[s, :k], by one warp: the
// lanes stage the rows' upper triangles (Rs, k x k) and g (into ys), then
// lane 0 back-substitutes in the earlier kernel's order -- row r from the
// last, acc = g_r, acc -= R[r, l] y_l for l ascending, y_r = acc / R[r, r]
// -- over shared memory.  Called by the 32 threads of one warp.
template <typename T>
__device__ __forceinline__ void gm_backsolve(const T* __restrict__ R, const T* __restrict__ g,
                                             int s, int k, int m, T* Rs, T* ys) {
  const int lane = threadIdx.x & 31, M1 = m + 1;
  const T* Rg = R + (long long)s * M1 * m;
  for (int r = 0; r < k; ++r)
    for (int l = r + lane; l < k; l += 32) Rs[r * k + l] = Rg[r * m + l];
  for (int r = lane; r < k; r += 32) ys[r] = g[(long long)s * M1 + r];
  __syncwarp();
  if (lane == 0) {
    for (int r = k - 1; r >= 0; --r) {
      T acc = ys[r];
      for (int l = r + 1; l < k; ++l) acc -= Rs[r * k + l] * ys[l];
      ys[r] = acc / Rs[r * k + r];
    }
  }
  __syncwarp();
}

// The cycle's end, a block a unit (grid (chunks, mb)): the block reads
// ks[s], issues the loads of x and of its first GMU_ROWS rows, and while
// they are in flight its warp 0 solves system s's triangle in shared
// memory (every block of the system redoes that small solve: no grid
// barrier to wait at); then the sum and the store.  The blocks of chunk 0 write y[s]
// (zero beyond ks).  Nothing else is written for a system with ks = 0.
template <typename T, int VEC>
__global__ void __launch_bounds__(KNP_THREADS)
    gm_solve_update_kernel(const T* __restrict__ R, const T* __restrict__ g,
                           const int* __restrict__ ks, T* __restrict__ y,
                           const T* __restrict__ V, T* __restrict__ x, int mb, long long n,
                           int m) {
  extern __shared__ __align__(16) unsigned char gm_dyn[];
  __shared__ T ys[GM_MAX_ROWS];
  const int s = blockIdx.y, k = ks[s];
  if (k == 0) {
    if (blockIdx.x == 0)
      for (int l = threadIdx.x; l < m; l += KNP_THREADS) y[(long long)s * m + l] = T(0);
    return;
  }
  const long long slab = (long long)mb * n;
  GmUnit<T, VEC> u;
  u.load(V, x, s, blockIdx.x, slab, n, k);
  if (threadIdx.x < 32) gm_backsolve(R, g, s, k, m, reinterpret_cast<T*>(gm_dyn), ys);
  __syncthreads();
  if (blockIdx.x == 0)
    for (int l = threadIdx.x; l < m; l += KNP_THREADS) y[(long long)s * m + l] = l < k ? ys[l] : T(0);
  u.finish(V, x, ys, s, slab, n, k);
}

// ---------------------------------------------------------------------------
// the Arnoldi step
// ---------------------------------------------------------------------------

// One element of w into shared memory, an asynchronous copy of its 4 or 8
// bytes (any alignment of its type); visible to the issuing thread after
// cp.async.wait_all.  Each thread copies the elements it reads back, so no
// block barrier stands between the copy and the use.
template <typename T>
__device__ __forceinline__ void gm_cp_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// The sum gm_dot_kernel's finishing block forms of p[0..nblk) -- thread t adds p[t],
// p[t + 256], ... in order from zero, then knp_block_sum's tree -- replayed
// by one warp: lane l plays thread 32 v + l of each of the eight warps v,
// the eight butterflies (each leaves every lane the same sum) run side by
// side, and the eight sums are added in index order.  Every lane gets the
// sum.  All of a lane's first loads are issued before its first add.  The
// partials were written by other blocks before a grid barrier: read
// through L2.
template <typename T>
__device__ __forceinline__ T gm_finish_warp(const T* p, int nblk) {
  const int lane = threadIdx.x & 31;
  T acc[KNP_WARPS];
#pragma unroll
  for (int v = 0; v < KNP_WARPS; ++v) {
    const int b = 32 * v + lane;
    acc[v] = b < nblk ? __ldcg(p + b) : T(0);
  }
#pragma unroll
  for (int v = 0; v < KNP_WARPS; ++v) acc[v] = T(0) + acc[v];   // the finish's first add
  for (int b0 = KNP_THREADS; b0 < nblk; b0 += KNP_THREADS) {
#pragma unroll
    for (int v = 0; v < KNP_WARPS; ++v) {
      const int b = b0 + 32 * v + lane;
      if (b < nblk) acc[v] += __ldcg(p + b);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int v = 0; v < KNP_WARPS; ++v) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
  }
  T tot = acc[0];
#pragma unroll
  for (int v = 1; v < KNP_WARPS; ++v) tot += acc[v];
  return tot;
}

// out[k ostride] = the block's sum over its chunk (first entry lo) of
// V[k,s,:] . w for k < rows, each as gm_dot_kernel forms its partial: thread
// t adds its products lo + t + 256 e in order from zero, then the warp's
// shuffle tree and the eight warps in index order (knp_block_sum), the rows'
// trees side by side with one block barrier.  Two rows at a time: a
// thread's 16 loads are issued before its adds.  The rows are read from
// the last to the first, so the rows an update has just read in order are
// read first, while they are still in L1 / L2 (each row's sum is its own:
// the order of the rows changes no bit).  wv holds the thread's entries of
// w.  red holds rows x KNP_WARPS values.
template <typename T>
__device__ __forceinline__ void gm_dot_rows(const T* V, const T (&wv)[GM_PER], int s, int mb,
                                            long long n, long long lo, int rows, T* red, T* out,
                                            long long ostride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i0 = lo + threadIdx.x;
  const long long slab = (long long)mb * n;
  const T* v = V + (long long)s * n + i0;
  __syncthreads();                       // red is free
  int k = rows - 1;
  for (; k >= 1; k -= 2) {               // rows k and k - 1
    const T* va = v + k * slab;
    const T* vb = va - slab;
    T xa[GM_PER], xb[GM_PER];
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) {
      const bool in = i0 + e * KNP_THREADS < n;
      xa[e] = in ? va[e * KNP_THREADS] : T(0);
      xb[e] = in ? vb[e * KNP_THREADS] : T(0);
    }
    T a = T(0), b = T(0);
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) {
      if (i0 + e * KNP_THREADS < n) {
        a += xa[e] * wv[e];
        b += xb[e] * wv[e];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      red[k * KNP_WARPS + warp] = a;
      red[(k - 1) * KNP_WARPS + warp] = b;
    }
  }
  if (k == 0) {
    const T* va = v;
    T xa[GM_PER];
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) xa[e] = i0 + e * KNP_THREADS < n ? va[e * KNP_THREADS] : T(0);
    T a = T(0);
#pragma unroll
    for (int e = 0; e < GM_PER; ++e)
      if (i0 + e * KNP_THREADS < n) a += xa[e] * wv[e];
    a = knp_warp_sum(a);
    if (lane == 0) red[warp] = a;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < rows; q += KNP_THREADS) {
    T t = red[q * KNP_WARPS];
    for (int r = 1; r < KNP_WARPS; ++r) t += red[q * KNP_WARPS + r];
    out[q * ostride] = t;
  }
}

// hs[(s - s_lo) m + k] = h[s, k], the sums of the partials of rows k < rows
// for the block's systems s_lo..s_hi, one warp a value; the block holding
// chunk 0 of system s (units u0..u1) also writes them to hout[s (m+1) + k].
template <typename T>
__device__ __forceinline__ void gm_finish_h(const T* part, T* hs, T* hout, int s_lo, int s_hi,
                                            int rows, int m, int nblk, long long u0,
                                            long long u1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = (s_hi - s_lo + 1) * rows;
  for (int q = warp; q < nq; q += KNP_WARPS) {
    const int ss = q / rows, k = q % rows, s = s_lo + ss;
    const T t = gm_finish_warp(part + ((long long)s * m + k) * nblk, nblk);
    if (lane == 0) {
      hs[ss * m + k] = t;
      const long long first = (long long)s * nblk;
      if (first >= u0 && first < u1) hout[(long long)s * (m + 1) + k] = t;
    }
  }
  __syncthreads();
}

// a load, with the streaming (evict-first) hint where it is the last read
template <typename T, bool LAST>
__device__ __forceinline__ T gm_ld(const T* p) {
  return LAST ? __ldcs(p) : *p;
}

// w -= sum_{k < rows} h[k] V[k] over the thread's entries of one chunk, in
// the order of the earlier update kernel (acc = h[0] v[0]; acc += h[k] v[k];
// w = w - acc), two rows' loads issued before their adds; LAST: the rows'
// last pass of the step
template <typename T, bool LAST>
__device__ __forceinline__ void gm_update(const T* V, T (&wv)[GM_PER], const T* h, long long slab,
                                          long long i0, long long n, int rows) {
  T acc[GM_PER];
  const T* v = V + i0;
  const T h0 = h[0];
#pragma unroll
  for (int e = 0; e < GM_PER; ++e) {
    const T ve = i0 + e * KNP_THREADS < n ? gm_ld<T, LAST>(v + e * KNP_THREADS) : T(0);
    acc[e] = h0 * ve;
  }
  int k = 1;
  for (; k + 1 < rows; k += 2) {
    const T* va = v + k * slab;
    const T* vb = va + slab;
    const T ha = h[k], hb = h[k + 1];
    T xa[GM_PER], xb[GM_PER];
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) {
      const bool in = i0 + e * KNP_THREADS < n;
      xa[e] = in ? gm_ld<T, LAST>(va + e * KNP_THREADS) : T(0);
      xb[e] = in ? gm_ld<T, LAST>(vb + e * KNP_THREADS) : T(0);
    }
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) {
      acc[e] += ha * xa[e];
      acc[e] += hb * xb[e];
    }
  }
  if (k < rows) {
    const T* va = v + k * slab;
    const T ha = h[k];
#pragma unroll
    for (int e = 0; e < GM_PER; ++e)
      if (i0 + e * KNP_THREADS < n) acc[e] += ha * gm_ld<T, LAST>(va + e * KNP_THREADS);
  }
#pragma unroll
  for (int e = 0; e < GM_PER; ++e) wv[e] = i0 + e * KNP_THREADS < n ? wv[e] - acc[e] : T(0);
}

// One system's scalar work of step j, in the operation order of
// knpemidg_tpu/solvers/krylov.py:397-439 (h1 and h2 written by other blocks
// before a grid barrier: read through L2)
template <typename T>
__device__ void gm_givens(int s, const T* h1, const T* h2, T hj1, int ldh, T* R, T* g, T* cs,
                          T* sn, int* ks, const T* tol, int m, int j) {
  const int M1 = m + 1;
  T h[GM_MAX_ROWS];
  for (int k = 0; k <= j; ++k)
    h[k] = __ldcg(h1 + (long long)s * ldh + k) + __ldcg(h2 + (long long)s * ldh + k);
  h[j + 1] = hj1;
  for (int k = j + 2; k < M1; ++k) h[k] = T(0);
  T* gs = g + (long long)s * M1;
  T* css = cs + (long long)s * m;
  T* sns = sn + (long long)s * m;
  const T gj = gs[j];
  const bool live = fabs(gj) > tol[s];
  for (int i = 0; i < j; ++i) {                  // replay the stored rotations
    const T c = css[i], sv = sns[i];
    const T hi = c * h[i] + sv * h[i + 1];
    const T hi1 = -sv * h[i] + c * h[i + 1];
    h[i] = hi;
    h[i + 1] = hi1;
  }
  const T hj = h[j], hjp = h[j + 1];
  const T denom = sqrt(hj * hj + hjp * hjp);
  const T dsafe = denom > T(0) ? denom : T(1);
  T c_new = denom > T(0) ? hj / dsafe : T(1);
  T s_new = denom > T(0) ? hjp / dsafe : T(0);
  if (!live) {                                   // freeze: identity rotation
    c_new = T(1);
    s_new = T(0);
  }
  css[j] = c_new;
  sns[j] = s_new;
  h[j] = live ? denom : hj;
  h[j + 1] = T(0);
  gs[j + 1] = live ? -s_new * gj : T(0);
  gs[j] = live ? c_new * gj : gj;
  if (live) {
    for (int k = 0; k < M1; ++k) R[((long long)s * M1 + k) * m + j] = h[k];
    ks[s] += 1;
  }
}

// The cycle's start in one cooperative launch on the Arnoldi step's shape
// (grid, upb, staged of gm_arnoldi_grid), bitwise the earlier three
// launches (the partials, the scale, the scalars):
//   1. each unit's partial of r . r summed as gm_dot_kernel sums its chunk
//      (thread t adds its squares lo + t + 256 e from zero, then the block's
//      tree), the unit's chunk of r kept in shared memory (staged) or read
//      again after the barrier (not);
//   2. a grid barrier; each block's systems' norms (block 0: every system's)
//      the square root of the partials summed in gm_dot_kernel's finishing
//      order (gm_finish_warp, one warp a system);
//   3. block 0: beta, R, cs, sn zero, g = beta e1, ks = 0 and the flag any
//      beta > tol; every block: V[0] = r / (beta > 0 ? beta : 1) over its
//      units.
template <typename T>
__global__ void __launch_bounds__(KNP_THREADS)
    gm_start_kernel(const T* __restrict__ r, T* V, T* part, T* beta, const T* __restrict__ tol,
                    T* R, T* g, T* cs, T* sn, int* ks, int* flag, int mb, long long n, int m,
                    int nblk, int upb, int staged) {
  extern __shared__ __align__(16) unsigned char gm_dyn[];
  __shared__ T red[KNP_WARPS];
  __shared__ T nrm[GM_MAX_SYS];
  T* rst = reinterpret_cast<T*>(gm_dyn);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M1 = m + 1;
  const long long units = (long long)mb * nblk;
  const long long u0 = (long long)blockIdx.x * upb;
  const long long u1 = u0 + upb < units ? u0 + upb : units;
  // the thread's entries of unit u's chunk: in shared memory, or in r
  auto rl = [&](long long u, int e) -> T {
    const long long i = (u % nblk) * GM_CHUNK + tid + e * KNP_THREADS;
    if (staged) return rst[(u - u0) * GM_CHUNK + tid + e * KNP_THREADS];
    return i < n ? r[(u / nblk) * n + i] : T(0);
  };

  for (long long u = u0; u < u1; ++u) {
    const long long i0 = (u % nblk) * GM_CHUNK + tid;
    const T* src = r + (u / nblk) * n + i0;
    T rv[GM_PER];
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) rv[e] = i0 + e * KNP_THREADS < n ? src[e * KNP_THREADS] : T(0);
    T acc = T(0);
#pragma unroll
    for (int e = 0; e < GM_PER; ++e)
      if (i0 + e * KNP_THREADS < n) acc += rv[e] * rv[e];
    if (staged) {
#pragma unroll
      for (int e = 0; e < GM_PER; ++e) rst[(u - u0) * GM_CHUNK + tid + e * KNP_THREADS] = rv[e];
    }
    acc = knp_block_sum(acc, red);
    if (tid == 0) part[u] = acc;                 // (s nblk + b) = u
  }
  cooperative_groups::this_grid().sync();

  const int sa = blockIdx.x == 0 ? 0 : (int)(u0 / nblk);
  const int sb = blockIdx.x == 0 ? mb - 1 : (int)((u1 - 1) / nblk);
  for (int s = sa + warp; s <= sb; s += KNP_WARPS) {
    const T t = sqrt(gm_finish_warp(part + (long long)s * nblk, nblk));
    if (lane == 0) nrm[s] = t;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int q = tid; q < mb * M1 * m; q += KNP_THREADS) R[q] = T(0);
    for (int q = tid; q < mb * M1; q += KNP_THREADS) g[q] = q % M1 == 0 ? nrm[q / M1] : T(0);
    for (int q = tid; q < mb * m; q += KNP_THREADS) {
      cs[q] = T(0);
      sn[q] = T(0);
    }
    for (int q = tid; q < mb; q += KNP_THREADS) {
      ks[q] = 0;
      beta[q] = nrm[q];
    }
    if (tid == 0) {
      int any = 0;
      for (int q = 0; q < mb; ++q) any |= nrm[q] > tol[q];
      *flag = any;
    }
  }
  for (long long u = u0; u < u1; ++u) {
    const int s = (int)(u / nblk);
    const long long i0 = (u % nblk) * GM_CHUNK + tid;
    const T safe = nrm[s] > T(0) ? nrm[s] : T(1);
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) {
      const long long i = i0 + e * KNP_THREADS;
      if (i < n) V[(long long)s * n + i] = rl(u, e) / safe;
    }
  }
}

// Arnoldi step j of the batch, one cooperative launch of at most the
// co-resident blocks.  The work is mb nblk units, unit u = chunk u % nblk
// (GM_CHUNK entries) of system u / nblk; block q takes units q upb ..
// q upb + upb - 1, so it spans systems s_lo..s_hi (one or two, unless the
// chunks are few).  ``staged``: the block's chunks of w live in the dynamic
// shared memory (upb GM_CHUNK values) and w is only read; else w is read
// and updated in place.  The partials: part[0..) the first dot, part[mb m
// nblk..) the second, part[2 mb m nblk..) the norm, each (s m + k) nblk + b.
template <typename T>
__global__ void __launch_bounds__(KNP_THREADS)
    gm_arnoldi_kernel(T* V, T* w, T* part, T* h1, T* h2, T* hj1, const T* __restrict__ tol,
                      T* R, T* g, T* cs, T* sn, int* ks, int* flag, int mb, long long n, int m,
                      int j, int nblk, int upb, int staged) {
  // the loop's exit: a step queued after the flag went 0 writes nothing.
  // Every block reads the flag here, before its first grid barrier; block
  // 0 writes it after the last, so all blocks return or none.
  if (*flag == 0) return;
  extern __shared__ __align__(16) unsigned char gm_dyn[];
  __shared__ T red[GM_MAX_ROWS * KNP_WARPS];
  __shared__ T hjs[GM_MAX_SYS];
  __shared__ int lives[GM_MAX_SYS];
  T* wst = reinterpret_cast<T*>(gm_dyn);
  T* hs = wst + (staged ? (long long)upb * GM_CHUNK : 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = j + 1, M1 = m + 1;
  const long long slab = (long long)mb * n;
  const long long units = (long long)mb * nblk;
  const long long u0 = (long long)blockIdx.x * upb;
  const long long u1 = u0 + upb < units ? u0 + upb : units;
  const int s_lo = (int)(u0 / nblk), s_hi = (int)((u1 - 1) / nblk);
  T* const P1 = part;
  T* const P2 = part + (long long)mb * m * nblk;
  T* const P3 = part + 2LL * mb * m * nblk;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  // the thread's first entry of unit u's chunk of w: staged, or in place
  auto wl = [&](long long u) -> T* {
    return staged ? wst + (u - u0) * GM_CHUNK + tid
                  : w + (u / nblk) * n + (u % nblk) * GM_CHUNK + tid;
  };

  if (staged) {
    for (long long u = u0; u < u1; ++u) {
      const long long i0 = (u % nblk) * GM_CHUNK + tid;
      const T* src = w + (u / nblk) * n + i0;
      T* dst = wl(u);
#pragma unroll
      for (int e = 0; e < GM_PER; ++e)
        if (i0 + e * KNP_THREADS < n) gm_cp_async(dst + e * KNP_THREADS, src + e * KNP_THREADS);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // the live test of the scale, read before block 0 rewrites g
  for (int s = tid; s < mb; s += KNP_THREADS) lives[s] = fabs(g[(long long)s * M1 + j]) > tol[s];
  if (staged) asm volatile("cp.async.wait_all;\n" ::: "memory");

  // 1. the first dot's partials
  for (long long u = u0; u < u1; ++u) {
    const int s = (int)(u / nblk), b = (int)(u % nblk);
    const long long lo = (long long)b * GM_CHUNK;
    const T* wp = wl(u);
    T wv[GM_PER];
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) wv[e] = lo + tid + e * KNP_THREADS < n ? wp[e * KNP_THREADS] : T(0);
    gm_dot_rows(V, wv, s, mb, n, lo, rows, red, P1 + (long long)s * m * nblk + b, nblk);
  }
  grid.sync();

  // 2. h1; w -= h1 V; the second dot's partials
  gm_finish_h(P1, hs, h1, s_lo, s_hi, rows, m, nblk, u0, u1);
  for (long long u = u0; u < u1; ++u) {
    const int s = (int)(u / nblk), b = (int)(u % nblk);
    const long long lo = (long long)b * GM_CHUNK;
    T* wp = wl(u);
    T wv[GM_PER];
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) wv[e] = lo + tid + e * KNP_THREADS < n ? wp[e * KNP_THREADS] : T(0);
    gm_update<T, false>(V + (long long)s * n, wv, hs + (s - s_lo) * m, slab, lo + tid, n, rows);
#pragma unroll
    for (int e = 0; e < GM_PER; ++e)
      if (lo + tid + e * KNP_THREADS < n) wp[e * KNP_THREADS] = wv[e];
    gm_dot_rows(V, wv, s, mb, n, lo, rows, red, P2 + (long long)s * m * nblk + b, nblk);
  }
  grid.sync();

  // 3. h2; w -= h2 V; the norm partials
  gm_finish_h(P2, hs, h2, s_lo, s_hi, rows, m, nblk, u0, u1);
  for (long long u = u0; u < u1; ++u) {
    const int s = (int)(u / nblk), b = (int)(u % nblk);
    const long long lo = (long long)b * GM_CHUNK;
    T* wp = wl(u);
    T wv[GM_PER];
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) wv[e] = lo + tid + e * KNP_THREADS < n ? wp[e * KNP_THREADS] : T(0);
    gm_update<T, true>(V + (long long)s * n, wv, hs + (s - s_lo) * m, slab, lo + tid, n, rows);
    T acc = T(0);
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) {
      if (lo + tid + e * KNP_THREADS < n) {
        wp[e * KNP_THREADS] = wv[e];
        acc += wv[e] * wv[e];
      }
    }
    acc = knp_block_sum(acc, red);
    if (tid == 0) P3[(long long)s * nblk + b] = acc;
  }
  grid.sync();

  // 4. hj1 (block 0: of every system), block 0's scalar work first (the
  //    other blocks meanwhile write their rows), then V[j+1]
  const int sa = blockIdx.x == 0 ? 0 : s_lo, sb = blockIdx.x == 0 ? mb - 1 : s_hi;
  for (int s = sa + warp; s <= sb; s += KNP_WARPS) {
    const T t = sqrt(gm_finish_warp(P3 + (long long)s * nblk, nblk));
    if (lane == 0) hjs[s] = t;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    if (tid < mb) {
      hj1[tid] = hjs[tid];
      gm_givens(tid, h1, h2, hjs[tid], M1, R, g, cs, sn, ks, tol, m, j);
    }
    __syncthreads();
    if (tid == 0) {
      int any = 0;
      for (int q = 0; q < mb; ++q) any |= fabs(g[(long long)q * M1 + j + 1]) > tol[q];
      *flag = any;
    }
  }
  T* vnext = V + (long long)(j + 1) * slab;
  for (long long u = u0; u < u1; ++u) {
    const int s = (int)(u / nblk), b = (int)(u % nblk);
    const long long i0 = (long long)b * GM_CHUNK + tid;
    const T* wp = wl(u);
    const T nrm = hjs[s];
    const T safe = nrm > T(0) ? nrm : T(1);
    const bool keep = lives[s] && nrm > T(1e-300);
#pragma unroll
    for (int e = 0; e < GM_PER; ++e) {
      const long long i = i0 + e * KNP_THREADS;
      if (i < n) vnext[(long long)s * n + i] = keep ? wp[e * KNP_THREADS] / safe : T(0);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// One launch of the dot kernel; the tickets of the rows x mb sums must be 0
template <typename T>
static int gm_dot_launch(const T* V, const T* w, T* partial, int* ticket, T* out, int mb, int n,
                         int rows, int ldo, void* stream) {
  if (mb < 1 || mb > GM_MAX_SYS || n < 1 || rows < 1 || rows > GM_MAX_ROWS || rows > ldo)
    return (int)cudaErrorInvalidValue;
  gm_dot_kernel<T><<<dim3(knp_chunks(n, GM_CHUNK), rows, mb), KNP_THREADS, 0,
                     (cudaStream_t)stream>>>(V, w, partial, ticket, out, mb, n, ldo);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a step block taking upb units: the staged chunks
// of w and the h values of the systems it spans
template <typename T>
static long long gm_arnoldi_smem(int mb, int nblk, int m, long long upb, int staged) {
  const long long nsys = std::min<long long>(mb, (upb - 1) / nblk + 2);
  return ((staged ? upb * GM_CHUNK : 0) + nsys * m) * (long long)sizeof(T);
}

// The cycle's start runs on the step's shape out = {grid, upb, staged}: its
// kernel's shared-memory limit raised to the staged chunks of r if needed
// (never lowered), and the grid checked to be co-resident for it too.
template <typename T>
static int gm_start_fits(const int* out, int sms) {
  const void* fn = (const void*)gm_start_kernel<T>;
  const long long smem = out[2] ? (long long)out[1] * GM_CHUNK * sizeof(T) : 0;
  cudaFuncAttributes attr;
  int per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess && attr.maxDynamicSharedSizeBytes < smem)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, KNP_THREADS, (size_t)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (long long)per_sm * sms >= out[0] ? 0 : (int)cudaErrorNotSupported;
}

// The step's launch shape for mb systems of n entries at restart m on the
// current device, once per work: out = {grid, upb, staged}.  The
// fewest units per block whose grid fits the co-resident limit with the
// block's chunks of w in shared memory (the kernel's limit raised to that
// size if needed, never lowered: it is the kernel's, shared by every work);
// if none fits in a block's 227 KB, the re-read layout (w in device memory)
// on at most the co-resident blocks.  A refused attribute or query clears
// the runtime's last error, or the next launch of any kernel would report it.
template <typename T>
static int gm_arnoldi_grid(int mb, int n, int m, int* out) {
  if (mb < 1 || mb > GM_MAX_SYS || n < 1 || m < 1 || m + 1 > GM_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)gm_arnoldi_kernel<T>;
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (!coop) return (int)cudaErrorNotSupported;
  const int nblk = knp_chunks(n, GM_CHUNK);
  const long long units = (long long)mb * nblk;
  for (long long upb = 1; upb <= units; ++upb) {
    const long long smem = gm_arnoldi_smem<T>(mb, nblk, m, upb, 1);
    if (smem + (long long)attr.sharedSizeBytes > optin) break;
    if (attr.maxDynamicSharedSizeBytes < smem) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
      }
      attr.maxDynamicSharedSizeBytes = (int)smem;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, KNP_THREADS, (size_t)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    const long long grid = (units + upb - 1) / upb;
    if (per_sm >= 1 && grid <= (long long)per_sm * sms) {
      out[0] = (int)grid;
      out[1] = (int)upb;
      out[2] = 1;
      return gm_start_fits<T>(out, sms);
    }
  }
  const long long smem = gm_arnoldi_smem<T>(mb, nblk, m, units, 0);   // every system's h
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, KNP_THREADS, (size_t)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (per_sm < 1) return (int)cudaErrorNotSupported;
  const long long most = std::min(units, (long long)per_sm * sms);
  const long long upb = (units + most - 1) / most;
  out[0] = (int)((units + upb - 1) / upb);
  out[1] = (int)upb;
  out[2] = 0;
  return gm_start_fits<T>(out, sms);
}

// One cooperative launch of step j on the shape from gm_arnoldi_grid; a
// refused launch returns its error and leaves none behind
template <typename T>
static int gm_arnoldi_launch(T* V, T* w, T* part, T* h1, T* h2, T* hj1, const T* tol, T* R,
                             T* g, T* cs, T* sn, int* ks, int* flag, int mb, int n, int m,
                             int j, int grid, int upb, int staged, void* stream) {
  if (mb < 1 || mb > GM_MAX_SYS || n < 1 || m < 1 || m + 1 > GM_MAX_ROWS || j < 0 || j >= m ||
      grid < 1 || upb < 1)
    return (int)cudaErrorInvalidValue;
  int nblk = knp_chunks(n, GM_CHUNK);
  const long long units = (long long)mb * nblk;
  if ((long long)grid * upb < units || (long long)(grid - 1) * upb >= units)
    return (int)cudaErrorInvalidValue;
  const long long smem = gm_arnoldi_smem<T>(mb, nblk, m, upb, staged);
  long long nn = n;
  void* args[] = {(void*)&V,    (void*)&w,   (void*)&part, (void*)&h1,  (void*)&h2,
                  (void*)&hj1,  (void*)&tol, (void*)&R,    (void*)&g,   (void*)&cs,
                  (void*)&sn,   (void*)&ks,  (void*)&flag, (void*)&mb,  (void*)&nn,
                  (void*)&m,    (void*)&j,   (void*)&nblk, (void*)&upb, (void*)&staged};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)gm_arnoldi_kernel<T>, dim3(grid), dim3(KNP_THREADS), args, (size_t)smem,
      (cudaStream_t)stream);
  // a refused launch also sets the runtime's last error: read it here, or
  // the next launch of any kernel would report it
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? (int)e : (int)last;
}

// The cycle's start: one cooperative launch on the step's launch shape from
// gm_arnoldi_grid; a refused launch returns its error and leaves none behind
template <typename T>
static int gm_start_launch(const T* r, T* V, T* part, T* beta, const T* tol, T* R, T* g, T* cs,
                           T* sn, int* ks, int* flag, int mb, int n, int m, int grid, int upb,
                           int staged, void* stream) {
  if (mb < 1 || mb > GM_MAX_SYS || n < 1 || m < 1 || m + 1 > GM_MAX_ROWS || grid < 1 || upb < 1)
    return (int)cudaErrorInvalidValue;
  int nblk = knp_chunks(n, GM_CHUNK);
  const long long units = (long long)mb * nblk;
  if ((long long)grid * upb < units || (long long)(grid - 1) * upb >= units)
    return (int)cudaErrorInvalidValue;
  long long nn = n;
  const size_t smem = staged ? (size_t)upb * GM_CHUNK * sizeof(T) : 0;
  void* args[] = {(void*)&r,  (void*)&V,  (void*)&part, (void*)&beta, (void*)&tol,
                  (void*)&R,  (void*)&g,  (void*)&cs,   (void*)&sn,   (void*)&ks,
                  (void*)&flag, (void*)&mb, (void*)&nn, (void*)&m,    (void*)&nblk,
                  (void*)&upb, (void*)&staged};
  const cudaError_t e =
      cudaLaunchCooperativeKernel((const void*)gm_start_kernel<T>, dim3(grid), dim3(KNP_THREADS),
                                  args, smem, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? (int)e : (int)last;
}

// The cycle's end in one launch, a block a chunk and system (grid (chunks,
// mb)), each block solving its system's triangle (block s solving it once
// behind a grid barrier, a cooperative launch, measured no faster at 4 rows
// in float64 and slower in float32: PERF.md).  16-byte accesses where n is
// a multiple of 16 / sizeof(T) and V and x are aligned to 16 bytes, else
// one entry an access.
template <typename T>
static int gm_solve_update_launch(const T* R, const T* g, const int* ks, T* y, const T* V, T* x,
                                  int mb, int n, int m, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (mb < 1 || mb > GM_MAX_SYS || n < 1 || m < 1 || m + 1 > GM_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const bool vec = n % VEC == 0 && knp_aligned(V, 16) && knp_aligned(x, 16);
  const dim3 grid(knp_chunks(n, GmUnit<T, 1>::CHUNK), mb);
  const size_t smem = (size_t)m * m * sizeof(T);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    gm_solve_update_kernel<T, VEC><<<grid, KNP_THREADS, smem, st>>>(R, g, ks, y, V, x, mb, n, m);
  else
    gm_solve_update_kernel<T, 1><<<grid, KNP_THREADS, smem, st>>>(R, g, ks, y, V, x, mb, n, m);
  return (int)cudaGetLastError();
}

#define GM_ENTRIES(T, SFX)                                                                   \
  extern "C" int knp_gmres_dot_##SFX(const T* V, const T* w, T* partial, int* ticket,      \
                                     T* out, int mb, int n, int rows, int ldo,                \
                                     void* stream) {                                          \
    return gm_dot_launch<T>(V, w, partial, ticket, out, mb, n, rows, ldo, stream);           \
  }                                                                                           \
  extern "C" int knp_gmres_start_##SFX(const T* r, T* V, T* partial, T* beta, const T* tol,  \
                                       T* R, T* g, T* cs, T* sn, int* ks, int* flag, int mb,  \
                                       int n, int m, int grid, int upb, int staged,           \
                                       void* stream) {                                        \
    return gm_start_launch<T>(r, V, partial, beta, tol, R, g, cs, sn, ks, flag, mb, n, m,    \
                              grid, upb, staged, stream);                                     \
  }                                                                                           \
  extern "C" int knp_gmres_arnoldi_grid_##SFX(int mb, int n, int m, int* out) {              \
    return gm_arnoldi_grid<T>(mb, n, m, out);                                                 \
  }                                                                                           \
  extern "C" int knp_gmres_arnoldi_##SFX(T* V, T* w, T* part, T* h1, T* h2, T* hj1,          \
                                         const T* tol, T* R, T* g, T* cs, T* sn, int* ks,     \
                                         int* flag, int mb, int n, int m, int j, int grid,    \
                                         int upb, int staged, void* stream) {                 \
    return gm_arnoldi_launch<T>(V, w, part, h1, h2, hj1, tol, R, g, cs, sn, ks, flag, mb, n, \
                                m, j, grid, upb, staged, stream);                            \
  }                                                                                           \
  extern "C" int knp_gmres_solve_update_##SFX(const T* R, const T* g, const int* ks, T* y,   \
                                              const T* V, T* x, int mb, int n, int m,         \
                                              void* stream) {                                 \
    return gm_solve_update_launch<T>(R, g, ks, y, V, x, mb, n, m, stream);                   \
  }

GM_ENTRIES(float, f32)
GM_ENTRIES(double, f64)
