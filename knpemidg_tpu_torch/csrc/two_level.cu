// Kernels K6 / K7: the coarse and deflation part of the two-level
// preconditioner apply, for m systems (m = 1: the EMI apply, K6; m = ion
// count: the batched KNP apply, K7).
//
// Replaces knpemidg_tpu/solvers/twolevel.py:784 two_level_apply_fn (its
// coarse(r) closure) and :907 two_level_apply_batched (coarse_only), which
// XLA lowers to a sum over nd, a reshape-sum, three dense GEMVs, a one-hot
// projection, skinny einsums and broadcasts.  For system s, with rs[c] =
// sum_i r[s,i,c] and the chunk of cell c = c / agg:
//
//   restrict:  rc[s,a]   = sum_{c in chunk a} rs[c]
//              proj[s,f] = OH[p] . rs  (compartments), W[w] : r[s]
//                          (moment fields), Wr[v] : r[s] (Ritz fields)
//   solve:     z1 = inv (s rc);  t = s rc - As z1;  zc = s (z1 + inv t)
//              (zc = s (inv (s rc)) without As, the KNP case); per
//              deflation group x = sg proj_g, coef_g = sg (Ig x) (the
//              compartment group refined once with its As)
//   prolong:   out[s,i,c] += zc[s, c / agg] + sum_p coef_p OH[p,c]
//                            + sum_w coef_w W[w,i,c] + sum_v coef_v Wr[v,i,c]
//
// added in place into the block-Jacobi apply's output (kernel B stays its
// own launch).
//
// Bound: device-memory bandwidth.  The deflation fields dominate: at the
// cell layout's main path (124,416 cells, nd = 4, 45 moment and 24 Ritz
// fields) W and Wr are 179 and 96 MB in float64, the coarse inv and As
// (1,944^2) 30 MB each, r and out 4-8 MB: about 352 MB, 105 us at
// 3.35 TB/s (half in float32).  Design: restrict and prolong each stream
// the fields once (so W is read twice per apply, about 2x the bound); one
// thread per cell with the cells-last layout keeps every field load
// coalesced.  A restrict block covers whole chunks, so the chunk sums need
// no second pass; the field projections are split over the grid's third
// axis, 8 fields a block, so that enough loads are in flight (one block
// walking all 74 fields waits on a load round trip per field), and reduced
// per block (warp shuffles in a fixed tree, then the warps in order) into
// per-block partials that a second kernel sums in a fixed order.  The
// prolong loops over the fields unrolled by 4 for the same reason; the
// unrolling keeps each sum's order.  No floating-point atomics: the
// results repeat bit for bit from call to call, and so do the Krylov
// counts.  The solve is one launch per apply (the coarse inv and As are
// 1,944^2: 30 MB each in float64, 18 us at 3.35 TB/s for one read of
// each): the dense GEMVs give one warp to a row (coalesced row reads, the
// loads of a batch issued before its adds, a fixed shuffle tree), the
// three dependent products of the refinement are three phases of a
// cooperative launch with a grid barrier between them, inv is read under
// an L2 evict-last policy so that its second read hits L2, and the small
// Galerkin solves (5, 45 and 24 rows) run on otherwise idle blocks during
// the first phase, their vectors in shared memory.  Each row is summed in
// a fixed order: one warp, lanes striding by 32, the same shuffle tree in
// every call.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

#define TL_WARPS (KNP_THREADS / 32)
#define TL_MAX_TILE 1024   // cells a restrict block covers (whole chunks)
#define TL_FIELD_BATCH 32  // field sums reduced per block synchronisation
#define TL_FIELDS_PER_BLOCK 8  // projections a restrict block computes
#define TL_MAX_SMEM 232448     // dynamic shared memory a block can have (227 KB)

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one value per thread over the block, in a fixed order; every
// thread gets the result.  ``red`` holds TL_WARPS values.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T acc = red[0];
  for (int w = 1; w < TL_WARPS; ++w) acc += red[w];
  return acc;
}

// ---------------------------------------------------------------------------
// restrict: chunk sums and per-block partial field projections
// ---------------------------------------------------------------------------

template <typename T, int ND>
__global__ void tl_restrict_kernel(const T* __restrict__ r, const T* __restrict__ OH,
                                   const T* __restrict__ W, const T* __restrict__ Wr,
                                   T* __restrict__ rc, T* __restrict__ partial, int nc,
                                   int agg, int n_agg, int cpt, int n_comp, int nw,
                                   int nr) {
  __shared__ T rs_tile[TL_MAX_TILE];
  __shared__ T red[TL_FIELD_BATCH][TL_WARPS];
  const int s = blockIdx.y, b = blockIdx.x, nblk = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk0 = b * cpt;
  const int nchunks = min(cpt, n_agg - chunk0);
  const int c0 = chunk0 * agg;
  const int tile = nchunks * agg;
  const size_t ncz = (size_t)nc;
  const T* rsys = r + (size_t)s * ND * ncz;

  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int c = c0 + t;
    T v = T(0);                                   // pad cells of the last chunk
    if (c < nc) {
      v = rsys[c];
#pragma unroll
      for (int i = 1; i < ND; ++i) v += rsys[i * ncz + c];
    }
    rs_tile[t] = v;
  }
  __syncthreads();
  if (blockIdx.z == 0 && threadIdx.x < nchunks) {
    const T* p = rs_tile + threadIdx.x * agg;
    T acc = p[0];
    for (int j = 1; j < agg; ++j) acc += p[j];
    rc[(size_t)s * n_agg + chunk0 + threadIdx.x] = acc;
  }

  const int nf = n_comp + nw + nr;
  const int f_hi = min(nf, (int)(blockIdx.z + 1) * TL_FIELDS_PER_BLOCK);
  const int t_end = min(tile, nc - c0);
  for (int f0 = blockIdx.z * TL_FIELDS_PER_BLOCK; f0 < f_hi; f0 += TL_FIELD_BATCH) {
    const int nb = min(TL_FIELD_BATCH, f_hi - f0);
    for (int ff = 0; ff < nb; ++ff) {
      const int f = f0 + ff;
      T acc = T(0);
      if (f < n_comp) {
        const T* oh = OH + (size_t)f * ncz + c0;
        for (int t = threadIdx.x; t < t_end; t += blockDim.x) acc += oh[t] * rs_tile[t];
      } else {
        const T* wf = (f < n_comp + nw) ? W + (size_t)(f - n_comp) * ND * ncz
                                        : Wr + (size_t)(f - n_comp - nw) * ND * ncz;
        for (int t = threadIdx.x; t < t_end; t += blockDim.x) {
          const int c = c0 + t;
          T a = wf[c] * rsys[c];
#pragma unroll
          for (int i = 1; i < ND; ++i) a += wf[i * ncz + c] * rsys[i * ncz + c];
          acc += a;
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) red[ff][warp] = acc;
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      T acc = red[threadIdx.x][0];
      for (int w = 1; w < TL_WARPS; ++w) acc += red[threadIdx.x][w];
      partial[((size_t)s * nf + f0 + threadIdx.x) * nblk + b] = acc;
    }
    __syncthreads();
  }
}

// proj[s,f] = sum over the restrict blocks of partial[s,f,:], fixed order
template <typename T>
__global__ void tl_reduce_kernel(const T* __restrict__ partial, T* __restrict__ proj,
                                 int nf, int nblk) {
  __shared__ T red[TL_WARPS];
  const int f = blockIdx.x, s = blockIdx.y;
  const T* p = partial + ((size_t)s * nf + f) * nblk;
  T acc = T(0);
  for (int j = threadIdx.x; j < nblk; j += blockDim.x) acc += p[j];
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) proj[(size_t)s * nf + f] = acc;
}

// ---------------------------------------------------------------------------
// solve: dense coarse GEMVs and the small deflation solves, one launch
// ---------------------------------------------------------------------------

// The solve's operands, fixed for a whole Krylov solve: the wrapper fills
// this once per solve (ops/coarse.py mirrors it as a ctypes structure),
// knp_tl_solve_prepare sets grid and smem, and every launch passes it by
// value.  As, z1, t are null without the refinement; a deflation group's
// pointers are null when it is absent.
template <typename T>
struct TlSolve {
  const T* inv;    // (m, n, n)
  const T* s;      // (m, n)
  const T* As;     // (m, n, n)
  T* z1;           // (m, n) inv (s rc)
  T* t;            // (m, n) s rc - As z1
  T* zc;           // (m, n) the result
  T* coef;         // (m, nf) the deflation coefficients
  const T* invc;
  const T* sc;
  const T* Asc;
  const T* inv_m;
  const T* s_m;
  const T* inv_r;
  const T* s_r;
  int m, n, n_comp, nw, nr;
  int grid;        // blocks, at most the co-resident limit
  int smem;        // dynamic shared memory bytes (the small solves)
  int pad;
};

// L2 eviction policies: with the refinement the coarse inverse is read
// twice per solve (the first and third products) and kept, As is read once
// and streamed; in float64 the two are 30 MB each, more than the 50 MB L2
// holds together.  Without it inv is read once: kept in float32, where
// the two ions' 30 MB fit L2 and stay there from call to call, read with
// plain loads in float64 (60 MB; any hint measured slower).
__device__ __forceinline__ unsigned long long tl_policy_keep() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ unsigned long long tl_policy_stream() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// a matrix load under L2 policy pol (HINT), or a plain one
template <bool HINT>
__device__ __forceinline__ double tl_load(const double* a, unsigned long long pol) {
  if (!HINT) return *a;
  double v;
  asm("ld.global.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(a), "l"(pol));
  return v;
}

template <bool HINT>
__device__ __forceinline__ float tl_load(const float* a, unsigned long long pol) {
  if (!HINT) return *a;
  float v;
  asm("ld.global.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(a), "l"(pol));
  return v;
}

// Entries of a row a lane loads per batch: 64 bytes of matrix values in
// flight a lane (a 1,944-entry row is 3 batches and a 12-13-entry tail in
// float32, 7 batches and a 4-5-entry tail in float64).
template <typename T>
struct TlBatch {
  static constexpr int U = 64 / sizeof(T);
};

// v[u] = a[lane + 32 u]: a row's first batch, issued ahead (before a grid
// barrier, or before the previous row's epilogue), since the matrix does
// not depend on the previous phase.
template <bool HINT, typename T, int U>
__device__ __forceinline__ void tl_fetch(const T* a, int n, int lane, unsigned long long pol,
                                         T (&v)[U]) {
  if (lane + 32 * (U - 1) >= n) return;       // no full first batch: the tail reads it
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = tl_load<HINT>(a + lane + 32 * u, pol);
}

// acc += the products of the lane's next B entries from j on, if it has
// that many below n, their loads issued before the adds; then the same
// for B / 2, ..., 1: the lane's last (fewer than U) entries in increasing
// j, in a handful of round trips instead of one per entry.
template <typename T, bool XS, bool HINT, int B>
__device__ __forceinline__ void tl_tail(T& acc, const T* a, const T* x, const T* xs, int& j,
                                        int n, unsigned long long pol) {
  if (j + 32 * (B - 1) < n) {
    T v[B], w[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      v[u] = tl_load<HINT>(a + j + 32 * u, pol);
      w[u] = XS ? xs[j + 32 * u] * x[j + 32 * u] : x[j + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < B; ++u) acc += v[u] * w[u];
    j += 32 * B;
  }
  if constexpr (B > 1) tl_tail<T, XS, HINT, B / 2>(acc, a, x, xs, j, n, pol);
}

// One warp's row product sum_j a[j] (xs[j] x[j]) (XS) or sum_j a[j] x[j],
// lane j mod 32 summing its entries in increasing j, then the xor shuffle
// tree (every lane gets the sum); v holds the row's first batch.  The
// loads of a batch of U entries are all issued before its adds, which keep
// the order.  x and xs may have been written earlier in this launch, so
// they are read with plain loads.
template <typename T, bool XS, bool HINT, int U>
__device__ __forceinline__ T tl_row(const T* a, const T* x, const T* xs, int n, int lane,
                                    unsigned long long pol, T (&v)[U]) {
  T acc = T(0);
  int j = lane;
  for (bool first = true; j + 32 * (U - 1) < n; j += 32 * U, first = false) {
    T w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!first) v[u] = tl_load<HINT>(a + j + 32 * u, pol);
      w[u] = XS ? xs[j + 32 * u] * x[j + 32 * u] : x[j + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += v[u] * w[u];
  }
  tl_tail<T, XS, HINT, U / 2>(acc, a, x, xs, j, n, pol);
  return warp_sum(acc);
}

// One phase of the solve: for each row q = s n + row of this warp,
// epi(q, sum_j A[q, j] (xs x)[s, j]), v holding the first batch of the
// warp's first row; each next row's first batch is issued before the
// current row's epilogue.
template <typename T, bool XS, bool HINT, int U, class Epi>
__device__ __forceinline__ void tl_phase(const T* A, const T* x, const T* xs, int rows,
                                         int n, unsigned long long pol, T (&v)[U], Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * TL_WARPS;
  for (int q = blockIdx.x * TL_WARPS + (threadIdx.x >> 5); q < rows; q += warps) {
    const size_t off = (size_t)(q / n) * n;
    const T acc = tl_row<T, XS, HINT>(A + (size_t)q * n, x + off, XS ? xs + off : nullptr, n,
                                      lane, pol, v);
    if (q + warps < rows) tl_fetch<HINT>(A + (size_t)(q + warps) * n, n, lane, pol, v);
    if (lane == 0) epi(q, acc);
  }
}

// y = M x for a k x k matrix in global memory and x, y in shared memory;
// one warp per row.  Ends with a block synchronisation.
template <typename T>
__device__ void small_matvec(const T* __restrict__ M, const T* x, T* y, int k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < k; row += TL_WARPS) {
    const T* a = M + (size_t)row * k;
    T acc = T(0);
    for (int j = lane; j < k; j += 32) acc += a[j] * x[j];
    acc = warp_sum(acc);
    if (lane == 0) y[row] = acc;
  }
  __syncthreads();
}

// The small solve of deflation group g (0 the compartments, with one
// refinement sweep with Asc; 1 the moment fields; 2 the Ritz fields) for
// system s, by the whole block, its vectors in shared memory.
template <typename T>
__device__ void tl_small(const TlSolve<T>& p, const T* __restrict__ proj, int g, int s,
                         T* x) {
  const int nf = p.n_comp + p.nw + p.nr;
  const int k = g == 0 ? p.n_comp : (g == 1 ? p.nw : p.nr);
  if (k == 0) return;
  const int off = g == 0 ? 0 : (g == 1 ? p.n_comp : p.n_comp + p.nw);
  const T* Mi = g == 0 ? p.invc : (g == 1 ? p.inv_m : p.inv_r);
  const T* sg = g == 0 ? p.sc : (g == 1 ? p.s_m : p.s_r);
  T* y = x + k;
  T* t = y + k;
  const T* pr = proj + (size_t)s * nf + off;
  for (int j = threadIdx.x; j < k; j += blockDim.x) x[j] = sg[j] * pr[j];
  __syncthreads();
  small_matvec(Mi, x, y, k);
  if (g == 0) {                       // zc = zc + invc (rsc - Asc zc)
    small_matvec(p.Asc, y, t, k);
    for (int j = threadIdx.x; j < k; j += blockDim.x) t[j] = x[j] - t[j];
    __syncthreads();
    small_matvec(Mi, t, x, k);        // x is free: rsc is no longer needed
    for (int j = threadIdx.x; j < k; j += blockDim.x) y[j] = y[j] + x[j];
    __syncthreads();
  }
  T* out = p.coef + (size_t)s * nf + off;
  for (int j = threadIdx.x; j < k; j += blockDim.x) out[j] = sg[j] * y[j];
  __syncthreads();                    // x, y, t are reused by the next group
}

// The whole solve in one cooperative launch.  The m n rows of all systems
// are spread over the grid's warps, one warp a row; with As the three
// dependent products are three phases with a grid barrier between them:
//   1. z1 = inv (s rc)      2. t = s rc - As z1      3. zc = s (z1 + inv t)
// and without As one phase, zc = s (inv (s rc)).  Each phase's first
// matrix loads are issued before the barrier that precedes it.  The 3 m
// small solves need only proj: the last blocks of the grid (which have no
// rows when the grid is larger than the rows need) run them during phase 1,
// their vectors in dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(KNP_THREADS)
tl_solve_kernel(const TlSolve<T> p, const T* __restrict__ rc, const T* __restrict__ proj) {
  extern __shared__ __align__(16) unsigned char tl_smem[];
  constexpr int U = TlBatch<T>::U;
  const int n = p.n, rows = p.m * p.n;
  const int q0 = blockIdx.x * TL_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const bool refine = p.As != nullptr;
  T v[U];
  // with the refinement inv is kept in L2 for its second read
  const unsigned long long keep = tl_policy_keep();
  if (refine) {
    if (q0 < rows) tl_fetch<true>(p.inv + (size_t)q0 * n, n, lane, keep, v);
    tl_phase<T, true, true>(p.inv, rc, p.s, rows, n, keep, v,
                            [&](int q, T acc) { p.z1[q] = acc; });
  } else {
    // read once: kept where the systems' inverses fit L2 together (float32)
    constexpr bool hint = sizeof(T) == 4;
    if (q0 < rows) tl_fetch<hint>(p.inv + (size_t)q0 * n, n, lane, keep, v);
    tl_phase<T, true, hint>(p.inv, rc, p.s, rows, n, keep, v,
                            [&](int q, T acc) { p.zc[q] = p.s[q] * acc; });
  }
  if (p.n_comp + p.nw + p.nr > 0) {
    for (int task = gridDim.x - 1 - blockIdx.x; task < 3 * p.m; task += gridDim.x)
      tl_small(p, proj, task % 3, task / 3, reinterpret_cast<T*>(tl_smem));
  }
  if (!refine) return;

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const unsigned long long stream = tl_policy_stream();
  if (q0 < rows) tl_fetch<true>(p.As + (size_t)q0 * n, n, lane, stream, v);
  grid.sync();
  // rounded as the plain version: the product s rc, then the difference
  tl_phase<T, false, true>(p.As, p.z1, nullptr, rows, n, stream, v,
                           [&](int q, T acc) { p.t[q] = mul_rn(p.s[q], rc[q]) - acc; });
  if (q0 < rows) tl_fetch<true>(p.inv + (size_t)q0 * n, n, lane, keep, v);
  grid.sync();
  tl_phase<T, false, true>(p.inv, p.t, nullptr, rows, n, keep, v,
                           [&](int q, T acc) { p.zc[q] = p.s[q] * (p.z1[q] + acc); });
}

// ---------------------------------------------------------------------------
// prolong-add
// ---------------------------------------------------------------------------

template <typename T, int ND>
__global__ void tl_prolong_kernel(T* __restrict__ out, const T* __restrict__ zc,
                                  const T* __restrict__ coef, const T* __restrict__ OH,
                                  const T* __restrict__ W, const T* __restrict__ Wr, int nc,
                                  int agg, int n_agg, int n_comp, int nw, int nr) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (c >= nc) return;
  const size_t ncz = (size_t)nc;
  const int nf = n_comp + nw + nr;
  const T* cf = coef + (size_t)s * nf;
  T v = zc[(size_t)s * n_agg + c / agg];
  if (n_comp > 0) {
    T zp = cf[0] * OH[c];
    for (int p = 1; p < n_comp; ++p) zp += cf[p] * OH[(size_t)p * ncz + c];
    v += zp;
  }
  T acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = v;
  if (nw > 0) {
    T am[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) am[i] = T(0);
#pragma unroll 4
    for (int w = 0; w < nw; ++w) {
      const T a = cf[n_comp + w];
      const T* wf = W + (size_t)w * ND * ncz + c;
#pragma unroll
      for (int i = 0; i < ND; ++i) am[i] += a * wf[i * ncz];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] += am[i];
  }
  if (nr > 0) {
    T ar[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) ar[i] = T(0);
#pragma unroll 4
    for (int v2 = 0; v2 < nr; ++v2) {
      const T a = cf[n_comp + nw + v2];
      const T* wf = Wr + (size_t)v2 * ND * ncz + c;
#pragma unroll
      for (int i = 0; i < ND; ++i) ar[i] += a * wf[i * ncz];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] += ar[i];
  }
  T* o = out + (size_t)s * ND * ncz + c;
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i * ncz] = o[i * ncz] + acc[i];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
static int tl_restrict_launch(const T* r, const T* OH, const T* W, const T* Wr, T* rc,
                              T* proj, T* partial, int m, int nd, int nc, int agg,
                              int n_agg, int cpt, int n_comp, int nw, int nr,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cpt * agg > TL_MAX_TILE || cpt < 1) return (int)cudaErrorInvalidValue;
  const int nf = n_comp + nw + nr;
  const dim3 grid((n_agg + cpt - 1) / cpt, m,
                  std::max(1, (nf + TL_FIELDS_PER_BLOCK - 1) / TL_FIELDS_PER_BLOCK));
  if (nd == 4) {
    tl_restrict_kernel<T, 4><<<grid, KNP_THREADS, 0, st>>>(r, OH, W, Wr, rc, partial, nc,
                                                          agg, n_agg, cpt, n_comp, nw, nr);
  } else if (nd == 8) {
    tl_restrict_kernel<T, 8><<<grid, KNP_THREADS, 0, st>>>(r, OH, W, Wr, rc, partial, nc,
                                                          agg, n_agg, cpt, n_comp, nw, nr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  int rc_err = (int)cudaGetLastError();
  if (rc_err != 0 || nf == 0) return rc_err;
  tl_reduce_kernel<T><<<dim3(nf, m), KNP_THREADS, 0, st>>>(partial, proj, nf, grid.x);
  return (int)cudaGetLastError();
}

// The grid (the blocks the rows need plus one for each small solve, at most
// the co-resident limit that a cooperative launch requires) and the shared
// memory of the small solves, for p's sizes on the current device.
template <typename T>
static int tl_solve_prepare(TlSolve<T>* p) {
  const int kmax = std::max(p->n_comp, std::max(p->nw, p->nr));
  const size_t smem = 3 * (size_t)kmax * sizeof(T);
  if (smem > TL_MAX_SMEM || p->m < 1 || p->n < 1) return (int)cudaErrorInvalidValue;
  p->smem = (int)smem;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  // the attribute is the kernel's, shared by every workspace: raised to the
  // most a block can have, never lowered below another workspace's need
  cudaError_t e = smem > 48 * 1024
                      ? cudaFuncSetAttribute(tl_solve_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             TL_MAX_SMEM)
                      : cudaSuccess;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tl_solve_kernel<T>,
                                                      KNP_THREADS, p->smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorNotSupported;
  const long long rows = (long long)p->m * p->n;
  const long long need = (rows + TL_WARPS - 1) / TL_WARPS + (kmax > 0 ? 3 * p->m : 0);
  p->grid = (int)std::min((long long)per_sm * sms, need);
  return 0;
}

// With the refinement a cooperative launch (its grid barriers need every
// block resident); without it (one phase, no barrier) a plain launch.
template <typename T>
static int tl_solve_launch(const TlSolve<T>* p, const T* rc, const T* proj, void* stream) {
  TlSolve<T> prm = *p;
  if (prm.As == nullptr) {
    tl_solve_kernel<T><<<prm.grid, KNP_THREADS, prm.smem, (cudaStream_t)stream>>>(prm, rc, proj);
    return (int)cudaGetLastError();
  }
  void* args[] = {(void*)&prm, (void*)&rc, (void*)&proj};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)tl_solve_kernel<T>, dim3(prm.grid), dim3(KNP_THREADS), args,
      (size_t)prm.smem, (cudaStream_t)stream);
  // a refused launch also sets the runtime's last error: read it here, or
  // the next launch of any kernel would report it
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? (int)e : (int)last;
}

template <typename T>
static int tl_prolong_launch(T* out, const T* zc, const T* coef, const T* OH, const T* W,
                             const T* Wr, int m, int nd, int nc, int agg, int n_agg,
                             int n_comp, int nw, int nr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(knp_blocks(nc), m);
  if (nd == 4) {
    tl_prolong_kernel<T, 4><<<grid, KNP_THREADS, 0, st>>>(out, zc, coef, OH, W, Wr, nc, agg,
                                                         n_agg, n_comp, nw, nr);
  } else if (nd == 8) {
    tl_prolong_kernel<T, 8><<<grid, KNP_THREADS, 0, st>>>(out, zc, coef, OH, W, Wr, nc, agg,
                                                         n_agg, n_comp, nw, nr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#define TL_ENTRIES(T, SFX)                                                               \
  extern "C" int knp_tl_restrict_##SFX(const T* r, const T* OH, const T* W, const T* Wr,  \
                                       T* rc, T* proj, T* partial, int m, int nd, int nc, \
                                       int agg, int n_agg, int cpt, int n_comp, int nw,   \
                                       int nr, void* stream) {                            \
    return tl_restrict_launch<T>(r, OH, W, Wr, rc, proj, partial, m, nd, nc, agg, n_agg, \
                                 cpt, n_comp, nw, nr, stream);                            \
  }                                                                                       \
  extern "C" int knp_tl_solve_prepare_##SFX(void* params) {                              \
    return tl_solve_prepare<T>(static_cast<TlSolve<T>*>(params));                         \
  }                                                                                       \
  extern "C" int knp_tl_solve_##SFX(const void* params, const T* rc, const T* proj,       \
                                    void* stream) {                                       \
    return tl_solve_launch<T>(static_cast<const TlSolve<T>*>(params), rc, proj, stream);  \
  }                                                                                       \
  extern "C" int knp_tl_prolong_##SFX(T* out, const T* zc, const T* coef, const T* OH,    \
                                      const T* W, const T* Wr, int m, int nd, int nc,     \
                                      int agg, int n_agg, int n_comp, int nw, int nr,     \
                                      void* stream) {                                     \
    return tl_prolong_launch<T>(out, zc, coef, OH, W, Wr, m, nd, nc, agg, n_agg, n_comp,  \
                                nw, nr, stream);                                          \
  }

TL_ENTRIES(float, f32)
TL_ENTRIES(double, f64)
