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
// added in place into the block-Jacobi apply's output, times the pair
// layout's live mask where the caller gives one.  Operands without
// deflation fields or As (the KNP apply, K7) take the three steps in one
// cooperative launch instead (tl_coarse_kernel, built for nd = 4 and 8).
// Restrict and prolong take nd = 3 (the 2D DG1 cells, the MMS
// verification path) besides 4 and 8; at nd = 3 every apply takes the
// three steps.
//
// Three-level data (twolevel.py:810-829 and :947-959, build_two_level
// above max_dense: d1inv on the n1 = n_agg level-1 chunks, the dense inv,
// s, As on n2 super-chunks of k2 chunks): restrict and prolong-add are
// unchanged (level-1 chunks); the solve and the one-launch apply stage
// x2 = s rc2, rc2[q] the k2-sum of rc over super-chunk q, in each block's
// shared memory, run the dense products on n2 rows with x2 in place of
// s rc, and end each row with zc[a] = rc[a] d1inv[a] + z2[q] for its k2
// chunks (the one-launch apply prolongs them in the row's warp).  Their
// products and sums are rounded apart (mul_rn, add_rn: this file is built
// with nvcc's default contraction), so ops/coarse.py's ordered twins
// equal them to the last bit.
//
// The folded apply (the cell layout, nd = 4; instantiations BJ = true):
// kernel B's apply does not run; the prolong-add and the one-launch
// apply compute each cell's block-Jacobi values Pinv r themselves
// (bj_block_apply, common.cuh: kernel B's expression and order, so the
// same bits) where they would load out, and write out = Pinv r + the
// corrections.  That drops kernel B's launch and z's write and re-read (8
// values a cell and system); the two-level apply reads Pinv (16 values a
// cell and system) and r once more instead of z.
//
// Bound: device-memory bandwidth.  The deflation fields dominate: at the
// cell layout's main path (124,416 cells, nd = 4, 5 compartments, 45
// moment and 24 Ritz fields) W and Wr are 179 and 96 MB in float64 when
// read whole, the coarse inv and As (1,944^2) 30 MB each, r and out 4-8
// MB.  But a moment field (and a one-hot) is exactly zero outside its
// compartment, and cells are numbered by compartment, so each is nonzero
// on one contiguous cell range: its span [lo, hi), the first and
// one-past-last cell at which any of its nd values is nonzero, computed
// from the values once per frozen two-level data (ops/coarse.py) and
// passed as an int32 (nf, 2) table.  Restrict and prolong read each field
// only in the blocks its span overlaps: 1/5 of W, the Ritz fields (dense)
// whole; about 136 MB a pass in float64, 41 us at 3.35 TB/s.
//
// Design: one thread per cell with the cells-last layout keeps every field
// load coalesced.  A restrict block covers whole chunks (a tile of 256
// cells at the main path), so the chunk sums need no second pass; it
// stages the tile's r and rs = sum_i r in shared memory once, lists the
// fields live in the tile (span overlapping it; ascending, by warp ballots)
// and computes its share of them: the grid's x axis is (tile, slice), the
// slices of a tile adjacent, each slice a contiguous part of the tile's
// live list, so that enough loads are in flight without slices that idle.
// A slice's fields go in batches of 32 / nd, each field reduced over the
// block (warp shuffles in a fixed tree, then the warps in order) into a
// per-block partial; a second kernel sums a field's partials over the
// blocks of its span in a fixed order.  The prolong lists each block's
// live fields the same way and sums them in ascending order, a batch's
// loads written before its adds.  The batch sizes, the slices (3) and the
// load order are the fastest of the variants measured on the H100
// (PERF.md): a thread's round trips to memory, not its bytes, set much of
// the time, and nvcc's register allocation moves with small changes of
// the code.  No floating-point atomics: the results repeat bit for bit
// from call to call, and so do the Krylov counts.
//
// Why the bits equal those of dense passes (every field read at every
// cell).  A (field, block) partial that is computed is computed as the
// dense pass computes it: every cell of the tile, in the same expression
// forms (so nvcc contracts them alike), in the same order; the cells of
// the tile outside the field's span read its zeros.  A skipped term is an
// exact product with zero, +0 or -0: a skipped block's partial (0 + a sum
// of such products, per thread, then the shuffle tree) is exactly +0, and
// the prolong's am / ar accumulators gain only such products over the
// skipped fields.  Every accumulator that loses terms starts at +0, and in
// round-to-nearest x + (+-0) = x for x != 0 and +0 + (+-0) = +0, so an
// accumulator that started at +0 is -0 only if one of its kept terms is
// (a product that underflows to -0); short of that, removing the terms
// leaves every sum bitwise equal, signed zeros and the reduce's +0 start
// included.  The prolong's one-hot loop starts from its first product,
// not from +0, so it stays dense.  NaN and Inf in r no longer reach the
// projections of fields that are zero where r is not finite, but they
// still reach every output through the chunk sums rc and the coarse
// values zc, which stay dense (PCG's breakdown checks see what they saw
// before).
//
// The solve is one launch per apply (the coarse inv and As are
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

// The span of field threadIdx.x of the n in ``spans`` ((0, 0) past n): a
// kernel loads it first, so that its round trip overlaps the kernel's
// other first loads.
__device__ __forceinline__ int2 tl_first_span(const int* __restrict__ spans, int n) {
  return threadIdx.x < n ? make_int2(spans[2 * threadIdx.x], spans[2 * threadIdx.x + 1])
                         : make_int2(0, 0);
}

// Lists in ``list``, in ascending order, each of the n fields f whose span
// (spans[2 f], spans[2 f + 1]) overlaps the cells [c_lo, c_hi); returns the
// count in every thread, and in n_below how many of them are below
// ``split``.  An empty span (0, 0) overlaps nothing.  ``first`` is
// tl_first_span(spans, n).  All threads of the block call it; ``wcnt``
// holds 2 TL_WARPS ints.
__device__ __forceinline__ int tl_live_fields(const int* __restrict__ spans, int n, int split,
                                              int2 first, int c_lo, int c_hi, int* list,
                                              int* wcnt, int& n_below) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int count = 0;
  n_below = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int f = base + threadIdx.x;
    int2 sp = first;
    if (base > 0) sp = f < n ? make_int2(spans[2 * f], spans[2 * f + 1]) : make_int2(0, 0);
    const bool on = sp.x < c_hi && sp.y > c_lo;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    const unsigned below = __ballot_sync(0xffffffffu, on && f < split);
    if (lane == 0) {
      wcnt[warp] = __popc(bal);
      wcnt[TL_WARPS + warp] = __popc(below);
    }
    __syncthreads();
    int off = count;
    for (int w = 0; w < TL_WARPS; ++w) {
      off += w < warp ? wcnt[w] : 0;
      count += wcnt[w];
      n_below += wcnt[TL_WARPS + w];
    }
    if (on) list[off + __popc(bal & ((1u << lane) - 1u))] = f;
    __syncthreads();
  }
  return count;
}

// Fields a restrict slice reduces per block synchronisation: 32 field
// values a thread (16 fields of nd = 4 in float32 measured slower)
template <int ND>
struct TlBatchFields {
  static constexpr int F = 32 / ND;
};

// Block (tile b, slice z) of system s; dynamic shared memory: rs (tile),
// r (ND x tile) and the live list (nf ints) with fields, rs alone without.
template <typename T, int ND>
__global__ void __launch_bounds__(KNP_THREADS)
tl_restrict_kernel(const T* __restrict__ r, const T* __restrict__ OH,
                   const T* __restrict__ W, const T* __restrict__ Wr,
                   const int* __restrict__ spans, T* __restrict__ rc,
                   T* __restrict__ partial, int nc, int agg, int n_agg, int cpt, int n_comp,
                   int nw, int nr, int zs) {
  constexpr int FB = TlBatchFields<ND>::F;
  extern __shared__ __align__(16) unsigned char tl_smem[];
  __shared__ T red[FB][TL_WARPS];
  __shared__ int wcnt[2 * TL_WARPS];
  const int s = blockIdx.y, b = blockIdx.x / zs, z = blockIdx.x % zs, nblk = gridDim.x / zs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nf = n_comp + nw + nr;
  const int tile_max = cpt * agg;
  const int chunk0 = b * cpt;
  const int nchunks = min(cpt, n_agg - chunk0);
  const int c0 = chunk0 * agg;
  const int tile = nchunks * agg;
  const size_t ncz = (size_t)nc;
  const T* rsys = r + (size_t)s * ND * ncz;
  T* rs_tile = reinterpret_cast<T*>(tl_smem);
  T* r_tile = rs_tile + tile_max;                 // r[i] of tile cell t at i * tile_max + t
  int* live = reinterpret_cast<int*>(r_tile + (nf > 0 ? ND * tile_max : 0));

  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int c = c0 + t;
    T v = T(0);                                   // pad cells of the last chunk
    if (c < nc) {
      v = rsys[c];
      if (nf > 0) r_tile[t] = v;
#pragma unroll
      for (int i = 1; i < ND; ++i) {
        const T x = rsys[i * ncz + c];
        if (nf > 0) r_tile[i * tile_max + t] = x;
        v += x;
      }
    }
    rs_tile[t] = v;
  }
  __syncthreads();
  if (z == 0 && threadIdx.x < nchunks) {
    const T* p = rs_tile + threadIdx.x * agg;
    T acc = p[0];
    for (int j = 1; j < agg; ++j) acc += p[j];
    rc[(size_t)s * n_agg + chunk0 + threadIdx.x] = acc;
  }
  if (nf == 0) return;

  // the fields live in the tile: the one-hots first, then W and Wr
  const int t_end = min(tile, nc - c0);
  int n_oh;
  const int2 first = tl_first_span(spans, nf);
  const int n_live = tl_live_fields(spans, nf, n_comp, first, c0, c0 + t_end, live, wcnt, n_oh);
  // this slice's part of the list
  const int per = (n_live + zs - 1) / zs;
  const int i_beg = min(n_live, z * per), i_end = min(n_live, i_beg + per);
  T* part = partial + (size_t)s * nf * nblk + b;

  for (int i = i_beg; i < min(i_end, n_oh); ++i) {
    const T* oh = OH + (size_t)live[i] * ncz + c0;
    T acc = T(0);
    for (int t = threadIdx.x; t < t_end; t += blockDim.x) acc += oh[t] * rs_tile[t];
    acc = warp_sum(acc);
    if (lane == 0) red[0][warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      T x = red[0][0];
      for (int w = 1; w < TL_WARPS; ++w) x += red[0][w];
      part[(size_t)live[i] * nblk] = x;
    }
    __syncthreads();
  }

  for (int i0 = max(i_beg, n_oh); i0 < i_end; i0 += FB) {
    const int nb = min(FB, i_end - i0);
    const T* wp[FB];
#pragma unroll
    for (int k = 0; k < FB; ++k) {              // past nb: the batch's last field again
      const int f = live[min(i0 + k, i_end - 1)];
      wp[k] = f < n_comp + nw ? W + (size_t)(f - n_comp) * ND * ncz
                              : Wr + (size_t)(f - n_comp - nw) * ND * ncz;
    }
    T acc[FB];
#pragma unroll
    for (int k = 0; k < FB; ++k) acc[k] = T(0);
    for (int t = threadIdx.x; t < t_end; t += blockDim.x) {
      const int c = c0 + t;
#pragma unroll
      for (int k = 0; k < FB; ++k) {
        T a = wp[k][c] * r_tile[t];
#pragma unroll
        for (int i = 1; i < ND; ++i) a += wp[k][i * ncz + c] * r_tile[i * tile_max + t];
        acc[k] += a;
      }
    }
#pragma unroll
    for (int k = 0; k < FB; ++k) {
      if (k < nb) {
        const T v = warp_sum(acc[k]);
        if (lane == 0) red[k][warp] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      T x = red[threadIdx.x][0];
      for (int w = 1; w < TL_WARPS; ++w) x += red[threadIdx.x][w];
      part[(size_t)live[i0 + threadIdx.x] * nblk] = x;
    }
    __syncthreads();
  }
}

// proj[s,f] = sum of partial[s,f,:] over the restrict blocks of f's span
// (the others were not written: their partials are exactly +0), in the
// fixed order of the sum over all blocks: thread x takes the blocks j = x
// mod blockDim in increasing j, then the block sum.
template <typename T>
__global__ void tl_reduce_kernel(const T* __restrict__ partial, const int* __restrict__ spans,
                                 T* __restrict__ proj, int nf, int nblk, int tile_cells) {
  __shared__ T red[TL_WARPS];
  const int f = blockIdx.x, s = blockIdx.y;
  const T* p = partial + ((size_t)s * nf + f) * nblk;
  const int lo = spans[2 * f], hi = spans[2 * f + 1];
  const int b_lo = lo / tile_cells, b_hi = hi > lo ? (hi - 1) / tile_cells + 1 : b_lo;
  const int bd = blockDim.x;
  T acc = T(0);
  for (int j = b_lo + ((int)threadIdx.x - b_lo % bd + bd) % bd; j < b_hi; j += bd) acc += p[j];
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
  const T* d1inv;  // (m, n1) the three-level data's level-1 Jacobi sweep, else null
  int m, n, n_comp, nw, nr;   // n: the dense system's rows (n2 when three-level)
  int grid;        // blocks, at most the co-resident limit
  int smem;        // dynamic shared memory bytes (the small solves, x2)
  int n1;          // chunks (n_agg; n when two-level)
  int k2;          // chunks a dense row sums (1 when two-level)
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
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

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
template <typename T, bool XS, bool HINT, bool EX, int B>
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
    for (int u = 0; u < B; ++u) {
      if constexpr (EX) {
        acc = add_rn(acc, mul_rn(v[u], w[u]));
      } else {
        acc += v[u] * w[u];
      }
    }
    j += 32 * B;
  }
  if constexpr (B > 1) tl_tail<T, XS, HINT, EX, B / 2>(acc, a, x, xs, j, n, pol);
}

// One warp's row product sum_j a[j] (xs[j] x[j]) (XS) or sum_j a[j] x[j],
// lane j mod 32 summing its entries in increasing j, then the xor shuffle
// tree (every lane gets the sum); v holds the row's first batch.  The
// loads of a batch of U entries are all issued before its adds, which keep
// the order.  x and xs may have been written earlier in this launch, so
// they are read with plain loads.  EX: each product and sum rounded apart
// (never a fused multiply-add), the three-level forms' arithmetic, which
// their ordered twins reproduce bit for bit.
template <typename T, bool XS, bool HINT, bool EX = false, int U>
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
    for (int u = 0; u < U; ++u) {
      if constexpr (EX) {
        acc = add_rn(acc, mul_rn(v[u], w[u]));
      } else {
        acc += v[u] * w[u];
      }
    }
  }
  tl_tail<T, XS, HINT, EX, U / 2>(acc, a, x, xs, j, n, pol);
  return warp_sum(acc);
}

// One phase of the solve: for each row q = s n + row of this warp,
// epi(q, sum_j A[q, j] (xs x)[s, j]), v holding the first batch of the
// warp's first row; each next row's first batch is issued before the
// current row's epilogue.  EX (the three-level forms): the row product
// rounded apart (tl_row), and every lane calls epi(q, sum, lane).
template <typename T, bool XS, bool HINT, bool EX = false, int U, class Epi>
__device__ __forceinline__ void tl_phase(const T* A, const T* x, const T* xs, int rows,
                                         int n, unsigned long long pol, T (&v)[U], Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * TL_WARPS;
  for (int q = blockIdx.x * TL_WARPS + (threadIdx.x >> 5); q < rows; q += warps) {
    const size_t off = (size_t)(q / n) * n;
    const T acc = tl_row<T, XS, HINT, EX>(A + (size_t)q * n, x + off, XS ? xs + off : nullptr,
                                          n, lane, pol, v);
    if (q + warps < rows) tl_fetch<HINT>(A + (size_t)(q + warps) * n, n, lane, pol, v);
    if constexpr (EX) {
      epi(q, acc, lane);
    } else {
      if (lane == 0) epi(q, acc);
    }
  }
}

// The three-level forms' x2 = s rc2 of all m systems into shared memory
// (m n values), by the whole block: rc2[q] the sum of row q's k2 level-1
// chunk sums in ascending order from the first (+0 for a chunk past n1),
// each sum and the product rounded apart.  Ends with a block
// synchronisation.
template <typename T>
__device__ __forceinline__ void tl_stage_x2(const TlSolve<T>& p, const T* rc, T* x2) {
  const int rows = p.m * p.n;
  for (int q = threadIdx.x; q < rows; q += blockDim.x) {
    const int s = q / p.n, a0 = (q % p.n) * p.k2;
    const T* r = rc + (size_t)s * p.n1 + a0;
    const int cnt = min(p.k2, p.n1 - a0);
    T acc = r[0];
    for (int j = 1; j < p.k2; ++j) acc = add_rn(acc, j < cnt ? r[j] : T(0));
    x2[q] = mul_rn(p.s[q], acc);
  }
  __syncthreads();
}

// zc of the level-1 chunks of dense row q (system q / n) from its value
// z2: zc[a] = rc[a] d1inv[a] + z2 (rounded apart), a lane a chunk.
template <typename T>
__device__ __forceinline__ void tl_levels(const TlSolve<T>& p, const T* rc, int q, T z2,
                                          int lane) {
  const int s = q / p.n, a0 = (q % p.n) * p.k2, a1 = min(p.n1, a0 + p.k2);
  const size_t off = (size_t)s * p.n1;
  for (int a = a0 + lane; a < a1; a += 32)
    p.zc[off + a] = add_rn(mul_rn(rc[off + a], p.d1inv[off + a]), z2);
}

// y = M x for a k x k matrix in global memory and x, y in shared memory;
// one warp per row (EX: products and sums rounded apart).  Ends with a
// block synchronisation.
template <typename T, bool EX = false>
__device__ void small_matvec(const T* __restrict__ M, const T* x, T* y, int k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < k; row += TL_WARPS) {
    const T* a = M + (size_t)row * k;
    T acc = T(0);
    for (int j = lane; j < k; j += 32) {
      if constexpr (EX) {
        acc = add_rn(acc, mul_rn(a[j], x[j]));
      } else {
        acc += a[j] * x[j];
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[row] = acc;
  }
  __syncthreads();
}

// The small solve of deflation group g (0 the compartments, with one
// refinement sweep with Asc; 1 the moment fields; 2 the Ritz fields) for
// system s, by the whole block, its vectors in shared memory (EX:
// small_matvec's products and sums rounded apart).
template <typename T, bool EX = false>
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
  small_matvec<T, EX>(Mi, x, y, k);
  if (g == 0) {                       // zc = zc + invc (rsc - Asc zc)
    small_matvec<T, EX>(p.Asc, y, t, k);
    for (int j = threadIdx.x; j < k; j += blockDim.x) t[j] = x[j] - t[j];
    __syncthreads();
    small_matvec<T, EX>(Mi, t, x, k);  // x is free: rsc is no longer needed
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
//
// THREE (three-level data, d1inv): the dense system has n = n2 rows on
// super-chunks of k2 level-1 chunks.  Each block first stages x2 = s rc2
// of all systems in shared memory (tl_stage_x2: rc2 the k2-sums of rc),
// the rows' first matrix loads already issued; the phases read x2 in
// place of s rc:  1. z1 = inv x2   2. t = x2 - As z1   3. z2 = s (z1 + inv t)
// (without As z2 = s (inv x2)), and the last phase's epilogue writes the
// row's k2 level-1 values zc[a] = rc[a] d1inv[a] + z2, a lane a chunk
// (tl_levels).  Every product and sum of these forms is rounded apart,
// small solves included, so coarse.solve_ordered_plain equals them to the
// last bit.
template <typename T, bool THREE>
__global__ void __launch_bounds__(KNP_THREADS)
tl_solve_kernel(const TlSolve<T> p, const T* __restrict__ rc, const T* __restrict__ proj) {
  extern __shared__ __align__(16) unsigned char tl_smem[];
  constexpr int U = TlBatch<T>::U;
  const int n = p.n, rows = p.m * p.n;
  const int q0 = blockIdx.x * TL_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const bool refine = p.As != nullptr;
  T* x2 = reinterpret_cast<T*>(tl_smem);         // THREE: m n values
  T* sv = THREE ? x2 + rows : x2;                // the small solves' vectors
  T v[U];
  // with the refinement inv is kept in L2 for its second read
  const unsigned long long keep = tl_policy_keep();
  if constexpr (THREE) {
    constexpr bool hint1 = sizeof(T) == 4;
    if (refine) {
      if (q0 < rows) tl_fetch<true>(p.inv + (size_t)q0 * n, n, lane, keep, v);
      tl_stage_x2(p, rc, x2);
      tl_phase<T, false, true, true>(p.inv, x2, nullptr, rows, n, keep, v,
                                     [&](int q, T acc, int l) { if (l == 0) p.z1[q] = acc; });
    } else {
      if (q0 < rows) tl_fetch<hint1>(p.inv + (size_t)q0 * n, n, lane, keep, v);
      tl_stage_x2(p, rc, x2);
      tl_phase<T, false, hint1, true>(p.inv, x2, nullptr, rows, n, keep, v,
                                      [&](int q, T acc, int l) {
                                        tl_levels(p, rc, q, mul_rn(p.s[q], acc), l);
                                      });
    }
  } else if (refine) {
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
      tl_small<T, THREE>(p, proj, task % 3, task / 3, sv);
  }
  if (!refine) return;

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const unsigned long long stream = tl_policy_stream();
  if (q0 < rows) tl_fetch<true>(p.As + (size_t)q0 * n, n, lane, stream, v);
  grid.sync();
  if constexpr (THREE) {
    tl_phase<T, false, true, true>(p.As, p.z1, nullptr, rows, n, stream, v,
                                   [&](int q, T acc, int l) {
                                     if (l == 0) p.t[q] = x2[q] - acc;
                                   });
    if (q0 < rows) tl_fetch<true>(p.inv + (size_t)q0 * n, n, lane, keep, v);
    grid.sync();
    tl_phase<T, false, true, true>(p.inv, p.t, nullptr, rows, n, keep, v,
                                   [&](int q, T acc, int l) {
                                     tl_levels(p, rc, q, mul_rn(p.s[q], add_rn(p.z1[q], acc)),
                                               l);
                                   });
    return;
  }
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

// acc[i] += a_f * F[f, i, c] over the fields f = list[j] - off, j in
// [j_beg, j_end), in that order, a_f = cf[f]: in batches of 256 bytes of
// field values a thread (128 measured slower), a batch's loads written
// before its adds (a batch past j_end repeats its last field and drops
// it).
template <typename T, int ND>
__device__ __forceinline__ void tl_prolong_fields(T (&acc)[ND], const int* list, int j_beg,
                                                  int j_end, int off, const T* __restrict__ cf,
                                                  const T* __restrict__ F, size_t ncz, int c) {
  constexpr int U = 256 / (ND * (int)sizeof(T));
  for (int j0 = j_beg; j0 < j_end; j0 += U) {
    T a[U], wv[U][ND];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int f = list[min(j0 + k, j_end - 1)] - off;
      a[k] = cf[f];
      const T* wf = F + (size_t)f * ND * ncz + c;
#pragma unroll
      for (int i = 0; i < ND; ++i) wv[k][i] = wf[i * ncz];
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (j0 + k < j_end) {
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] += a[k] * wv[k][i];
      }
    }
  }
}

// One thread a cell.  The block lists the W and Wr fields whose span
// overlaps its cells (dynamic shared memory: nw + nr ints) and sums only
// those, in ascending order; the one-hot loop stays dense (see the header).
// With a live mask (nd, nc), shared by the systems, each output is the sum
// times its mask value: the pair layout's masked apply, in one pass.
// The loads that need no list (out, zc, the one-hots) are issued before
// the list is built, and the fields go in batches of loads: a thread's
// dependent round trips to memory, not its bytes, set the time.  BJ (the
// folded apply, nd = 4): out is not read; the cell's block-Jacobi values
// Pinv r (bj_block_apply, K5's arithmetic) take its place, so z never goes
// through memory.
template <typename T, int ND, bool BJ>
__global__ void tl_prolong_kernel(T* __restrict__ out, const T* __restrict__ zc,
                                  const T* __restrict__ coef, const T* __restrict__ OH,
                                  const T* __restrict__ W, const T* __restrict__ Wr,
                                  const int* __restrict__ spans, const T* __restrict__ mask,
                                  const T* __restrict__ Pinv, const T* __restrict__ r,
                                  int nc, int agg, int n_agg, int n_comp, int nw, int nr) {
  extern __shared__ int tl_live[];
  __shared__ int wcnt[2 * TL_WARPS];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  const int2 first = tl_first_span(spans + 2 * n_comp, nw + nr);
  const size_t ncz = (size_t)nc;
  const int nf = n_comp + nw + nr;
  const T* cf = coef + (size_t)s * nf;
  T* o = out + (size_t)s * ND * ncz + c;
  T ov[ND];
  T v = T(0);
  if (c < nc) {
    if constexpr (BJ) {
      bj_block_apply<T, ND>(Pinv + (size_t)s * ND * ND * ncz, r + (size_t)s * ND * ncz, ov, c,
                            ncz);
    } else {
#pragma unroll
      for (int i = 0; i < ND; ++i) ov[i] = o[i * ncz];
    }
    v = zc[(size_t)s * n_agg + c / agg];
    if (n_comp > 0) {
      T zp = cf[0] * OH[c];
#pragma unroll 8
      for (int p = 1; p < n_comp; ++p) zp += cf[p] * OH[(size_t)p * ncz + c];
      v += zp;
    }
  }
  const int c_lo = blockIdx.x * blockDim.x, c_hi = min(nc, c_lo + (int)blockDim.x);
  int n_lw;                                      // the list: W's, then Wr's (+ nw)
  const int n_live = tl_live_fields(spans + 2 * n_comp, nw + nr, nw, first, c_lo, c_hi, tl_live,
                                    wcnt, n_lw);
  if (c >= nc) return;
  T acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = v;
  if (nw > 0) {
    T am[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) am[i] = T(0);
    tl_prolong_fields<T, ND>(am, tl_live, 0, n_lw, 0, cf + n_comp, W, ncz, c);
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] += am[i];
  }
  if (nr > 0) {
    T ar[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) ar[i] = T(0);
    tl_prolong_fields<T, ND>(ar, tl_live, n_lw, n_live, nw, cf + n_comp + nw, Wr, ncz, c);
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] += ar[i];
  }
  if (mask) {
#pragma unroll
    for (int i = 0; i < ND; ++i) o[i * ncz] = (ov[i] + acc[i]) * mask[i * ncz + c];
  } else {
#pragma unroll
    for (int i = 0; i < ND; ++i) o[i * ncz] = ov[i] + acc[i];
  }
}

// ---------------------------------------------------------------------------
// the one-launch coarse apply: operands without deflation fields or As (K7)
// ---------------------------------------------------------------------------

// Phase 1: the chunk sums rc of tiles of cpt chunks over the grid (tile b
// of system s = b / tiles a system), as tl_restrict_kernel computes them
// without fields: each cell's sum over i in order, then each chunk's sum
// in cell order, the last chunk's pad cells adding +0.
template <typename T, int ND>
__device__ __forceinline__ void tl_chunk_sums(const T* __restrict__ r, T* __restrict__ rc,
                                              T* rs_tile, int m, int nc, int agg, int n_agg,
                                              int cpt) {
  const int nblk = (n_agg + cpt - 1) / cpt;
  const size_t ncz = (size_t)nc;
  for (int b = blockIdx.x; b < m * nblk; b += gridDim.x) {
    const int s = b / nblk, chunk0 = (b % nblk) * cpt;
    const int nchunks = min(cpt, n_agg - chunk0);
    const int c0 = chunk0 * agg, tile = nchunks * agg;
    const T* rsys = r + (size_t)s * ND * ncz;
    for (int t = threadIdx.x; t < tile; t += blockDim.x) {
      const int c = c0 + t;
      T v = T(0);                                 // pad cells of the last chunk
      if (c < nc) {
        v = rsys[c];
#pragma unroll
        for (int i = 1; i < ND; ++i) {
          const T x = rsys[i * ncz + c];
          v += x;
        }
      }
      rs_tile[t] = v;
    }
    __syncthreads();
    if (threadIdx.x < nchunks) {
      const T* q = rs_tile + threadIdx.x * agg;
      T acc = q[0];
      for (int j = 1; j < agg; ++j) acc += q[j];
      rc[(size_t)s * n_agg + chunk0 + threadIdx.x] = acc;
    }
    __syncthreads();                              // rs_tile is reused by the next tile
  }
}

// restrict, solve and prolong-add of the KNP apply in one cooperative
// launch, out = (out + zc[c / agg]) (* mask):
//   1. rc, the chunk sums of r (restrict without fields);
//   2. after a grid barrier, zc = s (inv (s rc)), a warp a coarse row:
//      the solve kernel's row product (tl_row) unchanged, its first matrix
//      loads issued before the barrier and each next row's before the
//      current row's epilogue, as tl_phase does;
//   3. in the same warp, right after its row: the prolong-add of that
//      row's chunk (its agg cells, nd values each) into out in place, each
//      value times the live mask (nd, nc) where one is given.  A chunk's
//      cells need only their own row, so no second barrier.  BJ (the
//      folded apply, nd = 4): out is not read; each lane computes its
//      cells' block-Jacobi values Pinv r (bj_block_apply, K5's arithmetic;
//      r is still in L2 from phase 1), a cell's nd rows in the lane's inner
//      loop so that Pinv's nd^2 rows load coalesced across the warp, and
//      writes them + zc.
// Each phase computes its values as the separate kernels do (the same
// expressions, the same orders; the xor shuffle tree leaves every lane the
// same row sum), so the outputs equal theirs bit for bit; rc and zc go
// through the workspace's buffers.
//
// THREE (three-level data, d1inv; dynamic shared memory m n values): after
// the barrier each block stages x2 = s rc2 (tl_stage_x2), and the warp of
// dense row q (n = n2 rows a system) computes z2 = s (inv x2)[q], writes
// its k2 level-1 values zc[a] = rc[a] d1inv[a] + z2 (tl_levels) and
// prolongs them over the row's k2 agg cells, each lane recomputing its
// cell's chunk value the same way; every product and sum rounded apart,
// as the three-level solve kernel computes them.
template <typename T, int ND, bool BJ, bool THREE>
__global__ void __launch_bounds__(KNP_THREADS)
tl_coarse_kernel(const TlSolve<T> p, const T* __restrict__ r, T* __restrict__ out,
                 const T* __restrict__ mask, T* __restrict__ rc, const T* __restrict__ Pinv,
                 int nc, int agg, int cpt) {
  __shared__ T rs_tile[TL_MAX_TILE];
  constexpr int U = TlBatch<T>::U;
  constexpr bool hint = sizeof(T) == 4;           // as tl_solve_kernel without As
  const int n = p.n, rows = p.m * p.n;
  const int q0 = blockIdx.x * TL_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int warps = gridDim.x * TL_WARPS;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  tl_chunk_sums<T, ND>(r, rc, rs_tile, p.m, nc, agg, THREE ? p.n1 : n, cpt);
  T v[U];
  const unsigned long long keep = tl_policy_keep();
  if (q0 < rows) tl_fetch<hint>(p.inv + (size_t)q0 * n, n, lane, keep, v);
  grid.sync();
  const size_t ncz = (size_t)nc;
  if constexpr (THREE) {
    extern __shared__ __align__(16) unsigned char tl_smem[];
    T* x2 = reinterpret_cast<T*>(tl_smem);
    tl_stage_x2(p, rc, x2);
    for (int q = q0; q < rows; q += warps) {
      const int s = q / n;
      const T acc = tl_row<T, false, hint, true>(p.inv + (size_t)q * n, x2 + (size_t)s * n,
                                                 nullptr, n, lane, keep, v);
      if (q + warps < rows) tl_fetch<hint>(p.inv + (size_t)(q + warps) * n, n, lane, keep, v);
      const T z2 = mul_rn(p.s[q], acc);
      tl_levels(p, rc, q, z2, lane);
      const int a0 = (q % n) * p.k2;
      const int c0 = a0 * agg, c1 = min(nc, min(p.n1, a0 + p.k2) * agg);
      const T* rcs = rc + (size_t)s * p.n1;
      const T* d1s = p.d1inv + (size_t)s * p.n1;
      T* o = out + (size_t)s * ND * ncz;
      for (int c = c0 + lane; c < c1; c += 32) {
        const int a = c / agg;
        const T z = add_rn(mul_rn(rcs[a], d1s[a]), z2);
        T zv[ND];
        if constexpr (BJ) {
          bj_block_apply<T, ND>(Pinv + (size_t)s * ND * ND * ncz, r + (size_t)s * ND * ncz, zv,
                                c, ncz);
        } else {
#pragma unroll
          for (int i = 0; i < ND; ++i) zv[i] = o[i * ncz + c];
        }
#pragma unroll
        for (int i = 0; i < ND; ++i)
          o[i * ncz + c] = mask ? (zv[i] + z) * mask[i * ncz + c] : zv[i] + z;
      }
    }
    return;
  }
  for (int q = q0; q < rows; q += warps) {
    const int s = q / n, a = q % n;
    const size_t off = (size_t)s * n;
    const T acc = tl_row<T, true, hint>(p.inv + (size_t)q * n, rc + off, p.s + off, n, lane,
                                        keep, v);
    if (q + warps < rows) tl_fetch<hint>(p.inv + (size_t)(q + warps) * n, n, lane, keep, v);
    // rounded as the solve kernel stores zc, never contracted into the adds
    const T z = mul_rn(p.s[q], acc);
    if (lane == 0) p.zc[q] = z;
    const int c0 = a * agg, c1 = min(nc, c0 + agg);
    T* o = out + (size_t)s * ND * ncz;
    if constexpr (BJ) {
      const T* Ps = Pinv + (size_t)s * ND * ND * ncz;
      const T* rsys = r + (size_t)s * ND * ncz;
      for (int c = c0 + lane; c < c1; c += 32) {
        T zv[ND];
        bj_block_apply<T, ND>(Ps, rsys, zv, c, ncz);
#pragma unroll
        for (int i = 0; i < ND; ++i)
          o[i * ncz + c] = mask ? (zv[i] + z) * mask[i * ncz + c] : zv[i] + z;
      }
    } else {
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        for (int c = c0 + lane; c < c1; c += 32) {
          const T ov = o[i * ncz + c];
          o[i * ncz + c] = mask ? (ov + z) * mask[i * ncz + c] : ov + z;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Dynamic shared memory of a restrict block: rs of a tile, and with fields
// r of the tile and the live list
template <typename T>
static size_t tl_restrict_smem(int nd, int tile, int nf) {
  return (size_t)tile * sizeof(T) + (nf > 0 ? (size_t)nd * tile * sizeof(T) + nf * sizeof(int) : 0);
}

template <typename T>
static int tl_restrict_launch(const T* r, const T* OH, const T* W, const T* Wr, const int* spans,
                              T* rc, T* proj, T* partial, int m, int nd, int nc, int agg,
                              int n_agg, int cpt, int n_comp, int nw, int nr, int zs,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nf = n_comp + nw + nr;
  const int tile = cpt * agg;
  const size_t smem = tl_restrict_smem<T>(nd, tile, nf);
  if (tile > TL_MAX_TILE || cpt < 1 || zs < 1 || smem > TL_MAX_SMEM || (nf > 0 && !spans))
    return (int)cudaErrorInvalidValue;
  const int nblk = (n_agg + cpt - 1) / cpt;
  const dim3 grid(nblk * zs, m);
  if (nd == 3) {
    tl_restrict_kernel<T, 3><<<grid, KNP_THREADS, smem, st>>>(
        r, OH, W, Wr, spans, rc, partial, nc, agg, n_agg, cpt, n_comp, nw, nr, zs);
  } else if (nd == 4) {
    tl_restrict_kernel<T, 4><<<grid, KNP_THREADS, smem, st>>>(
        r, OH, W, Wr, spans, rc, partial, nc, agg, n_agg, cpt, n_comp, nw, nr, zs);
  } else if (nd == 8) {
    tl_restrict_kernel<T, 8><<<grid, KNP_THREADS, smem, st>>>(
        r, OH, W, Wr, spans, rc, partial, nc, agg, n_agg, cpt, n_comp, nw, nr, zs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  int rc_err = (int)cudaGetLastError();
  if (rc_err != 0 || nf == 0) return rc_err;
  tl_reduce_kernel<T><<<dim3(nf, m), KNP_THREADS, 0, st>>>(partial, spans, proj, nf, nblk, tile);
  return (int)cudaGetLastError();
}

// Lets the restrict and prolong kernels take ``smem`` bytes of dynamic
// shared memory (above the default 48 KB: chunks of more than 512 cells at
// nd = 8 in float64, or thousands of fields); called once per workspace
// that needs it.  Each kernel's limit is raised to smem, never lowered (the
// limit is the kernel's, shared by every workspace; with the kernel's
// static shared memory it may not exceed the block's 227 KB).  A refused
// call clears the runtime's last error, or the next launch of any kernel
// would report it.
template <typename T>
static int tl_fields_prepare(int smem) {
  const void* fns[] = {(const void*)tl_restrict_kernel<T, 3>,
                       (const void*)tl_restrict_kernel<T, 4>,
                       (const void*)tl_restrict_kernel<T, 8>,
                       (const void*)tl_prolong_kernel<T, 3, false>,
                       (const void*)tl_prolong_kernel<T, 4, false>,
                       (const void*)tl_prolong_kernel<T, 8, false>,
                       (const void*)tl_prolong_kernel<T, 4, true>};
  for (const void* fn : fns) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, fn);
    if (e == cudaSuccess && attr.maxDynamicSharedSizeBytes < smem)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  return 0;
}

// The grid (the blocks the rows need plus one for each small solve, at most
// the co-resident limit that a cooperative launch requires) and the shared
// memory of the small solves (and of x2, three-level), for p's sizes on the
// current device.
template <typename T>
static int tl_solve_prepare(TlSolve<T>* p) {
  const int kmax = std::max(p->n_comp, std::max(p->nw, p->nr));
  const bool three = p->d1inv != nullptr;
  const size_t smem = 3 * (size_t)kmax * sizeof(T) + (three ? (size_t)p->m * p->n * sizeof(T) : 0);
  if (smem > TL_MAX_SMEM || p->m < 1 || p->n < 1 || p->n1 < 1 || p->k2 < 1 ||
      (three ? (long long)p->n * p->k2 < p->n1 || (long long)(p->n - 1) * p->k2 >= p->n1
             : p->n1 != p->n || p->k2 != 1))
    return (int)cudaErrorInvalidValue;
  p->smem = (int)smem;
  const void* fn = three ? (const void*)tl_solve_kernel<T, true>
                         : (const void*)tl_solve_kernel<T, false>;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  // the attribute is the kernel's, shared by every workspace: raised to the
  // most a block can have, never lowered below another workspace's need
  cudaError_t e = smem > 48 * 1024
                      ? cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             TL_MAX_SMEM)
                      : cudaSuccess;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, KNP_THREADS, p->smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorNotSupported;
  const long long rows = (long long)p->m * p->n;
  const long long need = (rows + TL_WARPS - 1) / TL_WARPS + (kmax > 0 ? 3 * p->m : 0);
  p->grid = (int)std::min((long long)per_sm * sms, need);
  return 0;
}

// With the refinement a cooperative launch (its grid barriers need every
// block resident); without it (one phase, no barrier) a plain launch.
template <typename T, bool THREE>
static int tl_solve_run(const TlSolve<T>& prm, const T* rc, const T* proj, void* stream) {
  if (prm.As == nullptr) {
    tl_solve_kernel<T, THREE><<<prm.grid, KNP_THREADS, prm.smem, (cudaStream_t)stream>>>(
        prm, rc, proj);
    return (int)cudaGetLastError();
  }
  void* args[] = {(void*)&prm, (void*)&rc, (void*)&proj};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)tl_solve_kernel<T, THREE>, dim3(prm.grid), dim3(KNP_THREADS), args,
      (size_t)prm.smem, (cudaStream_t)stream);
  // a refused launch also sets the runtime's last error: read it here, or
  // the next launch of any kernel would report it
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? (int)e : (int)last;
}

template <typename T>
static int tl_solve_launch(const TlSolve<T>* p, const T* rc, const T* proj, void* stream) {
  TlSolve<T> prm = *p;
  return prm.d1inv ? tl_solve_run<T, true>(prm, rc, proj, stream)
                   : tl_solve_run<T, false>(prm, rc, proj, stream);
}

// With Pinv and r (nd = 4 only) the folded apply: out = Pinv r + the
// corrections, out not read.
template <typename T>
static int tl_prolong_launch(T* out, const T* zc, const T* coef, const T* OH, const T* W,
                             const T* Wr, const int* spans, const T* mask, const T* Pinv,
                             const T* r, int m, int nd, int nc, int agg, int n_agg, int n_comp,
                             int nw, int nr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(knp_blocks(nc), m);
  const size_t smem = (size_t)(nw + nr) * sizeof(int);
  if (smem > TL_MAX_SMEM || (n_comp + nw + nr > 0 && !spans) || (!Pinv != !r) ||
      (Pinv && nd != 4))
    return (int)cudaErrorInvalidValue;
#define TL_PROLONG(ND, BJ)                                                               \
  tl_prolong_kernel<T, ND, BJ><<<grid, KNP_THREADS, smem, st>>>(                         \
      out, zc, coef, OH, W, Wr, spans, mask, Pinv, r, nc, agg, n_agg, n_comp, nw, nr)
  if (Pinv) {
    TL_PROLONG(4, true);
  } else if (nd == 3) {
    TL_PROLONG(3, false);
  } else if (nd == 4) {
    TL_PROLONG(4, false);
  } else if (nd == 8) {
    TL_PROLONG(8, false);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef TL_PROLONG
  return (int)cudaGetLastError();
}

// The one-launch apply's kernel: nd = 4 or 8, the folded form (Pinv, nd =
// 4 only), two- or three-level.
template <typename T>
static const void* tl_coarse_fn(int nd, bool bj, bool three) {
  if (three)
    return bj ? (const void*)tl_coarse_kernel<T, 4, true, true>
           : nd == 4 ? (const void*)tl_coarse_kernel<T, 4, false, true>
                     : (const void*)tl_coarse_kernel<T, 8, false, true>;
  return bj ? (const void*)tl_coarse_kernel<T, 4, true, false>
         : nd == 4 ? (const void*)tl_coarse_kernel<T, 4, false, false>
                   : (const void*)tl_coarse_kernel<T, 8, false, false>;
}

// Dynamic shared memory of the one-launch apply: x2 of the m systems
// (three-level), none two-level.
template <typename T>
static size_t tl_coarse_smem(const TlSolve<T>* p) {
  return p->d1inv ? (size_t)p->m * p->n * sizeof(T) : 0;
}

// The one-launch apply's grids for nd = 4 (grids[0]), nd = 8 (grids[1])
// and the folded apply at nd = 4 (grids[2]): the blocks its phases can use
// (the chunk-sum tiles, a warp a coarse row), at most the co-resident limit
// that a cooperative launch requires; three-level, each kernel's dynamic
// shared memory limit raised to x2's size first (never lowered).  Once per
// workspace; a refused query clears the runtime's last error.
template <typename T>
static int tl_coarse_prepare(const TlSolve<T>* p, int agg, int cpt, int* grids) {
  const size_t smem = tl_coarse_smem(p);
  if (p->As != nullptr || p->n_comp + p->nw + p->nr > 0 || p->m < 1 || p->n < 1 || cpt < 1 ||
      agg < 1 || (long long)cpt * agg > TL_MAX_TILE ||
      smem + TL_MAX_TILE * sizeof(T) > TL_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  const bool three = p->d1inv != nullptr;
  const void* fns[] = {tl_coarse_fn<T>(4, false, three), tl_coarse_fn<T>(8, false, three),
                       tl_coarse_fn<T>(4, true, three)};
  const long long tiles = (long long)p->m * ((p->n1 + cpt - 1) / cpt);
  const long long rows = ((long long)p->m * p->n + TL_WARPS - 1) / TL_WARPS;
  const long long need = std::max(tiles, rows);
  for (int k = 0; k < 3 && e == cudaSuccess; ++k) {
    if (smem > 48 * 1024) {
      cudaFuncAttributes attr;
      e = cudaFuncGetAttributes(&attr, fns[k]);
      if (e == cudaSuccess && attr.maxDynamicSharedSizeBytes < (int)smem)
        e = cudaFuncSetAttribute(fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) break;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[k], KNP_THREADS, smem);
    if (e == cudaSuccess && (!coop || per_sm < 1)) e = cudaErrorNotSupported;
    if (e == cudaSuccess) grids[k] = (int)std::min((long long)per_sm * sms, need);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// With Pinv (nd = 4 only) the folded apply: out = Pinv r + zc, out not read.
template <typename T>
static int tl_coarse_launch(const TlSolve<T>* p, const T* r, T* out, const T* mask, T* rc,
                            const T* Pinv, int nd, int nc, int agg, int cpt, int grid,
                            void* stream) {
  if ((nd != 4 && nd != 8) || (Pinv && nd != 4) || grid < 1 || cpt < 1 ||
      (long long)cpt * agg > TL_MAX_TILE || p->As != nullptr || p->n_comp + p->nw + p->nr > 0 ||
      nc > p->n1 * agg || nc <= (p->n1 - 1) * agg)
    return (int)cudaErrorInvalidValue;
  TlSolve<T> prm = *p;
  void* args[] = {(void*)&prm, (void*)&r, (void*)&out, (void*)&mask, (void*)&rc,
                  (void*)&Pinv, (void*)&nc, (void*)&agg, (void*)&cpt};
  const void* fn = tl_coarse_fn<T>(nd, Pinv != nullptr, prm.d1inv != nullptr);
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(KNP_THREADS), args,
                                                    tl_coarse_smem(p), (cudaStream_t)stream);
  // a refused launch also sets the runtime's last error: read it here, or
  // the next launch of any kernel would report it
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? (int)e : (int)last;
}

#define TL_ENTRIES(T, SFX)                                                               \
  extern "C" int knp_tl_restrict_##SFX(const T* r, const T* OH, const T* W, const T* Wr,  \
                                       const int* spans, T* rc, T* proj, T* partial,      \
                                       int m, int nd, int nc, int agg, int n_agg, int cpt, \
                                       int n_comp, int nw, int nr, int zs, void* stream) {  \
    return tl_restrict_launch<T>(r, OH, W, Wr, spans, rc, proj, partial, m, nd, nc, agg,  \
                                 n_agg, cpt, n_comp, nw, nr, zs, stream);                 \
  }                                                                                       \
  extern "C" int knp_tl_fields_prepare_##SFX(int smem) { return tl_fields_prepare<T>(smem); } \
  extern "C" int knp_tl_solve_prepare_##SFX(void* params) {                              \
    return tl_solve_prepare<T>(static_cast<TlSolve<T>*>(params));                         \
  }                                                                                       \
  extern "C" int knp_tl_solve_##SFX(const void* params, const T* rc, const T* proj,       \
                                    void* stream) {                                       \
    return tl_solve_launch<T>(static_cast<const TlSolve<T>*>(params), rc, proj, stream);  \
  }                                                                                       \
  extern "C" int knp_tl_prolong_##SFX(T* out, const T* zc, const T* coef, const T* OH,    \
                                      const T* W, const T* Wr, const int* spans,          \
                                      const T* mask, const T* Pinv, const T* r, int m,    \
                                      int nd, int nc, int agg, int n_agg, int n_comp,     \
                                      int nw, int nr, void* stream) {                     \
    return tl_prolong_launch<T>(out, zc, coef, OH, W, Wr, spans, mask, Pinv, r, m, nd, nc, \
                                agg, n_agg, n_comp, nw, nr, stream);                      \
  }                                                                                       \
  extern "C" int knp_tl_coarse_prepare_##SFX(const void* params, int agg, int cpt,        \
                                             int* grids) {                                \
    return tl_coarse_prepare<T>(static_cast<const TlSolve<T>*>(params), agg, cpt, grids); \
  }                                                                                       \
  extern "C" int knp_tl_coarse_##SFX(const void* params, const T* r, T* out,              \
                                     const T* mask, T* rc, const T* Pinv, int nd, int nc, \
                                     int agg, int cpt, int grid, void* stream) {          \
    return tl_coarse_launch<T>(static_cast<const TlSolve<T>*>(params), r, out, mask, rc,  \
                               Pinv, nd, nc, agg, cpt, grid, stream);                     \
  }

TL_ENTRIES(float, f32)
TL_ENTRIES(double, f64)
