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
// unrolling keeps each sum's order.  No floating-point
// atomics: the results repeat bit for bit from call to call, and so do the
// Krylov counts.  The dense GEMVs give one warp to a row (coalesced row
// reads, a fixed shuffle tree); the three dependent products of the
// refinement are three launches.  The small Galerkin solves (5, 45 and 24
// rows) take one block each, their vectors in shared memory.
#include <algorithm>

#include "common.cuh"

#define TL_WARPS (KNP_THREADS / 32)
#define TL_MAX_TILE 1024   // cells a restrict block covers (whole chunks)
#define TL_FIELD_BATCH 32  // field sums reduced per block synchronisation
#define TL_FIELDS_PER_BLOCK 8  // projections a restrict block computes

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
// solve: dense coarse GEMVs and the small deflation solves
// ---------------------------------------------------------------------------

// y[s,row] = P[row] * (Bs[row] B[row] + sign * sum_j A[s,row,j] xs[j] x[j]),
// each of P, Bs, B, xs optional (1, 1, 0, 1 when absent); the vectors are
// (m, n), A is (m, n, n).  One warp per row.
template <typename T>
__global__ void tl_gemv_kernel(const T* __restrict__ A, const T* __restrict__ x,
                               const T* __restrict__ xs, const T* __restrict__ B,
                               const T* __restrict__ Bs, const T* __restrict__ P,
                               T sign, T* __restrict__ y, int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * TL_WARPS + (threadIdx.x >> 5);
  const int s = blockIdx.y;
  if (row >= n) return;
  const size_t off = (size_t)s * n;
  const T* a = A + (off + row) * (size_t)n;
  T acc = T(0);
  // unrolled so that eight row loads are in flight; one accumulator keeps
  // the sum order
  if (xs != nullptr) {
#pragma unroll 8
    for (int j = lane; j < n; j += 32) acc += a[j] * (xs[off + j] * x[off + j]);
  } else {
#pragma unroll 8
    for (int j = lane; j < n; j += 32) acc += a[j] * x[off + j];
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    T v = sign * acc;
    if (B != nullptr) v = (Bs != nullptr ? Bs[off + row] * B[off + row] : B[off + row]) + v;
    if (P != nullptr) v = P[off + row] * v;
    y[off + row] = v;
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

// One block per (deflation group, system): group 0 the compartments (one
// refinement sweep with Asc), 1 the moment fields, 2 the Ritz fields.
template <typename T>
__global__ void tl_small_kernel(const T* __restrict__ proj, T* __restrict__ coef,
                                const T* __restrict__ invc, const T* __restrict__ sc,
                                const T* __restrict__ Asc, const T* __restrict__ inv_m,
                                const T* __restrict__ s_m, const T* __restrict__ inv_r,
                                const T* __restrict__ s_r, int n_comp, int nw, int nr) {
  extern __shared__ __align__(16) unsigned char tl_smem[];
  T* x = reinterpret_cast<T*>(tl_smem);
  const int g = blockIdx.x, s = blockIdx.y;
  const int nf = n_comp + nw + nr;
  const int k = g == 0 ? n_comp : (g == 1 ? nw : nr);
  if (k == 0) return;
  const int off = g == 0 ? 0 : (g == 1 ? n_comp : n_comp + nw);
  const T* Mi = g == 0 ? invc : (g == 1 ? inv_m : inv_r);
  const T* sg = g == 0 ? sc : (g == 1 ? s_m : s_r);
  T* y = x + k;
  T* t = y + k;
  const T* pr = proj + (size_t)s * nf + off;
  for (int j = threadIdx.x; j < k; j += blockDim.x) x[j] = sg[j] * pr[j];
  __syncthreads();
  small_matvec(Mi, x, y, k);
  if (g == 0) {                       // zc = zc + invc (rsc - Asc zc)
    small_matvec(Asc, y, t, k);
    for (int j = threadIdx.x; j < k; j += blockDim.x) t[j] = x[j] - t[j];
    __syncthreads();
    small_matvec(Mi, t, x, k);        // x is free: rsc is no longer needed
    for (int j = threadIdx.x; j < k; j += blockDim.x) y[j] = y[j] + x[j];
    __syncthreads();
  }
  T* out = coef + (size_t)s * nf + off;
  for (int j = threadIdx.x; j < k; j += blockDim.x) out[j] = sg[j] * y[j];
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

template <typename T>
static int tl_solve_launch(const T* inv, const T* s, const T* As, const T* rc, T* z1,
                           T* t, T* zc, const T* proj, T* coef, const T* invc,
                           const T* sc, const T* Asc, const T* inv_m, const T* s_m,
                           const T* inv_r, const T* s_r, int m, int n, int n_comp,
                           int nw, int nr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + TL_WARPS - 1) / TL_WARPS, m);
  if (As != nullptr) {
    tl_gemv_kernel<T><<<grid, KNP_THREADS, 0, st>>>(inv, rc, s, nullptr, nullptr, nullptr,
                                                    T(1), z1, n);
    tl_gemv_kernel<T><<<grid, KNP_THREADS, 0, st>>>(As, z1, nullptr, rc, s, nullptr, T(-1),
                                                    t, n);
    tl_gemv_kernel<T><<<grid, KNP_THREADS, 0, st>>>(inv, t, nullptr, z1, nullptr, s, T(1),
                                                    zc, n);
  } else {
    tl_gemv_kernel<T><<<grid, KNP_THREADS, 0, st>>>(inv, rc, s, nullptr, nullptr, s, T(1),
                                                    zc, n);
  }
  int err = (int)cudaGetLastError();
  const int kmax = std::max(n_comp, std::max(nw, nr));
  if (err != 0 || kmax == 0) return err;
  const size_t smem = 3 * (size_t)kmax * sizeof(T);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  tl_small_kernel<T><<<dim3(3, m), KNP_THREADS, smem, st>>>(
      proj, coef, invc, sc, Asc, inv_m, s_m, inv_r, s_r, n_comp, nw, nr);
  return (int)cudaGetLastError();
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
  extern "C" int knp_tl_solve_##SFX(                                                      \
      const T* inv, const T* s, const T* As, const T* rc, T* z1, T* t, T* zc,             \
      const T* proj, T* coef, const T* invc, const T* sc, const T* Asc, const T* inv_m,   \
      const T* s_m, const T* inv_r, const T* s_r, int m, int n, int n_comp, int nw,       \
      int nr, void* stream) {                                                             \
    return tl_solve_launch<T>(inv, s, As, rc, z1, t, zc, proj, coef, invc, sc, Asc,       \
                              inv_m, s_m, inv_r, s_r, m, n, n_comp, nw, nr, stream);      \
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
