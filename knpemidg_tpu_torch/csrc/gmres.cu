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
// without a copy.  Per Arnoldi step j (rows 0..j populated):
//
//   dot       h[s,k] = sum_i V[k,s,i] w[s,i] for k <= j: per-block partials
//             over chunks of the n axis, then a finish that sums them in
//             index order (two launches);
//   update    w[s,i] -= sum_{k<=j} h[s,k] V[k,s,i];
//   next      hj1 = ||w||, V[j+1] = live ? (hj1 > 1e-300 ? w / hj1 : 0) : 0
//             (norm partials, then every block sums them itself and scales
//             its elements);
//   givens    one thread per system on the (mb, m) scalars: h = h1 + h2,
//             h[j+1] = hj1, the j stored rotations replayed, the new one,
//             the freeze of systems that are no longer live, ks += live and
//             the flag any |g[:, j+1]| > tol the host loop reads.
//
// and at the cycle's ends start (beta = ||r||, V[0] = r / beta, the scalars
// zeroed, the flag any beta > tol) and solve_update (back substitution of
// R[:ks, :ks] y = g[:ks] per system, then x += sum_{k<ks} y_k V[k]).
//
// Bound: device-memory bandwidth.  The whole-basis einsums read all m+1 = 31
// rows of V four times a step whatever j is (0.99 GB in float64 at the cell
// layout's n = 497,664, mb = 2); these kernels read only the j+1 populated
// rows, about (4(j+1) + 6) vectors of mb n values a step.  No kernel reads
// a row it has not written, so V needs no zeroing.  Every sum is a
// fixed-order reduction (block trees, then the blocks in index order): no
// floating-point atomics, so results and Krylov counts repeat from call to
// call.  The source compiles with -fmad=false: the Givens arithmetic and the
// elementwise updates round as the plain versions do.
#include "common.cuh"

#define GM_MAX_ROWS 64   // restart + 1 at most

// partial[(s rows + k) nblk + b] = sum over chunk b of V[k,s,:] . w[s,:]
template <typename T>
__global__ void gm_dot_partial_kernel(const T* __restrict__ V, const T* __restrict__ w,
                                      T* __restrict__ partial, int mb, long long n, int rows,
                                      int chunk) {
  __shared__ T red[KNP_WARPS];
  const int b = blockIdx.x, k = blockIdx.y, s = blockIdx.z;
  const long long lo = (long long)b * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  const T* v = V + ((long long)k * mb + s) * n;
  const T* ws = w + (long long)s * n;
  T acc = T(0);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) acc += v[i] * ws[i];
  acc = knp_block_sum(acc, red);
  if (threadIdx.x == 0) partial[((long long)s * rows + k) * gridDim.x + b] = acc;
}

// out[s ldo + k] = sum_b partial[(s rows + k) nblk + b], in index order
template <typename T>
__global__ void gm_dot_finish_kernel(const T* __restrict__ partial, T* __restrict__ out,
                                     int ldo, int rows, int nblk) {
  __shared__ T red[KNP_WARPS];
  const int k = blockIdx.x, s = blockIdx.y;
  const T* p = partial + ((long long)s * rows + k) * nblk;
  T acc = T(0);
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) acc += p[b];
  acc = knp_block_sum(acc, red);
  if (threadIdx.x == 0) out[(long long)s * ldo + k] = acc;
}

// w[s,i] -= sum_{k<rows} h[s,k] V[k,s,i]
template <typename T>
__global__ void gm_update_kernel(const T* __restrict__ V, T* __restrict__ w,
                                 const T* __restrict__ h, int mb, long long n, int rows,
                                 int ldh) {
  __shared__ T hs[GM_MAX_ROWS];
  const int s = blockIdx.y;
  for (int k = threadIdx.x; k < rows; k += blockDim.x) hs[k] = h[(long long)s * ldh + k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = (long long)mb * n;
  const T* v = V + (long long)s * n + i;
  T acc = hs[0] * v[0];
  for (int k = 1; k < rows; ++k) acc += hs[k] * v[k * row];
  T* wi = w + (long long)s * n + i;
  *wi = *wi - acc;
}

// The norm of w[s] (every block sums the partials itself, in index order)
// and the scaled copy into vout[s] (a row slab of V):
//   start:  vout = w / (nrm > 0 ? nrm : 1)
//   next:   vout = live ? (nrm > 1e-300 ? w / nrm : 0) : 0, live = |g[s,j]| > tol[s]
// Block 0 of each system writes nrm[s].
template <typename T>
__global__ void gm_scale_kernel(const T* __restrict__ w, T* __restrict__ vout,
                                const T* __restrict__ partial, int nblk, long long n,
                                const T* __restrict__ g, const T* __restrict__ tol, int ldg,
                                int j, T* __restrict__ nrm_out, int start) {
  __shared__ T red[KNP_WARPS];
  const int s = blockIdx.y;
  T acc = T(0);
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) acc += partial[(long long)s * nblk + b];
  const T nrm = sqrt(knp_block_sum(acc, red));
  if (blockIdx.x == 0 && threadIdx.x == 0) nrm_out[s] = nrm;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T wi = w[(long long)s * n + i];
  const T safe = nrm > T(0) ? nrm : T(1);
  T v;
  if (start) {
    v = wi / safe;
  } else {
    const bool live = fabs(g[(long long)s * ldg + j]) > tol[s];
    v = (live && nrm > T(1e-300)) ? wi / safe : T(0);
  }
  vout[(long long)s * n + i] = v;
}

// The cycle's scalars: R, cs, sn zero, g = beta e1, ks = 0, and the flag
// any beta > tol (the outer loop's test).  One block.
template <typename T>
__global__ void gm_init_kernel(const T* __restrict__ beta, const T* __restrict__ tol,
                               T* __restrict__ R, T* __restrict__ g, T* __restrict__ cs,
                               T* __restrict__ sn, int* __restrict__ ks,
                               int* __restrict__ flag, int mb, int m) {
  const int M1 = m + 1;
  for (int q = threadIdx.x; q < mb * M1 * m; q += blockDim.x) R[q] = T(0);
  for (int q = threadIdx.x; q < mb * M1; q += blockDim.x) g[q] = q % M1 == 0 ? beta[q / M1] : T(0);
  for (int q = threadIdx.x; q < mb * m; q += blockDim.x) {
    cs[q] = T(0);
    sn[q] = T(0);
  }
  for (int q = threadIdx.x; q < mb; q += blockDim.x) ks[q] = 0;
  if (threadIdx.x == 0) {
    int any = 0;
    for (int q = 0; q < mb; ++q) any |= beta[q] > tol[q];
    *flag = any;
  }
}

// One Arnoldi step's scalar work, one thread per system, in the operation
// order of knpemidg_tpu/solvers/krylov.py:397-439
template <typename T>
__global__ void gm_givens_kernel(const T* __restrict__ h1, const T* __restrict__ h2,
                                 const T* __restrict__ hj1, int ldh, T* __restrict__ R,
                                 T* __restrict__ g, T* __restrict__ cs, T* __restrict__ sn,
                                 int* __restrict__ ks, const T* __restrict__ tol,
                                 int* __restrict__ flag, int mb, int m, int j) {
  const int s = threadIdx.x;
  const int M1 = m + 1;
  if (s < mb) {
    T h[GM_MAX_ROWS];
    for (int k = 0; k <= j; ++k) h[k] = h1[(long long)s * ldh + k] + h2[(long long)s * ldh + k];
    h[j + 1] = hj1[s];
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
  __syncthreads();
  if (threadIdx.x == 0) {
    int any = 0;
    for (int q = 0; q < mb; ++q) any |= fabs(g[(long long)q * M1 + j + 1]) > tol[q];
    *flag = any;
  }
}

// y[s, :ks] solves R[s, :ks, :ks] y = g[s, :ks] (back substitution, rows
// from the last), y[s, ks:] = 0.  One block per system, one thread.
template <typename T>
__global__ void gm_backsolve_kernel(const T* __restrict__ R, const T* __restrict__ g,
                                    const int* __restrict__ ks, T* __restrict__ y, int m) {
  if (threadIdx.x != 0) return;
  const int s = blockIdx.x, M1 = m + 1, k = ks[s];
  const T* Rs = R + (long long)s * M1 * m;
  const T* gs = g + (long long)s * M1;
  T* ys = y + (long long)s * m;
  for (int l = k; l < m; ++l) ys[l] = T(0);
  for (int r = k - 1; r >= 0; --r) {
    T acc = gs[r];
    for (int l = r + 1; l < k; ++l) acc -= Rs[r * m + l] * ys[l];
    ys[r] = acc / Rs[r * m + r];
  }
}

// x[s,i] += sum_{k < ks[s]} y[s,k] V[k,s,i]
template <typename T>
__global__ void gm_xupdate_kernel(const T* __restrict__ V, const T* __restrict__ y,
                                  const int* __restrict__ ks, T* __restrict__ x, int mb,
                                  long long n, int m) {
  __shared__ T ys[GM_MAX_ROWS];
  const int s = blockIdx.y;
  for (int l = threadIdx.x; l < m; l += blockDim.x) ys[l] = y[(long long)s * m + l];
  __syncthreads();
  const int k = ks[s];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || k == 0) return;
  const long long row = (long long)mb * n;
  const T* v = V + (long long)s * n + i;
  T acc = ys[0] * v[0];
  for (int l = 1; l < k; ++l) acc += ys[l] * v[l * row];
  T* xi = x + (long long)s * n + i;
  *xi = *xi + acc;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
static int gm_dot_launch(const T* V, const T* w, T* partial, T* out, int mb, int n, int rows,
                         int ldo, int chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || rows > ldo || chunk < 1) return (int)cudaErrorInvalidValue;
  const int nblk = knp_chunks(n, chunk);
  gm_dot_partial_kernel<T><<<dim3(nblk, rows, mb), KNP_THREADS, 0, st>>>(V, w, partial, mb, n,
                                                                        rows, chunk);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  gm_dot_finish_kernel<T><<<dim3(rows, mb), KNP_THREADS, 0, st>>>(partial, out, ldo, rows, nblk);
  return (int)cudaGetLastError();
}

template <typename T>
static int gm_update_launch(const T* V, T* w, const T* h, int mb, int n, int rows, int ldh,
                            void* stream) {
  if (rows < 1 || rows > GM_MAX_ROWS || rows > ldh) return (int)cudaErrorInvalidValue;
  gm_update_kernel<T><<<dim3(knp_blocks(n), mb), KNP_THREADS, 0, (cudaStream_t)stream>>>(
      V, w, h, mb, n, rows, ldh);
  return (int)cudaGetLastError();
}

template <typename T>
static int gm_norm_scale_launch(const T* w, T* vout, T* partial, int mb, int n,
                                const T* g, const T* tol, int ldg, int j, T* nrm, int start,
                                int chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int nblk = knp_chunks(n, chunk);
  gm_dot_partial_kernel<T><<<dim3(nblk, 1, mb), KNP_THREADS, 0, st>>>(w, w, partial, mb, n, 1,
                                                                     chunk);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  gm_scale_kernel<T><<<dim3(knp_blocks(n), mb), KNP_THREADS, 0, st>>>(
      w, vout, partial, nblk, n, g, tol, ldg, j, nrm, start);
  return (int)cudaGetLastError();
}

template <typename T>
static int gm_start_launch(const T* r, T* V, T* partial, T* beta, const T* tol, T* R, T* g,
                           T* cs, T* sn, int* ks, int* flag, int mb, int n, int m, int chunk,
                           void* stream) {
  if (m < 1 || m + 1 > GM_MAX_ROWS) return (int)cudaErrorInvalidValue;
  int err = gm_norm_scale_launch<T>(r, V, partial, mb, n, nullptr, nullptr, 0, 0, beta, 1,
                                    chunk, stream);
  if (err != 0) return err;
  gm_init_kernel<T><<<1, KNP_THREADS, 0, (cudaStream_t)stream>>>(beta, tol, R, g, cs, sn, ks,
                                                                flag, mb, m);
  return (int)cudaGetLastError();
}

template <typename T>
static int gm_givens_launch(const T* h1, const T* h2, const T* hj1, int ldh, T* R, T* g, T* cs,
                            T* sn, int* ks, const T* tol, int* flag, int mb, int m, int j,
                            void* stream) {
  if (mb > 32 || m + 1 > GM_MAX_ROWS || j < 0 || j >= m || ldh < j + 1)
    return (int)cudaErrorInvalidValue;
  gm_givens_kernel<T><<<1, 32, 0, (cudaStream_t)stream>>>(h1, h2, hj1, ldh, R, g, cs, sn, ks,
                                                          tol, flag, mb, m, j);
  return (int)cudaGetLastError();
}

template <typename T>
static int gm_solve_update_launch(const T* R, const T* g, const int* ks, T* y, const T* V, T* x,
                                  int mb, int n, int m, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m + 1 > GM_MAX_ROWS) return (int)cudaErrorInvalidValue;
  gm_backsolve_kernel<T><<<mb, 32, 0, st>>>(R, g, ks, y, m);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  gm_xupdate_kernel<T><<<dim3(knp_blocks(n), mb), KNP_THREADS, 0, st>>>(V, y, ks, x, mb, n, m);
  return (int)cudaGetLastError();
}

#define GM_ENTRIES(T, SFX)                                                                   \
  extern "C" int knp_gmres_dot_##SFX(const T* V, const T* w, T* partial, T* out, int mb,     \
                                     int n, int rows, int ldo, int chunk, void* stream) {     \
    return gm_dot_launch<T>(V, w, partial, out, mb, n, rows, ldo, chunk, stream);            \
  }                                                                                           \
  extern "C" int knp_gmres_update_##SFX(const T* V, T* w, const T* h, int mb, int n,         \
                                        int rows, int ldh, void* stream) {                    \
    return gm_update_launch<T>(V, w, h, mb, n, rows, ldh, stream);                           \
  }                                                                                           \
  extern "C" int knp_gmres_next_##SFX(const T* w, T* vnext, T* partial, const T* g,          \
                                      const T* tol, T* hj1, int mb, int n, int ldg, int j,    \
                                      int chunk, void* stream) {                              \
    return gm_norm_scale_launch<T>(w, vnext, partial, mb, n, g, tol, ldg, j, hj1, 0, chunk,  \
                                   stream);                                                   \
  }                                                                                           \
  extern "C" int knp_gmres_start_##SFX(const T* r, T* V, T* partial, T* beta, const T* tol,  \
                                       T* R, T* g, T* cs, T* sn, int* ks, int* flag, int mb,  \
                                       int n, int m, int chunk, void* stream) {               \
    return gm_start_launch<T>(r, V, partial, beta, tol, R, g, cs, sn, ks, flag, mb, n, m,    \
                              chunk, stream);                                                 \
  }                                                                                           \
  extern "C" int knp_gmres_givens_##SFX(const T* h1, const T* h2, const T* hj1, int ldh,     \
                                        T* R, T* g, T* cs, T* sn, int* ks, const T* tol,      \
                                        int* flag, int mb, int m, int j, void* stream) {      \
    return gm_givens_launch<T>(h1, h2, hj1, ldh, R, g, cs, sn, ks, tol, flag, mb, m, j,      \
                               stream);                                                       \
  }                                                                                           \
  extern "C" int knp_gmres_solve_update_##SFX(const T* R, const T* g, const int* ks, T* y,   \
                                              const T* V, T* x, int mb, int n, int m,         \
                                              void* stream) {                                 \
    return gm_solve_update_launch<T>(R, g, ks, y, V, x, mb, n, m, stream);                   \
  }

GM_ENTRIES(float, f32)
GM_ENTRIES(double, f64)
