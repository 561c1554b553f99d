// Kernel K14: membrane-trace updates on the n_mem axis and the eliminated ion.
//
// Replaces knpemidg_tpu/ops/assembly.py:888-945: _mem_trace with
// membrane_avg_m (:901), nernst_potential_m (:906), jump_phi_M_m (:913), and
// eliminated_concentration (:941), which XLA lowers to a gather, an einsum
// and a reduction each on the TPU.
//
//   membrane_trace  one thread per membrane facet and up to KNP_MAXF fields
//                   u (nd, nc): gathers each field at the facet's plus and
//                   minus cells, forms the traces at the quadrature points
//                   from the presliced tables Rp, Rm (nq, nd, n_mem), each
//                   table column read once for all the fields, and writes
//                   the outputs that ``mask`` selects, in this order: the
//                   facet average of the plus trace (TRACE_PLUS), of the
//                   minus trace (TRACE_MINUS), of the jump minus - plus
//                   (TRACE_JUMP) and coef * the facet average of
//                   ln(plus / minus) (TRACE_NERNST, the Nernst potential);
//                   output o of field f at out[o * ostride + f * n_mem];
//   eliminated      per node: -(sum_k z_k c_k + rho) / z_elim (see its
//                   note below).
//
// Bound: bytes (the trace tables once, the gathered fields and one output
// per facet and quantity; the m ion fields, rho and one output per node).
// n_mem is a few thousand, so the trace kernel is bound by its launch: one
// launch serves every field and quantity of a step's ODE inputs, so the
// step makes two (those and the finalize jump) instead of one per (tag,
// ion) and per trace.  Every output is summed as the one-quantity kernel
// before it summed it, in the same expression forms (this source builds
// with nvcc's default contraction): over q in order, the trace over a in
// order, acc += w_f[q] * value, and coef * acc for the Nernst potential.
// Blocks of 64 threads spread the facets over more SMs.  No atomics.
#include "common.cuh"

#define KNP_MAXND 4
#define KNP_MAXF 4          // fields of one launch
#define TRACE_THREADS 64

#define TRACE_PLUS 1
#define TRACE_MINUS 2
#define TRACE_JUMP 4
#define TRACE_NERNST 8

template <typename T>
struct TraceFields {
  const T* u[KNP_MAXF];
  T coef[KNP_MAXF];
};

template <typename T, int NF>
__global__ void __launch_bounds__(TRACE_THREADS)
membrane_trace_kernel(TraceFields<T> fl, const T* __restrict__ Rp, const T* __restrict__ Rm,
                      const int* __restrict__ mcp, const int* __restrict__ mcm,
                      const T* __restrict__ w_f, T* __restrict__ out, int ostride, int nq,
                      int nd, int nc, int nm, int mask) {
  const int mm = blockIdx.x * blockDim.x + threadIdx.x;
  if (mm >= nm) return;
  const size_t n = (size_t)nc, nmm = (size_t)nm;
  const int cp = mcp[mm], cm = mcm[mm];
  T up[NF][KNP_MAXND], um[NF][KNP_MAXND];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a) {
      up[f][a] = a < nd ? fl.u[f][(size_t)a * n + cp] : T(0);
      um[f][a] = a < nd ? fl.u[f][(size_t)a * n + cm] : T(0);
    }
  T accp[NF], accm[NF], accj[NF], accn[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) accp[f] = accm[f] = accj[f] = accn[f] = T(0);
  for (int q = 0; q < nq; ++q) {
    T rp[KNP_MAXND], rm[KNP_MAXND];
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a) {
      rp[a] = a < nd ? Rp[((size_t)q * nd + a) * nmm + mm] : T(0);
      rm[a] = a < nd ? Rm[((size_t)q * nd + a) * nmm + mm] : T(0);
    }
    const T w = w_f[q];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      T tp = T(0), tm = T(0);
#pragma unroll
      for (int a = 0; a < KNP_MAXND; ++a)
        if (a < nd) {
          tp += rp[a] * up[f][a];
          tm += rm[a] * um[f][a];
        }
      if (mask & TRACE_PLUS) accp[f] += w * tp;
      if (mask & TRACE_MINUS) accm[f] += w * tm;
      if (mask & TRACE_JUMP) accj[f] += w * (tm - tp);
      if (mask & TRACE_NERNST) accn[f] += w * log(tp / tm);
    }
  }
  T* o = out + mm;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    T* of = o + (size_t)f * nmm;
    if (mask & TRACE_PLUS) { *of = accp[f]; of += ostride; }
    if (mask & TRACE_MINUS) { *of = accm[f]; of += ostride; }
    if (mask & TRACE_JUMP) { *of = accj[f]; of += ostride; }
    if (mask & TRACE_NERNST) *of = fl.coef[f] * accn[f];
  }
}

// eliminated: a thread one node, or in float two consecutive cells of a
// row (CPT = 2, one 8-byte access a row, where nc is even and every
// pointer aligned to two elements: on the H100 14-16% faster than one node
// in float, while one node a thread is 3-10% faster than two in double),
// the row from the grid's y index and rho read at the cell in place; ND
// and the solved-ion count M known at compile time.  A node's loads (the M
// ions' c, rho) are issued before its first product.  The sum is the
// earlier kernel's: this file builds with nvcc's default contraction,
// which made its acc += z_k c_k a fused multiply-add, written out here as
// one (knp_fma) so the bits do not rest on the flags: acc = fma(z_k, c_k, acc) over k from zero, then
// -(acc + rho) / z_elim.  z = the tables' z[:M] and z_elim = z[M] come by
// value (ops/assembly.py: the solver's cell tables on the step's route,
// tables made for the call on the public route).
template <typename T>
struct ElimArgs {
  const T *c, *rho;          // c (M, ND, nc), rho (nc,)
  T* out;
  T zk[KNP_CELL_MAXI - 1];
  T z_elim;
  int nc;
};

__device__ __forceinline__ float knp_fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double knp_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T, int ND, int M, int CPT>
__global__ void __launch_bounds__(KNP_THREADS) eliminated_kernel(const ElimArgs<T> p) {
  const int cell = (blockIdx.x * blockDim.x + threadIdx.x) * CPT;
  if (cell >= p.nc) return;
  const int a = blockIdx.y;
  const size_t n = (size_t)p.nc;
  T ck[M][CPT], r[CPT];
#pragma unroll
  for (int k = 0; k < M; ++k) knp_ld<T, CPT>(p.c + ((size_t)k * ND + a) * n + cell, ck[k]);
  knp_ld<T, CPT>(p.rho + cell, r);
  T o[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < M; ++k) acc = knp_fma(p.zk[k], ck[k][q], acc);
    o[q] = -(acc + r[q]) / p.z_elim;
  }
  knp_st<T, CPT>(p.out + (size_t)a * n + cell, o);
}

template <typename T, int ND, int M>
static int eliminated_run(const ElimArgs<T>& p, bool two, cudaStream_t st) {
  // two nodes a thread in float only: one is faster in double
  if constexpr (sizeof(T) == sizeof(float)) {
    if (two) {
      eliminated_kernel<T, ND, M, 2><<<dim3(knp_blocks((p.nc + 1) / 2), ND), KNP_THREADS, 0,
                                       st>>>(p);
      return (int)cudaGetLastError();
    }
  }
  eliminated_kernel<T, ND, M, 1><<<dim3(knp_blocks(p.nc), ND), KNP_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// the nd and ion-count instantiations: nd in 2..4, 1..KNP_CELL_MAXI - 1
// solved ions
template <typename T>
static int eliminated_launch(const KnpCellTables* t, const T* c, T* out, void* stream) {
  const int m = t->n_ions - 1;
  if (t->nc < 0 || m < 1) return (int)cudaErrorInvalidValue;
  if (t->nc == 0) return 0;
  ElimArgs<T> p = {c, static_cast<const T*>(t->rho), out, {}, (T)t->z[m], t->nc};
  for (int k = 0; k < m; ++k) p.zk[k] = (T)t->z[k];
  const size_t v = 2 * sizeof(T);
  const bool two = p.nc % 2 == 0 && knp_aligned(p.c, v) && knp_aligned(p.rho, v) &&
                   knp_aligned(p.out, v);
  cudaStream_t st = (cudaStream_t)stream;
#define ELIM_M(ND, M) \
  case M:             \
    return eliminated_run<T, ND, M>(p, two, st);
#define ELIM_ND(ND)                                                                          \
  case ND:                                                                                   \
    switch (m) { ELIM_M(ND, 1) ELIM_M(ND, 2) ELIM_M(ND, 3) ELIM_M(ND, 4) ELIM_M(ND, 5) }     \
    return (int)cudaErrorInvalidValue;
  switch (t->nd) {
    ELIM_ND(2)
    ELIM_ND(3)
    ELIM_ND(4)
  }
#undef ELIM_ND
#undef ELIM_M
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int membrane_trace_launch(TraceFields<T> fl, int nf, const T* Rp, const T* Rm,
                                 const int* mcp, const int* mcm, const T* w_f, T* out,
                                 int ostride, int nq, int nd, int nc, int nm, int mask,
                                 void* stream) {
  if (nd > KNP_MAXND || mask <= 0 || mask > 15) return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)((nm + TRACE_THREADS - 1) / TRACE_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
#define KNP_TRACE_CASE(NF)                                                                 \
  case NF:                                                                                 \
    membrane_trace_kernel<T, NF><<<grid, TRACE_THREADS, 0, st>>>(                          \
        fl, Rp, Rm, mcp, mcm, w_f, out, ostride, nq, nd, nc, nm, mask);                    \
    break;
  switch (nf) {
    KNP_TRACE_CASE(1)
    KNP_TRACE_CASE(2)
    KNP_TRACE_CASE(3)
    KNP_TRACE_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KNP_TRACE_CASE
  return (int)cudaGetLastError();
}

#define KNP_TRACE_ENTRY(SFX, T)                                                           \
  extern "C" int knp_membrane_trace##SFX(                                                 \
      const T* u0, const T* u1, const T* u2, const T* u3, double c0, double c1,           \
      double c2, double c3, int nf, const T* Rp, const T* Rm, const int* mcp,             \
      const int* mcm, const T* w_f, T* out, int ostride, int nq, int nd, int nc, int nm,  \
      int mask, void* stream) {                                                           \
    TraceFields<T> fl = {{u0, u1, u2, u3}, {(T)c0, (T)c1, (T)c2, (T)c3}};                 \
    return membrane_trace_launch<T>(fl, nf, Rp, Rm, mcp, mcm, w_f, out, ostride, nq, nd,  \
                                    nc, nm, mask, stream);                                \
  }                                                                                       \
  extern "C" int knp_eliminated##SFX(const void* tables, const T* c, T* out,              \
                                     void* stream) {                                      \
    const KnpCellTables* t = static_cast<const KnpCellTables*>(tables);                   \
    return eliminated_launch<T>(t, c, out, stream);                                       \
  }

KNP_TRACE_ENTRY(_f32, float)
KNP_TRACE_ENTRY(_f64, double)
