// Kernel K14: membrane-trace updates on the n_mem axis and the eliminated ion.
//
// Replaces knpemidg_tpu/ops/assembly.py:888-945: _mem_trace with
// membrane_avg_m (:901), nernst_potential_m (:906), jump_phi_M_m (:913), and
// eliminated_concentration (:941), which XLA lowers to a gather, an einsum
// and a reduction each on the TPU.
//
//   membrane_trace  one thread per membrane facet: gathers the DG1 field at
//                   the facet's plus and minus cells, forms the traces at
//                   the quadrature points from the presliced tables Rp, Rm
//                   (nq, nd, n_mem) and writes the facet average of the plus
//                   trace (mode 0), the minus trace (1), the jump minus -
//                   plus (2) or coef * ln(plus / minus) (3, the Nernst
//                   potential);
//   eliminated      per node: -(sum_k z_k c_k + rho) / z_elim.
//
// Bound: bytes (the trace tables and one output per facet; the m ion fields
// and one output per node).  n_mem is a few thousand, so the trace kernel is
// bound by its launch; it exists so that the step's finalize and ODE-input
// phases make one launch per quantity instead of a gather, an einsum and a
// reduction.  No atomics.
#include "common.cuh"

#define KNP_MAXND 4

template <typename T>
__global__ void membrane_trace_kernel(const T* __restrict__ u, const T* __restrict__ Rp,
                                      const T* __restrict__ Rm, const int* __restrict__ mcp,
                                      const int* __restrict__ mcm, const T* __restrict__ w_f,
                                      T* __restrict__ out, int nq, int nd, int nc, int nm,
                                      int mode, T coef) {
  const int mm = blockIdx.x * blockDim.x + threadIdx.x;
  if (mm >= nm) return;
  const size_t n = (size_t)nc, nmm = (size_t)nm;
  const int cp = mcp[mm], cm = mcm[mm];
  T up[KNP_MAXND], um[KNP_MAXND];
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a) {
    up[a] = (a < nd && mode != 1) ? u[(size_t)a * n + cp] : T(0);
    um[a] = (a < nd && mode != 0) ? u[(size_t)a * n + cm] : T(0);
  }
  T acc = T(0);
  for (int q = 0; q < nq; ++q) {
    T tp = T(0), tm = T(0);
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a)
      if (a < nd) {
        if (mode != 1) tp += Rp[((size_t)q * nd + a) * nmm + mm] * up[a];
        if (mode != 0) tm += Rm[((size_t)q * nd + a) * nmm + mm] * um[a];
      }
    const T v = mode == 0 ? tp : mode == 1 ? tm : mode == 2 ? tm - tp : log(tp / tm);
    acc += w_f[q] * v;
  }
  out[mm] = mode == 3 ? coef * acc : acc;
}

template <typename T>
__global__ void eliminated_kernel(const T* __restrict__ c, const T* __restrict__ z,
                                  const T* __restrict__ rho, T* __restrict__ out, int m,
                                  int nd, int nc, T z_elim) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)nd * nc;
  if (idx >= per) return;
  T acc = T(0);
  for (int k = 0; k < m; ++k) acc += z[k] * c[(size_t)k * per + idx];
  out[idx] = -(acc + rho[idx % nc]) / z_elim;
}

#define KNP_TRACE_ENTRY(SFX, T)                                                           \
  extern "C" int knp_membrane_trace##SFX(const T* u, const T* Rp, const T* Rm,            \
                                         const int* mcp, const int* mcm, const T* w_f,    \
                                         T* out, int nq, int nd, int nc, int nm,          \
                                         int mode, double coef, void* stream) {           \
    membrane_trace_kernel<T><<<knp_blocks(nm), KNP_THREADS, 0, (cudaStream_t)stream>>>(   \
        u, Rp, Rm, mcp, mcm, w_f, out, nq, nd, nc, nm, mode, (T)coef);                    \
    return (int)cudaGetLastError();                                                       \
  }                                                                                       \
  extern "C" int knp_eliminated##SFX(const T* c, const T* z, const T* rho, T* out, int m, \
                                     int nd, int nc, double z_elim, void* stream) {       \
    eliminated_kernel<T><<<knp_blocks((long long)nd * nc), KNP_THREADS, 0,                \
                           (cudaStream_t)stream>>>(c, z, rho, out, m, nd, nc, (T)z_elim); \
    return (int)cudaGetLastError();                                                       \
  }

KNP_TRACE_ENTRY(_f32, float)
KNP_TRACE_ENTRY(_f64, double)
