// Kernel K4: cell <-> pair relayout of the interleaved pair layout.
//
// Replaces knpemidg_tpu/ops/pairs.py:273 to_pair and :326 from_pair in their
// interleaved form (an XLA reshape/transpose plus the live mask on the TPU):
//
//   to_pair:   out[l, h nd + i, p] = x[l, i, 2p + h] * (h == 0 ? 1 : live1[p])
//   from_pair: out[l, i, 2p + h]   = xp[l, h nd + i, p]
//
// over L stacked vectors (2-3 per solve: rhs, iterate, predictor base).
//
// Bound: device-memory bandwidth, one read and one write of each value.  At
// the main-path shapes (63,558 pairs, nd = 4) the EMI solve converts 3
// vectors in and 1 out, which moves 12.2 + 4.1 MB in float32 and twice that
// in float64: 4.9 / 9.7 us at 3.35 TB/s, so a call is bound by its launch.
// Design: one fused pass per direction, the mask applied in the same pass;
// one thread per (vector, dof, pair) with pairs fastest, so the pair-side
// rows are coalesced and the two cell-side values of a pair are adjacent.
#include "common.cuh"

template <typename T>
__global__ void to_pair_kernel(const T* __restrict__ x,
                               const unsigned char* __restrict__ live1,
                               T* __restrict__ out, int L, int nd, int npair) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)L * nd * npair) return;
  const int p = (int)(idx % npair);
  const long long li = idx / npair;            // l * nd + i
  const int i = (int)(li % nd);
  const long long l = li / nd;
  const size_t np = (size_t)npair;
  const T* xr = x + (size_t)li * 2 * np;
  const T v0 = xr[2 * (size_t)p];
  const T v1 = xr[2 * (size_t)p + 1];
  T* o = out + (size_t)l * 2 * nd * np;
  o[(size_t)i * np + p] = v0;
  o[(size_t)(nd + i) * np + p] = v1 * (live1[p] ? T(1) : T(0));
}

template <typename T>
__global__ void from_pair_kernel(const T* __restrict__ xp, T* __restrict__ out,
                                 int L, int nd, int npair) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)L * nd * npair) return;
  const int p = (int)(idx % npair);
  const long long li = idx / npair;
  const int i = (int)(li % nd);
  const long long l = li / nd;
  const size_t np = (size_t)npair;
  const T* x = xp + (size_t)l * 2 * nd * np;
  T* o = out + (size_t)li * 2 * np;
  o[2 * (size_t)p] = x[(size_t)i * np + p];
  o[2 * (size_t)p + 1] = x[(size_t)(nd + i) * np + p];
}

template <typename T>
static int to_pair_launch(const T* x, const unsigned char* live1, T* out, int L, int nd,
                          int npair, void* stream) {
  const unsigned int grid = knp_blocks((long long)L * nd * npair);
  to_pair_kernel<T><<<grid, KNP_THREADS, 0, (cudaStream_t)stream>>>(x, live1, out, L,
                                                                    nd, npair);
  return (int)cudaGetLastError();
}

template <typename T>
static int from_pair_launch(const T* xp, T* out, int L, int nd, int npair, void* stream) {
  const unsigned int grid = knp_blocks((long long)L * nd * npair);
  from_pair_kernel<T><<<grid, KNP_THREADS, 0, (cudaStream_t)stream>>>(xp, out, L, nd,
                                                                      npair);
  return (int)cudaGetLastError();
}

extern "C" int knp_to_pair_f32(const float* x, const unsigned char* live1, float* out,
                               int L, int nd, int npair, void* stream) {
  return to_pair_launch<float>(x, live1, out, L, nd, npair, stream);
}

extern "C" int knp_to_pair_f64(const double* x, const unsigned char* live1, double* out,
                               int L, int nd, int npair, void* stream) {
  return to_pair_launch<double>(x, live1, out, L, nd, npair, stream);
}

extern "C" int knp_from_pair_f32(const float* xp, float* out, int L, int nd, int npair,
                                 void* stream) {
  return from_pair_launch<float>(xp, out, L, nd, npair, stream);
}

extern "C" int knp_from_pair_f64(const double* xp, double* out, int L, int nd, int npair,
                                 void* stream) {
  return from_pair_launch<double>(xp, out, L, nd, npair, stream);
}
