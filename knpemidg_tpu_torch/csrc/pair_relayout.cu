// Kernel K4: cell <-> pair relayout of the interleaved pair layout.
//
// Replaces knpemidg_tpu/ops/pairs.py:273 to_pair and :326 from_pair in their
// interleaved form (an XLA reshape/transpose plus the live mask on the TPU):
//
//   to_pair:   out[l, h nd + i, p] = x[l, i, 2p + h] * (h == 0 ? 1 : live1[p])
//   from_pair: out[l, i, 2p + h]   = xp[l, h nd + i, p] (+ add[l, h nd + i, p])
//                                    (+ base[l, i, 2p + h])
//
// over L stacked vectors (2-3 per solve: rhs, iterate, predictor base).
// from_pair carries the add that follows it in the solver: the EMI solve's
// guess + x in pair form (add), the KNP solve's c + x in cell form (base);
// the relayout is a permutation, so one addition per value in the same pass
// gives the same bits as the add before or after it.
//
// Bound: device-memory bandwidth, one read and one write of each value.  At
// the main-path shapes (63,558 pairs, nd = 4) the EMI solve converts 3
// vectors in and 1 out, which moves 12.2 + 4.1 MB in float32 and twice that
// in float64: 4.9 / 9.7 us at 3.35 TB/s, so a call is bound by its launch.
// Design: one fused pass per direction, the mask or the add applied in the
// same pass.  to_pair reads up to TP_MAX_SRC source tensors of one shape
// directly (the solver's 2-3 vectors, without stacking them first) and
// writes their stacked pair form.  Both directions give a thread TP_PAIRS
// pairs of one (vector, dof) row, blockDim.x apart, with all its loads
// issued first; the row is on the grid's y axis (to_pair's source on z), so
// that no index needs a 64-bit division.  A pair's two cell values are one
// 8- or 16-byte load (to_pair) or store (from_pair), and both halves are
// read or written coalesced.
#include "common.cuh"

#define TP_MAX_SRC 4
#define TP_PAIRS 4   // pairs a thread converts

template <typename T>
struct Pair2;
template <>
struct Pair2<float> {
  using type = float2;
};
template <>
struct Pair2<double> {
  using type = double2;
};

struct ToPairSrc {
  const void* x[TP_MAX_SRC];
};

// out[q lv + l, h nd + i, p] = src[q][l, i, 2p + h] * (h == 0 ? 1 : live1[p])
// for source q, vector l < lv and dof i; blockIdx.y = l nd + i.  A thread
// converts TP_PAIRS pairs, blockDim.x apart, all loads issued first.
template <typename T>
__global__ void to_pair_kernel(const ToPairSrc src, const unsigned char* __restrict__ live1,
                               T* __restrict__ out, int lv, int nd, int npair) {
  using V = typename Pair2<T>::type;
  const int li = blockIdx.y, q = blockIdx.z;
  const int l = li / nd, i = li - l * nd;
  const void* x = src.x[0];
#pragma unroll
  for (int k = 1; k < TP_MAX_SRC; ++k)
    if (q == k) x = src.x[k];
  const V* xr = reinterpret_cast<const V*>(x) + (size_t)li * npair;
  T* o = out + (size_t)((q * lv + l) * 2 * nd + i) * npair;
  const size_t half = (size_t)nd * npair;
  const int p0 = blockIdx.x * (TP_PAIRS * blockDim.x) + threadIdx.x;
  V v[TP_PAIRS];
  unsigned char live[TP_PAIRS];
#pragma unroll
  for (int k = 0; k < TP_PAIRS; ++k) {
    const int p = p0 + k * blockDim.x;
    if (p < npair) {
      v[k] = xr[p];
      live[k] = live1[p];
    }
  }
#pragma unroll
  for (int k = 0; k < TP_PAIRS; ++k) {
    const int p = p0 + k * blockDim.x;
    if (p < npair) {
      o[p] = v[k].x;
      o[half + p] = v[k].y * (live[k] ? T(1) : T(0));
    }
  }
}

// out[l, i, 2p + h] = xp[l, h nd + i, p] (+ add[l, h nd + i, p], MODE 1)
// (+ base[l, i, 2p + h], MODE 2) for vector l < L and dof i; blockIdx.y =
// l nd + i.  A thread converts TP_PAIRS pairs, blockDim.x apart, all loads
// issued first, and writes each pair as one 8- or 16-byte store.
template <typename T, int MODE>
__global__ void from_pair_kernel(const T* __restrict__ xp, const T* __restrict__ add,
                                 const T* __restrict__ base, T* __restrict__ out, int nd,
                                 int npair) {
  using V = typename Pair2<T>::type;
  const int li = blockIdx.y;
  const int l = li / nd, i = li - l * nd;
  const size_t half = (size_t)nd * npair;
  const size_t lo = (size_t)(2 * l * nd + i) * npair;
  const T* x = xp + lo;
  const T* a = MODE == 1 ? add + lo : nullptr;
  const V* b = MODE == 2 ? reinterpret_cast<const V*>(base) + (size_t)li * npair : nullptr;
  V* o = reinterpret_cast<V*>(out) + (size_t)li * npair;
  const int p0 = blockIdx.x * (TP_PAIRS * blockDim.x) + threadIdx.x;
  V v[TP_PAIRS], w[TP_PAIRS];
#pragma unroll
  for (int k = 0; k < TP_PAIRS; ++k) {
    const int p = p0 + k * blockDim.x;
    if (p < npair) {
      v[k].x = x[p];
      v[k].y = x[half + p];
      if (MODE == 1) {
        w[k].x = a[p];
        w[k].y = a[half + p];
      } else if (MODE == 2) {
        w[k] = b[p];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < TP_PAIRS; ++k) {
    const int p = p0 + k * blockDim.x;
    if (p < npair) {
      if (MODE != 0) {
        v[k].x = v[k].x + w[k].x;
        v[k].y = v[k].y + w[k].y;
      }
      o[p] = v[k];
    }
  }
}

template <typename T>
static int to_pair_launch(const T* x0, const T* x1, const T* x2, const T* x3,
                          const unsigned char* live1, T* out, int nsrc, int lv, int nd,
                          int npair, void* stream) {
  if (nsrc < 1 || nsrc > TP_MAX_SRC || lv * nd > 65535) return (int)cudaErrorInvalidValue;
  const ToPairSrc src = {{x0, x1, x2, x3}};
  const dim3 grid((npair + TP_PAIRS * KNP_THREADS - 1) / (TP_PAIRS * KNP_THREADS), lv * nd,
                  nsrc);
  to_pair_kernel<T><<<grid, KNP_THREADS, 0, (cudaStream_t)stream>>>(src, live1, out, lv, nd,
                                                                    npair);
  return (int)cudaGetLastError();
}

// add (pair form) or base (cell form, 8/16-byte aligned) may be given, not
// both; out must be 8/16-byte aligned
template <typename T>
static int from_pair_launch(const T* xp, const T* add, const T* base, T* out, int L, int nd,
                            int npair, void* stream) {
  if ((add != nullptr && base != nullptr) || L * nd > 65535 || L * nd < 1 || npair < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((npair + TP_PAIRS * KNP_THREADS - 1) / (TP_PAIRS * KNP_THREADS), L * nd);
  cudaStream_t st = (cudaStream_t)stream;
  if (add != nullptr) {
    from_pair_kernel<T, 1><<<grid, KNP_THREADS, 0, st>>>(xp, add, nullptr, out, nd, npair);
  } else if (base != nullptr) {
    from_pair_kernel<T, 2><<<grid, KNP_THREADS, 0, st>>>(xp, nullptr, base, out, nd, npair);
  } else {
    from_pair_kernel<T, 0><<<grid, KNP_THREADS, 0, st>>>(xp, nullptr, nullptr, out, nd, npair);
  }
  return (int)cudaGetLastError();
}

extern "C" int knp_to_pair_f32(const float* x0, const float* x1, const float* x2,
                               const float* x3, const unsigned char* live1, float* out,
                               int nsrc, int lv, int nd, int npair, void* stream) {
  return to_pair_launch<float>(x0, x1, x2, x3, live1, out, nsrc, lv, nd, npair, stream);
}

extern "C" int knp_to_pair_f64(const double* x0, const double* x1, const double* x2,
                               const double* x3, const unsigned char* live1, double* out,
                               int nsrc, int lv, int nd, int npair, void* stream) {
  return to_pair_launch<double>(x0, x1, x2, x3, live1, out, nsrc, lv, nd, npair, stream);
}

extern "C" int knp_from_pair_f32(const float* xp, const float* add, const float* base,
                                 float* out, int L, int nd, int npair, void* stream) {
  return from_pair_launch<float>(xp, add, base, out, L, nd, npair, stream);
}

extern "C" int knp_from_pair_f64(const double* xp, const double* add, const double* base,
                                 double* out, int L, int nd, int npair, void* stream) {
  return from_pair_launch<double>(xp, add, base, out, L, nd, npair, stream);
}
