// Kernel K12: pair-ELL operator emit from per-facet blocks.
//
// Replaces knpemidg_tpu/ops/pairs.py:384 gather_blocks_pair and :443
// gather_blocks_pair_multi (XLA gathers and selects on the TPU), for m
// systems sharing the pair maps.  Per pair p and system s:
//
//   B00 = A[c0] + (p0 ? Mpp : Mmm)[int_f] + sum_{t: h_t = 0} dg_t
//   B11 = A[c1] live1 + (p0 ? Mmm : Mpp)[int_f] + sum_{t: h_t = 1} dg_t
//         + dead_identity (1 - live1) I
//   B01 = (p0 ? Mpm : Mmp)[int_f],  B10 = (p0 ? Mmp : Mpm)[int_f]
//   pe[t] = the (isp_t ? Mpm : Mmp)[ext_f_t] block in the rows of half h_t
//
// with dg_t = (isp_t ? Mpp : Mmm)[ext_f_t], written as pd (m, 2nd, 2nd,
// npair) and pe (m, S, 2nd, nd, npair) in one launch per call.  Two optional
// parts serve the assemblies (csrc/assemble_emi.cu, csrc/assemble_knp.cu):
// add_pd / add_pe, a static pair operator added last to every entry (the KNP
// mass + stiffness part), and reg (m, nd, nd, nc), per-cell blocks embedded
// on the pair diagonal's two halves and added to pd as a second output pdiag
// (the EMI preconditioner diagonal).
//
// Only the owner half of each slot is written: the rows of the other half
// are zero in every pair operator (the pair matvec never reads them), so
// the caller's pe holds zeros there already (ops/pairs.py makes each pe
// with them and checks that add_pe has only zeros there), and the kernel
// neither reads add_pe nor writes pe in those rows.
//
// Bound: device-memory bandwidth.  At the main path's shapes (63,558
// pairs, 127,116 padded cells, 243,577 facets, nd = 4, S = 6) the EMI emit
// (m = 1, with reg) writes 224 values a pair and reads 64, the KNP emit
// (m = 2, with add) writes 160 and reads 192 a pair and system, and both
// read the four facet-block arrays once: 109.8 M values, 0.262 ms at 3.35
// TB/s in float64, 0.131 ms in float32.
//
// Design: one thread per (system, block entry (i, j), pair) with pairs
// fastest, so the pd / pe stores are coalesced rows.  The maps come from
// one packed int32 table built once per maps (ops/pairs.py emit_table), S
// + 1 words a pair, pairs fastest: the interior word (int_f, live1 in bit
// 30, int_p0 in bit 31), then each slot's (ext_f, ext_isp in bit 30, ext_h
// in bit 31); the interleaved maps put the pair's cells at (2p, 2p + 1),
// read as one vector load.  S is a template parameter, so every index word
// is loaded first, then every gather (A at both cells, the four interior
// values, two values a slot, reg and add), before the first addition: a
// thread's chain of dependent loads is two deep.  Each thread performs the
// plain version's additions in its order (the diagonal blocks first, then
// slot 0..S-1, the dead identity, add, reg), and every product in them is
// by 0 or 1 and exact, so the result equals the plain version bit for bit
// whether or not nvcc contracts them.  A, reg and add are read once
// (streaming loads), the outputs written once (streaming stores).  The
// single-device maps only: the sharded maps' live0 is refused by the
// wrapper.
#include "common.cuh"

#define EMIT_ND 4      // the block size the kernel is built for
#define EMIT_S 6       // the external slots of a 3D pair (2 d)
#define EMIT_F 0x3fffffff

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

template <typename T, int S>
__global__ void __launch_bounds__(KNP_THREADS)
pair_emit_kernel(const T* __restrict__ A, const T* __restrict__ Mpp, const T* __restrict__ Mpm,
                 const T* __restrict__ Mmp, const T* __restrict__ Mmm,
                 const unsigned* __restrict__ tab, T* __restrict__ pd, T* __restrict__ pe,
                 const T* __restrict__ add_pd, const T* __restrict__ add_pe,
                 const T* __restrict__ reg, T* __restrict__ pdiag, int m, int nf1, int npair,
                 T dead) {
  constexpr int ND = EMIT_ND, ND2 = 2 * ND;
  using V2 = typename Vec2<T>::type;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * ND * ND * npair) return;
  const int p = (int)(idx % npair);
  const long long sij = idx / npair;           // (s * nd + i) * nd + j
  const int j = (int)(sij % ND);
  const int i = (int)((sij / ND) % ND);
  const int s = (int)(sij / (ND * ND));
  const size_t np = (size_t)npair;

  // the index words, then every gather
  const unsigned wi = __ldg(tab + p);
  unsigned ws[S];
#pragma unroll
  for (int t = 0; t < S; ++t) ws[t] = __ldg(tab + (size_t)(t + 1) * np + p);
  const size_t ao = (size_t)sij * (2 * np);     // A (m, nd, nd, 2 npair), cells 2p, 2p + 1
  const V2 a = __ldcs(reinterpret_cast<const V2*>(A + ao) + p);
  const size_t mo = (size_t)sij * nf1;
  const int fi = (int)(wi & EMIT_F);
  const T gpp = Mpp[mo + fi], gmm = Mmm[mo + fi];
  const T gpm = Mpm[mo + fi], gmp = Mmp[mo + fi];
  T dg[S], off[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const size_t f = mo + (ws[t] & EMIT_F);
    const bool sel = (ws[t] >> 30) & 1u;
    dg[t] = (sel ? Mpp : Mmm)[f];
    off[t] = (sel ? Mpm : Mmp)[f];
  }
  const size_t so = (size_t)s * ND2 * ND2 * np;
  const size_t o00 = so + ((size_t)i * ND2 + j) * np + p;
  const size_t o01 = so + ((size_t)i * ND2 + ND + j) * np + p;
  const size_t o10 = so + ((size_t)(ND + i) * ND2 + j) * np + p;
  const size_t o11 = so + ((size_t)(ND + i) * ND2 + ND + j) * np + p;
  // the owner half's entry (i, j) of slot t: row h_t nd + i
  size_t eo[S];
#pragma unroll
  for (int t = 0; t < S; ++t)
    eo[t] = ((size_t)s * S + t) * ND2 * ND * np + ((size_t)((ws[t] >> 31) * ND + i) * ND + j) * np + p;
  T ad[4] = {T(0), T(0), T(0), T(0)}, ae[S];
  if (add_pd) {
    ad[0] = __ldcs(add_pd + o00);
    ad[1] = __ldcs(add_pd + o01);
    ad[2] = __ldcs(add_pd + o10);
    ad[3] = __ldcs(add_pd + o11);
#pragma unroll
    for (int t = 0; t < S; ++t) ae[t] = __ldcs(add_pe + eo[t]);
  }
  V2 rg;
  if (reg) rg = __ldcs(reinterpret_cast<const V2*>(reg + ao) + p);

  const T l1 = ((wi >> 30) & 1u) ? T(1) : T(0);
  const bool p0 = (wi >> 31) != 0;
  T b00 = a.x;
  T b11 = a.y * l1;
  b00 = b00 + (p0 ? gpp : gmm);
  b11 = b11 + (p0 ? gmm : gpp);
  T b01 = p0 ? gpm : gmp;
  T b10 = p0 ? gmp : gpm;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const bool h0 = (ws[t] >> 31) == 0;
    b00 = b00 + (h0 ? dg[t] : T(0));
    b11 = b11 + (h0 ? T(0) : dg[t]);
    __stcs(pe + eo[t], add_pd ? off[t] + ae[t] : off[t]);
  }
  b11 = b11 + ((i == j) ? dead * (T(1) - l1) : T(0));
  if (add_pd) {
    b00 = b00 + ad[0];
    b01 = b01 + ad[1];
    b10 = b10 + ad[2];
    b11 = b11 + ad[3];
  }
  __stcs(pd + o00, b00);
  __stcs(pd + o01, b01);
  __stcs(pd + o10, b10);
  __stcs(pd + o11, b11);
  if (reg) {
    __stcs(pdiag + o00, b00 + rg.x);
    __stcs(pdiag + o01, b01);
    __stcs(pdiag + o10, b10);
    __stcs(pdiag + o11, b11 + rg.y * l1);
  }
}

// add_pd and add_pe come together (both or neither); reg with pdiag.
template <typename T>
static int pair_emit_launch(const T* A, const T* Mpp, const T* Mpm, const T* Mmp, const T* Mmm,
                            const unsigned* tab, T* pd, T* pe, const T* add_pd, const T* add_pe,
                            const T* reg, T* pdiag, int m, int nd, int S, int nf1, int npair,
                            double dead, void* stream) {
  if (nd != EMIT_ND || S != EMIT_S || (add_pd == nullptr) != (add_pe == nullptr) ||
      (reg == nullptr) != (pdiag == nullptr))
    return (int)cudaErrorInvalidValue;
  const unsigned int grid = knp_blocks((long long)m * nd * nd * npair);
  pair_emit_kernel<T, EMIT_S><<<grid, KNP_THREADS, 0, (cudaStream_t)stream>>>(
      A, Mpp, Mpm, Mmp, Mmm, tab, pd, pe, add_pd, add_pe, reg, pdiag, m, nf1, npair, (T)dead);
  return (int)cudaGetLastError();
}

#define EMIT_ENTRY(T, SFX)                                                                   \
  extern "C" int knp_pair_emit_##SFX(const T* A, const T* Mpp, const T* Mpm, const T* Mmp,   \
                                     const T* Mmm, const unsigned* tab, T* pd, T* pe,        \
                                     const T* add_pd, const T* add_pe, const T* reg,         \
                                     T* pdiag, int m, int nd, int S, int nf1, int npair,     \
                                     double dead, void* stream) {                            \
    return pair_emit_launch<T>(A, Mpp, Mpm, Mmp, Mmm, tab, pd, pe, add_pd, add_pe, reg,      \
                               pdiag, m, nd, S, nf1, npair, dead, stream);                   \
  }

EMIT_ENTRY(float, f32)
EMIT_ENTRY(double, f64)
