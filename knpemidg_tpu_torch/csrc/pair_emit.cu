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
// Bound: device-memory bandwidth.  Each call writes the pair operator once
// (256 values per pair and system at nd = 4, S = 6) and reads A_cell and
// the four facet-block arrays; at the main-path shapes (63,558 pairs,
// 127,116 padded cells, about 250k facets) the EMI emit (m = 1) and the
// KNP emit (m = 2) together move 0.41 GB in float32 and 0.82 GB in
// float64: 123 / 244 us at 3.35 TB/s.  The facet reads are a gather.
// Design: one thread per (system, block entry (i, j), pair) with pairs
// fastest, so the pd/pe stores are coalesced rows; each thread performs the
// plain version's additions in its order (the diagonal blocks first, then
// slot 0..S-1, the dead identity last), so the result equals it exactly.
// The single-device maps only: the sharded maps' live0 is refused by the
// wrapper.
#include "common.cuh"

template <typename T>
__global__ void gather_blocks_pair_kernel(
    const T* __restrict__ A, const T* __restrict__ Mpp, const T* __restrict__ Mpm,
    const T* __restrict__ Mmp, const T* __restrict__ Mmm, const int* __restrict__ cop,
    const unsigned char* __restrict__ live1, const int* __restrict__ int_f,
    const unsigned char* __restrict__ int_p0, const int* __restrict__ ext_f,
    const unsigned char* __restrict__ ext_isp, const int* __restrict__ ext_h,
    T* __restrict__ pd, T* __restrict__ pe, const T* __restrict__ add_pd,
    const T* __restrict__ add_pe, const T* __restrict__ reg, T* __restrict__ pdiag, int m,
    int nd, int nc, int nf1, int S, int npair, T dead) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * nd * nd * npair) return;
  const int p = (int)(idx % npair);
  const long long sij = idx / npair;           // (s * nd + i) * nd + j
  const int j = (int)(sij % nd);
  const int i = (int)((sij / nd) % nd);
  const int s = (int)(sij / ((long long)nd * nd));
  const size_t np = (size_t)npair;
  const int nd2 = 2 * nd;

  const T* As = A + (size_t)sij * nc;
  const size_t mo = (size_t)sij * nf1;
  const T l1 = live1[p] ? T(1) : T(0);
  T b00 = As[cop[p]];
  T b11 = As[cop[np + p]] * l1;

  const int fi = int_f[p];
  const bool p0 = int_p0[p] != 0;
  const T gpp = Mpp[mo + fi], gmm = Mmm[mo + fi];
  const T gpm = Mpm[mo + fi], gmp = Mmp[mo + fi];
  b00 = b00 + (p0 ? gpp : gmm);
  b11 = b11 + (p0 ? gmm : gpp);
  T b01 = p0 ? gpm : gmp;
  T b10 = p0 ? gmp : gpm;

  for (int t = 0; t < S; ++t) {
    const size_t tp = (size_t)t * np + p;
    const size_t f = mo + ext_f[tp];
    const bool sel = ext_isp[tp] != 0;
    const bool h0 = ext_h[tp] == 0;
    const T dg = sel ? Mpp[f] : Mmm[f];
    const T off = sel ? Mpm[f] : Mmp[f];
    b00 = b00 + (h0 ? dg : T(0));
    b11 = b11 + (h0 ? T(0) : dg);
    const size_t po = ((size_t)s * S + t) * nd2 * nd * np;
    const size_t e0 = po + ((size_t)i * nd + j) * np + p;
    const size_t e1 = po + ((size_t)(nd + i) * nd + j) * np + p;
    T top = h0 ? off : T(0), bot = h0 ? T(0) : off;
    if (add_pe) {
      top = top + add_pe[e0];
      bot = bot + add_pe[e1];
    }
    pe[e0] = top;
    pe[e1] = bot;
  }
  b11 = b11 + ((i == j) ? dead * (T(1) - l1) : T(0));

  const size_t so = (size_t)s * nd2 * nd2 * np;
  const size_t o00 = so + ((size_t)i * nd2 + j) * np + p;
  const size_t o01 = so + ((size_t)i * nd2 + nd + j) * np + p;
  const size_t o10 = so + ((size_t)(nd + i) * nd2 + j) * np + p;
  const size_t o11 = so + ((size_t)(nd + i) * nd2 + nd + j) * np + p;
  if (add_pd) {
    b00 = b00 + add_pd[o00];
    b01 = b01 + add_pd[o01];
    b10 = b10 + add_pd[o10];
    b11 = b11 + add_pd[o11];
  }
  pd[o00] = b00;
  pd[o01] = b01;
  pd[o10] = b10;
  pd[o11] = b11;
  if (reg) {
    const T* Rs = reg + (size_t)sij * nc;
    pdiag[o00] = b00 + Rs[cop[p]];
    pdiag[o01] = b01;
    pdiag[o10] = b10;
    pdiag[o11] = b11 + Rs[cop[np + p]] * l1;
  }
}

template <typename T>
static int gather_blocks_pair_launch(const T* A, const T* Mpp, const T* Mpm, const T* Mmp,
                                     const T* Mmm, const int* cop,
                                     const unsigned char* live1, const int* int_f,
                                     const unsigned char* int_p0, const int* ext_f,
                                     const unsigned char* ext_isp, const int* ext_h,
                                     T* pd, T* pe, const T* add_pd, const T* add_pe,
                                     const T* reg, T* pdiag, int m, int nd, int nc,
                                     int nf1, int S, int npair, double dead, void* stream) {
  const unsigned int grid = knp_blocks((long long)m * nd * nd * npair);
  gather_blocks_pair_kernel<T><<<grid, KNP_THREADS, 0, (cudaStream_t)stream>>>(
      A, Mpp, Mpm, Mmp, Mmm, cop, live1, int_f, int_p0, ext_f, ext_isp, ext_h, pd, pe,
      add_pd, add_pe, reg, pdiag, m, nd, nc, nf1, S, npair, (T)dead);
  return (int)cudaGetLastError();
}

extern "C" int knp_gather_blocks_pair_f32(
    const float* A, const float* Mpp, const float* Mpm, const float* Mmp,
    const float* Mmm, const int* cop, const unsigned char* live1, const int* int_f,
    const unsigned char* int_p0, const int* ext_f, const unsigned char* ext_isp,
    const int* ext_h, float* pd, float* pe, const float* add_pd, const float* add_pe,
    const float* reg, float* pdiag, int m, int nd, int nc, int nf1, int S, int npair,
    double dead, void* stream) {
  return gather_blocks_pair_launch<float>(A, Mpp, Mpm, Mmp, Mmm, cop, live1, int_f, int_p0,
                                          ext_f, ext_isp, ext_h, pd, pe, add_pd, add_pe, reg,
                                          pdiag, m, nd, nc, nf1, S, npair, dead, stream);
}

extern "C" int knp_gather_blocks_pair_f64(
    const double* A, const double* Mpp, const double* Mpm, const double* Mmp,
    const double* Mmm, const int* cop, const unsigned char* live1, const int* int_f,
    const unsigned char* int_p0, const int* ext_f, const unsigned char* ext_isp,
    const int* ext_h, double* pd, double* pe, const double* add_pd, const double* add_pe,
    const double* reg, double* pdiag, int m, int nd, int nc, int nf1, int S, int npair,
    double dead, void* stream) {
  return gather_blocks_pair_launch<double>(A, Mpp, Mpm, Mmp, Mmm, cop, live1, int_f,
                                           int_p0, ext_f, ext_isp, ext_h, pd, pe, add_pd,
                                           add_pe, reg, pdiag, m, nd, nc, nf1, S, npair,
                                           dead, stream);
}
