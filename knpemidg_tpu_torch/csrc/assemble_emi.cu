// Kernel K10: assembly of the EMI (potential) system, degree 1.
//
// Replaces knpemidg_tpu/ops/assembly.py:289 assemble_emi with its helpers
// _sip_blocks (:197), _jump_jump_blocks (:250), _test_integrals (:275),
// gather_blocks (:156) and gather_rhs (:183), which XLA lowers to einsums,
// gathers and selects on the TPU.  Three launches per assembly:
//
//   emi_cell       per cell: kappa = F psi sum_k z_k^2 D_k c_k (nodal), its
//                  cell mean kbar, the ion flux sum_k z_k D_k grad(c_k) and
//                  the cell part of the rhs -F vol flux . grad(basis);
//   emi_facet      per facet: the four SIP + penalty blocks (plus the C_phi
//                  jump-jump blocks on membrane facets) Mpp, Mpm, Mmp, Mmm
//                  (nd, nd, nf+1), and the facet rhs parts b_p, b_m (nd, nf+1)
//                  with the flux average and the Robin membrane source, read
//                  through the inverse membrane map (a gather, no scatter);
//   emi_emit_cell  per cell: A_cell = vol kbar GG plus the d+1 gathered facet
//                  blocks -> block-ELL operator (K, nd, nd, nc), the rhs
//                  (nd, nc) and P_diag = diagonal + vol kbar / Lp^2 M0; for
//                  the pair layout it writes A_cell, the regularisation and
//                  the rhs, and the pair emit (csrc/pair_emit.cu) does the
//                  gathers.
//
// Bound: device-memory bandwidth.  The facet kernel must read the trace
// tables f_Rp/f_Rm and the four static E tensors once and write four facet
// block arrays; the emit reads those and writes the operator.  Design: one
// thread per (block entry (i, j), facet or cell) with the long axis fastest,
// so every store is a coalesced row and a thread keeps a dozen accumulators
// (one thread per facet with four nd x nd blocks over the quadrature points
// would spill).  Each (i, j) thread recomputes its facet's kappa traces from
// the cached tables.  Masked-out and dummy facets are written with selects,
// never products, so their blocks are exactly zero whatever their traces.
// No atomics: results repeat bit for bit.  The emit adds in the plain
// version's order (A_cell, slot 0..d) and the file is compiled without
// fused multiply-adds, so the emit equals its plain version exactly.
#include "common.cuh"

#define KNP_MAXND 4
#define KNP_MAXD 3

template <typename T>
__global__ void emi_cell_kernel(const T* __restrict__ z, const T* __restrict__ D,
                                const T* __restrict__ c, const T* __restrict__ G,
                                const T* __restrict__ vol, const T* __restrict__ phibar,
                                T* __restrict__ kappa, T* __restrict__ kbar,
                                T* __restrict__ flux, T* __restrict__ bcell, int n_ions,
                                int nd, int d, int nc, T Fpsi, T negF) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= nc) return;
  const size_t n = (size_t)nc;
  T g[KNP_MAXND][KNP_MAXD];
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a)
#pragma unroll
    for (int e = 0; e < KNP_MAXD; ++e)
      g[a][e] = (a < nd && e < d) ? G[((size_t)a * d + e) * n + cell] : T(0);
  T kap[KNP_MAXND], fl[KNP_MAXD];
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a) kap[a] = T(0);
#pragma unroll
  for (int e = 0; e < KNP_MAXD; ++e) fl[e] = T(0);
  for (int k = 0; k < n_ions; ++k) {
    const T zk = z[k], Dk = D[(size_t)k * n + cell];
    T ck[KNP_MAXND];
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a)
      ck[a] = a < nd ? c[((size_t)k * nd + a) * n + cell] : T(0);
    const T zzD = (zk * zk) * Dk, zD = zk * Dk;
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a) kap[a] += zzD * ck[a];
#pragma unroll
    for (int e = 0; e < KNP_MAXD; ++e) {
      T gk = T(0);
#pragma unroll
      for (int a = 0; a < KNP_MAXND; ++a) gk += g[a][e] * ck[a];
      fl[e] += zD * gk;
    }
  }
  T kb = T(0);
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a)
    if (a < nd) {
      const T kv = Fpsi * kap[a];
      kappa[(size_t)a * n + cell] = kv;
      kb += phibar[a] * kv;
    }
  kbar[cell] = kb;
#pragma unroll
  for (int e = 0; e < KNP_MAXD; ++e)
    if (e < d) flux[(size_t)e * n + cell] = fl[e];
  const T s = negF * vol[cell];
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a)
    if (a < nd) {
      T acc = T(0);
#pragma unroll
      for (int e = 0; e < KNP_MAXD; ++e) acc += fl[e] * g[a][e];
      bcell[(size_t)a * n + cell] = s * acc;
    }
}

template <typename T>
__global__ void emi_facet_kernel(
    const T* __restrict__ kappa, const T* __restrict__ flux, const T* __restrict__ gr,
    const int* __restrict__ inv_mem, const int* __restrict__ f_cp,
    const int* __restrict__ f_cm, const T* __restrict__ f_n, const T* __restrict__ f_area,
    const T* __restrict__ f_havg, const T* __restrict__ f_Rp, const T* __restrict__ f_Rm,
    const T* __restrict__ gnp, const T* __restrict__ gnm, const T* __restrict__ E_pp,
    const T* __restrict__ E_pm, const T* __restrict__ E_mp, const T* __restrict__ E_mm,
    const T* __restrict__ w_f, const unsigned char* __restrict__ f_sip,
    const unsigned char* __restrict__ f_mem, T* __restrict__ Mpp, T* __restrict__ Mpm,
    T* __restrict__ Mmp, T* __restrict__ Mmm, T* __restrict__ b_p, T* __restrict__ b_m,
    int nq, int nd, int d, int nc, int nf1, T tau, T C_phi, T F) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nd * nd * nf1) return;
  const int f = (int)(idx % nf1);
  const int ij = (int)(idx / nf1);
  const int j = ij % nd, i = ij / nd;
  const size_t n1 = (size_t)nf1, n = (size_t)nc;
  const bool sip = f_sip[f] != 0, mem = f_mem[f] != 0;
  const int cp = f_cp[f], cm = f_cm[f];
  const T area = f_area[f];

  T kP[KNP_MAXND], kM[KNP_MAXND];
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a) {
    kP[a] = a < nd ? kappa[(size_t)a * n + cp] : T(0);
    kM[a] = a < nd ? kappa[(size_t)a * n + cm] : T(0);
  }
  // S(R_v, k_u)[row] = sum_q (w_q k_u[q]) R_v[q, row] at rows i and j; the
  // penalty sums sum_q (w_q pen_q) (R_v[q, i] R_u[q, j]); sum_q w_q R[q, i]
  T sPp_i = 0, sPm_i = 0, sMp_i = 0, sMm_i = 0;
  T sPp_j = 0, sPm_j = 0, sMp_j = 0, sMm_j = 0;
  T Ppp = 0, Ppm = 0, Pmp = 0, Pmm = 0, wRp = 0, wRm = 0;
  for (int q = 0; q < nq; ++q) {
    const T* Rp = f_Rp + (size_t)q * nd * n1 + f;
    const T* Rm = f_Rm + (size_t)q * nd * n1 + f;
    T kp = T(0), km = T(0);
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a)
      if (a < nd) {
        kp += Rp[(size_t)a * n1] * kP[a];
        km += Rm[(size_t)a * n1] * kM[a];
      }
    const T rp_i = Rp[(size_t)i * n1], rp_j = Rp[(size_t)j * n1];
    const T rm_i = Rm[(size_t)i * n1], rm_j = Rm[(size_t)j * n1];
    const T w = w_f[q];
    const T wkp = w * kp, wkm = w * km;
    sPp_i += wkp * rp_i;  sPp_j += wkp * rp_j;
    sPm_i += wkm * rp_i;  sPm_j += wkm * rp_j;
    sMp_i += wkp * rm_i;  sMp_j += wkp * rm_j;
    sMm_i += wkm * rm_i;  sMm_j += wkm * rm_j;
    const T wpen = w * (T(0.5) * (kp + km));
    Ppp += wpen * (rp_i * rp_j);
    Ppm += wpen * (rp_i * rm_j);
    Pmp += wpen * (rm_i * rp_j);
    Pmm += wpen * (rm_i * rm_j);
    wRp += w * rp_i;
    wRm += w * rm_i;
  }
  const T gnp_i = gnp[(size_t)i * n1 + f], gnp_j = gnp[(size_t)j * n1 + f];
  const T gnm_i = gnm[(size_t)i * n1 + f], gnm_j = gnm[(size_t)j * n1 + f];
  const T hm = T(-0.5) * area, hp = T(0.5) * area;
  // -<avg(k grad u).n, [v]> and its transposed twin with the sides swapped
  const T t1_pp = (hm * sPp_i) * gnp_j, t2_pp = (hm * sPp_j) * gnp_i;
  const T t1_pm = (hm * sPm_i) * gnm_j, t2_pm = (hp * sMp_j) * gnp_i;
  const T t1_mp = (hp * sMp_i) * gnp_j, t2_mp = (hm * sPm_j) * gnm_i;
  const T t1_mm = (hp * sMm_i) * gnm_j, t2_mm = (hp * sMm_j) * gnm_i;
  const T scale = (tau / f_havg[f]) * area;
  const T cs = mem ? C_phi * area : T(0);
  const size_t o = (size_t)ij * n1 + f;
  Mpp[o] = (sip ? (t1_pp + t2_pp) + scale * Ppp : T(0)) + cs * E_pp[o];
  Mpm[o] = (sip ? (t1_pm + t2_pm) + (-scale) * Ppm : T(0)) + (-cs) * E_pm[o];
  Mmp[o] = (sip ? (t1_mp + t2_mp) + (-scale) * Pmp : T(0)) + (-cs) * E_mp[o];
  Mmm[o] = (sip ? (t1_mm + t2_mm) + scale * Pmm : T(0)) + cs * E_mm[o];

  if (j != 0) return;
  // facet rhs: the flux average on SIP facets, the Robin source on membranes
  T fp = T(0), fm = T(0);
#pragma unroll
  for (int e = 0; e < KNP_MAXD; ++e)
    if (e < d) {
      const T ne = f_n[(size_t)e * n1 + f];
      fp += flux[(size_t)e * n + cp] * ne;
      fm += flux[(size_t)e * n + cm] * ne;
    }
  const T favg = sip ? (T(0.5) * F) * (fp + fm) : T(0);
  // sum_q (w_q favg) R[q, i] with favg constant over the quadrature points
  T bp = T(0), bm = T(0);
  for (int q = 0; q < nq; ++q) {
    const T wf = w_f[q] * favg;
    bp += wf * f_Rp[((size_t)q * nd + i) * n1 + f];
    bm += (-wf) * f_Rm[((size_t)q * nd + i) * n1 + f];
  }
  bp = area * bp;
  bm = area * bm;
  const int mi = inv_mem[f];
  if (mi >= 0) {
    const T src = (C_phi * gr[mi]) * area;
    bp += (-src) * wRp;
    bm += src * wRm;
  }
  b_p[(size_t)i * n1 + f] = bp;
  b_m[(size_t)i * n1 + f] = bm;
}

template <typename T>
__global__ void emi_emit_cell_kernel(
    const T* __restrict__ kbar, const T* __restrict__ vol, const T* __restrict__ GG,
    const T* __restrict__ M0, const T* __restrict__ Mpp, const T* __restrict__ Mpm,
    const T* __restrict__ Mmp, const T* __restrict__ Mmm, const T* __restrict__ bcell,
    const T* __restrict__ b_p, const T* __restrict__ b_m, const int* __restrict__ cf_idx,
    const unsigned char* __restrict__ cf_isp, T* __restrict__ blocks, T* __restrict__ rhs,
    T* __restrict__ pdiag, int nd, int nfac, int nc, int nf1, int pair, T inv_Lp2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nd * nd * nc) return;
  const int cell = (int)(idx % nc);
  const int ij = (int)(idx / nc);
  const int j = ij % nd, i = ij / nd;
  const size_t n = (size_t)nc, n1 = (size_t)nf1;
  const T vk = vol[cell] * kbar[cell];
  T diag = vk * GG[(size_t)ij * n + cell];
  const T reg = (vk * inv_Lp2) * M0[ij];
  if (pair) {
    blocks[(size_t)ij * n + cell] = diag;
    pdiag[(size_t)ij * n + cell] = reg;
  } else {
    const size_t mo = (size_t)ij * n1;
    for (int l = 0; l < nfac; ++l) {
      const int f = cf_idx[(size_t)l * n + cell];
      const bool sel = cf_isp[(size_t)l * n + cell] != 0;
      diag = diag + (sel ? Mpp[mo + f] : Mmm[mo + f]);
      blocks[((size_t)(l + 1) * nd * nd + ij) * n + cell] = sel ? Mpm[mo + f] : Mmp[mo + f];
    }
    blocks[(size_t)ij * n + cell] = diag;
    pdiag[(size_t)ij * n + cell] = diag + reg;
  }
  if (j != 0) return;
  T r = bcell[(size_t)i * n + cell];
  for (int l = 0; l < nfac; ++l) {
    const int f = cf_idx[(size_t)l * n + cell];
    const bool sel = cf_isp[(size_t)l * n + cell] != 0;
    r = r + (sel ? b_p[(size_t)i * n1 + f] : b_m[(size_t)i * n1 + f]);
  }
  rhs[(size_t)i * n + cell] = r;
}

#define KNP_EMI_ENTRY(SFX, T)                                                            \
  extern "C" int knp_emi_cell##SFX(const T* z, const T* D, const T* c, const T* G,       \
                                   const T* vol, const T* phibar, T* kappa, T* kbar,     \
                                   T* flux, T* bcell, int n_ions, int nd, int d, int nc, \
                                   double Fpsi, double negF, void* stream) {             \
    emi_cell_kernel<T><<<knp_blocks(nc), KNP_THREADS, 0, (cudaStream_t)stream>>>(        \
        z, D, c, G, vol, phibar, kappa, kbar, flux, bcell, n_ions, nd, d, nc, (T)Fpsi,   \
        (T)negF);                                                                        \
    return (int)cudaGetLastError();                                                      \
  }                                                                                      \
  extern "C" int knp_emi_facet##SFX(                                                     \
      const T* kappa, const T* flux, const T* gr, const int* inv_mem, const int* f_cp,   \
      const int* f_cm, const T* f_n, const T* f_area, const T* f_havg, const T* f_Rp,    \
      const T* f_Rm, const T* gnp, const T* gnm, const T* E_pp, const T* E_pm,           \
      const T* E_mp, const T* E_mm, const T* w_f, const unsigned char* f_sip,            \
      const unsigned char* f_mem, T* Mpp, T* Mpm, T* Mmp, T* Mmm, T* b_p, T* b_m,        \
      int nq, int nd, int d, int nc, int nf1, double tau, double C_phi, double F,        \
      void* stream) {                                                                    \
    emi_facet_kernel<T><<<knp_blocks((long long)nd * nd * nf1), KNP_THREADS, 0,          \
                          (cudaStream_t)stream>>>(                                       \
        kappa, flux, gr, inv_mem, f_cp, f_cm, f_n, f_area, f_havg, f_Rp, f_Rm, gnp, gnm, \
        E_pp, E_pm, E_mp, E_mm, w_f, f_sip, f_mem, Mpp, Mpm, Mmp, Mmm, b_p, b_m, nq, nd, \
        d, nc, nf1, (T)tau, (T)C_phi, (T)F);                                             \
    return (int)cudaGetLastError();                                                      \
  }                                                                                      \
  extern "C" int knp_emi_emit_cell##SFX(                                                 \
      const T* kbar, const T* vol, const T* GG, const T* M0, const T* Mpp, const T* Mpm, \
      const T* Mmp, const T* Mmm, const T* bcell, const T* b_p, const T* b_m,            \
      const int* cf_idx, const unsigned char* cf_isp, T* blocks, T* rhs, T* pdiag,       \
      int nd, int nfac, int nc, int nf1, int pair, double inv_Lp2, void* stream) {       \
    emi_emit_cell_kernel<T><<<knp_blocks((long long)nd * nd * nc), KNP_THREADS, 0,       \
                              (cudaStream_t)stream>>>(                                   \
        kbar, vol, GG, M0, Mpp, Mpm, Mmp, Mmm, bcell, b_p, b_m, cf_idx, cf_isp, blocks,  \
        rhs, pdiag, nd, nfac, nc, nf1, pair, (T)inv_Lp2);                                \
    return (int)cudaGetLastError();                                                      \
  }

KNP_EMI_ENTRY(_f32, float)
KNP_EMI_ENTRY(_f64, double)
