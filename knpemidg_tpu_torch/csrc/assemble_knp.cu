// Kernel K11: assembly of the KNP systems of all solved ions, degree 1.
//
// Replaces knpemidg_tpu/ops/assembly.py:678 assemble_knp_all (and the
// alpha_sum einsum of its caller), which XLA lowers to einsums, stacked
// gathers, selects and one scatter on the TPU.  Launches per assembly:
//
//   alpha_sum         per node: sum_k z_k^2 D_k c_k over all ions, the
//                     solved ions' c and the eliminated ion's c_elim read
//                     in place through two pointers (see its note below);
//   ion_cell          per cell: grad(phi), the drift G . grad(phi) and the
//                     mass part of the rhs (vol/dt) M0 c_n;
//   ion_facet         per facet: the upwind switch u_p, u_m shared by the
//                     ions (max(D un, 0) = D max(un, 0) since D > 0) and the
//                     m ions' four upwind blocks (m, nd, nd, nf+1): a
//                     facet's scalars, then the sweep over its entries;
//   ion_membrane_emit the membrane rhs and the emit in one call of two
//                     launches (see its note below): on the membrane-facet
//                     axis the ion fractions alpha at both cells, the phi
//                     jump, the capacitive and channel sources and their
//                     quadrature sums -> b_p, b_m (m, nd, n_mem); per cell
//                     and ion the drift block, the d+1 gathered upwind
//                     blocks, the static operator added last ->
//                     (m, K, nd, nd, nc), and the rhs with the membrane parts
//                     read through the packed membrane slots (no zero-filled
//                     scatter target); for the pair layout it writes the
//                     drift blocks and the rhs, and the pair emit
//                     (csrc/pair_emit.cu) gathers and adds the static part.
//
// Bound: device-memory bandwidth (the emit reads the static operator and
// writes the operator; the facet kernel reads the four E tensors and writes
// 4 m facet-block arrays).  Design as csrc/assemble_emi.cu: one thread per
// (entry (i, j), facet or cell) with the long axis fastest, selects for the
// masks, no atomics, the plain version's order of additions in the emit and
// no fused multiply-adds in this file, so the emit equals its plain version
// exactly.  ion_facet computes a facet's scalars once (a thread a facet)
// before the sweep over its entries.
#include "common.cuh"

#define KNP_MAXND 4
#define KNP_MAXD 3
#define KNP_MAXQ 12           // facet quadrature points of ion_membrane_emit

// alpha_sum: a thread one node, the row from the grid's y index; ND and
// the ion count NI known at compile time.  Bound: bytes (D (NI, nc) and the
// NI ions' c read, alpha (ND, nc) written; D's rows are read again by each
// row's blocks, from L2).  Two nodes a thread with vector accesses measured
// no faster on the H100 (0-1% in float, one node 2-4% faster in double).  A
// node's loads (D, the NI - 1 solved ions' c, then c_elim) are issued
// before its first product, and the sum runs over k = 0..NI-1 in the
// earlier kernel's order, c_elim last, without contraction (this file's
// -fmad=false): acc += (zz_k D_k) c_k from zero, so alpha keeps its bits.
// zz = z * z rounded in T comes by value from the tables
// (ops/assembly.py: the solver's cell tables on the step's route, tables
// made for the call on the public route).
template <typename T>
struct AlphaArgs {
  const T *D, *c, *ce;       // D (NI, nc), c (NI - 1, ND, nc), ce (ND, nc)
  T* out;
  T zz[KNP_CELL_MAXI];
  int nc;
};

template <typename T, int ND, int NI>
__global__ void __launch_bounds__(KNP_THREADS) alpha_sum_kernel(const AlphaArgs<T> p) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= p.nc) return;
  const int a = blockIdx.y;
  const size_t n = (size_t)p.nc;
  T d[NI], ck[NI];
#pragma unroll
  for (int k = 0; k < NI; ++k) d[k] = p.D[(size_t)k * n + cell];
#pragma unroll
  for (int k = 0; k < NI - 1; ++k) ck[k] = p.c[((size_t)k * ND + a) * n + cell];
  ck[NI - 1] = p.ce[(size_t)a * n + cell];
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < NI; ++k) acc += (p.zz[k] * d[k]) * ck[k];
  p.out[(size_t)a * n + cell] = acc;
}

// the nd and ion-count instantiations: nd in 2..4, 1..KNP_CELL_MAXI ions
template <typename T>
static int alpha_sum_launch(const KnpCellTables* t, const T* c, const T* ce, T* out,
                            void* stream) {
  if (t->nc < 0) return (int)cudaErrorInvalidValue;
  if (t->nc == 0) return 0;
  AlphaArgs<T> p = {static_cast<const T*>(t->D), c, ce, out, {}, t->nc};
  for (int k = 0; k < KNP_CELL_MAXI; ++k) p.zz[k] = (T)t->zz[k];
  const dim3 grid(knp_blocks(t->nc), t->nd);
  cudaStream_t st = (cudaStream_t)stream;
#define ALPHA_NI(ND, NI)                                                    \
  case NI:                                                                  \
    alpha_sum_kernel<T, ND, NI><<<grid, KNP_THREADS, 0, st>>>(p);           \
    return (int)cudaGetLastError();
#define ALPHA_ND(ND)                                                                        \
  case ND:                                                                                  \
    switch (t->n_ions) {                                                                    \
      ALPHA_NI(ND, 1) ALPHA_NI(ND, 2) ALPHA_NI(ND, 3)                                       \
      ALPHA_NI(ND, 4) ALPHA_NI(ND, 5) ALPHA_NI(ND, 6)                                       \
    }                                                                                       \
    return (int)cudaErrorInvalidValue;
  switch (t->nd) {
    ALPHA_ND(2)
    ALPHA_ND(3)
    ALPHA_ND(4)
  }
#undef ALPHA_ND
#undef ALPHA_NI
  return (int)cudaErrorInvalidValue;
}

// ion_cell: two cells a thread where every row can be read in pairs, else
// one, ND, D = ND - 1 and the solved ions NM known at compile time, as
// csrc/assemble_emi.cu's emi_cell: each cell's values (G, phi, every
// ion's c_n, vol) are loaded before its first arithmetic, M0 and dt come
// by value, and the sums run in the order of the earlier runtime-shaped
// kernel without contraction, so every output keeps its bits.
template <typename T>
struct IonCellArgs {
  const T *G, *vol, *phi, *c_n;
  T *gphi, *drift, *bcell;
  T M0[KNP_MAXND * KNP_MAXND];   // (ND, ND) row by row
  T dt;
  int nc;
};

template <typename T, int ND, int NM, int CPT>
__global__ void __launch_bounds__(KNP_THREADS) ion_cell_kernel(const IonCellArgs<T> p) {
  constexpr int D = ND - 1;
  const int cell = (blockIdx.x * blockDim.x + threadIdx.x) * CPT;
  if (cell >= p.nc) return;
  const size_t n = (size_t)p.nc;
  T g[ND][D][CPT], ph[ND][CPT], ck[NM][ND][CPT], vol[CPT];
#pragma unroll
  for (int a = 0; a < ND; ++a) {
#pragma unroll
    for (int e = 0; e < D; ++e) knp_ld<T, CPT>(p.G + ((size_t)a * D + e) * n + cell, g[a][e]);
    knp_ld<T, CPT>(p.phi + (size_t)a * n + cell, ph[a]);
  }
#pragma unroll
  for (int k = 0; k < NM; ++k)
#pragma unroll
    for (int a = 0; a < ND; ++a) knp_ld<T, CPT>(p.c_n + ((size_t)k * ND + a) * n + cell, ck[k][a]);
  knp_ld<T, CPT>(p.vol + cell, vol);
  T gp_o[D][CPT], dr_o[ND][CPT], bc_o[NM][ND][CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    T gp[D];
#pragma unroll
    for (int e = 0; e < D; ++e) gp[e] = T(0);
#pragma unroll
    for (int a = 0; a < ND; ++a)
#pragma unroll
      for (int e = 0; e < D; ++e) gp[e] += g[a][e][q] * ph[a][q];
#pragma unroll
    for (int e = 0; e < D; ++e) gp_o[e][q] = gp[e];
#pragma unroll
    for (int a = 0; a < ND; ++a) {
      T acc = T(0);
#pragma unroll
      for (int e = 0; e < D; ++e) acc += g[a][e][q] * gp[e];
      dr_o[a][q] = acc;
    }
    const T vdt = vol[q] / p.dt;
#pragma unroll
    for (int k = 0; k < NM; ++k)
#pragma unroll
      for (int a = 0; a < ND; ++a) {
        T acc = T(0);
#pragma unroll
        for (int b = 0; b < ND; ++b) acc += p.M0[a * ND + b] * ck[k][b][q];
        bc_o[k][a][q] = vdt * acc;
      }
  }
#pragma unroll
  for (int e = 0; e < D; ++e) knp_st<T, CPT>(p.gphi + (size_t)e * n + cell, gp_o[e]);
#pragma unroll
  for (int a = 0; a < ND; ++a) knp_st<T, CPT>(p.drift + (size_t)a * n + cell, dr_o[a]);
#pragma unroll
  for (int k = 0; k < NM; ++k)
#pragma unroll
    for (int a = 0; a < ND; ++a)
      knp_st<T, CPT>(p.bcell + ((size_t)k * ND + a) * n + cell, bc_o[k][a]);
}

template <typename T, int ND, int NM>
static int ion_cell_run(const IonCellArgs<T>& p, bool two, cudaStream_t st) {
  if (two)
    ion_cell_kernel<T, ND, NM, 2><<<knp_blocks((p.nc + 1) / 2), KNP_THREADS, 0, st>>>(p);
  else
    ion_cell_kernel<T, ND, NM, 1><<<knp_blocks(p.nc), KNP_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// the ND and ion-count instantiations: nd = d + 1 in 2..4, 1..KNP_CELL_MAXI
// solved ions; two cells a thread where every row can be read in pairs
template <typename T>
static int ion_cell_launch(const KnpCellTables* t, const T* phi, const T* c_n, T* gphi,
                           T* drift, T* bcell, int m, double dt, void* stream) {
  if (t->d != t->nd - 1 || t->nc < 0) return (int)cudaErrorInvalidValue;
  if (t->nc == 0) return 0;
  IonCellArgs<T> p;
  p.G = static_cast<const T*>(t->G);
  p.vol = static_cast<const T*>(t->vol);
  p.phi = phi;
  p.c_n = c_n;
  p.gphi = gphi;
  p.drift = drift;
  p.bcell = bcell;
  for (int i = 0; i < KNP_MAXND * KNP_MAXND; ++i) p.M0[i] = (T)t->M0[i];
  p.dt = (T)dt;
  p.nc = t->nc;
  const size_t v = 2 * sizeof(T);
  const bool two = t->nc % 2 == 0 && knp_aligned(t->G, v) &&
                   knp_aligned(t->vol, v) && knp_aligned(phi, v) && knp_aligned(c_n, v) &&
                   knp_aligned(gphi, v) && knp_aligned(drift, v) && knp_aligned(bcell, v);
  cudaStream_t st = (cudaStream_t)stream;
#define ION_CELL_NM(ND, NM) \
  case NM:                  \
    return ion_cell_run<T, ND, NM>(p, two, st);
#define ION_CELL_ND(ND)                                                                     \
  case ND:                                                                                  \
    switch (m) {                                                                            \
      ION_CELL_NM(ND, 1) ION_CELL_NM(ND, 2) ION_CELL_NM(ND, 3)                              \
      ION_CELL_NM(ND, 4) ION_CELL_NM(ND, 5) ION_CELL_NM(ND, 6)                              \
    }                                                                                       \
    return (int)cudaErrorInvalidValue;
  switch (t->nd) {
    ION_CELL_ND(2)
    ION_CELL_ND(3)
    ION_CELL_ND(4)
  }
#undef ION_CELL_ND
#undef ION_CELL_NM
  return (int)cudaErrorInvalidValue;
}

// ion_facet, two kernels a call.  ion_facet_scalars_kernel computes each
// facet's scalars once, a thread a facet: the tables' loads (f_cp, f_cm,
// f_n, f_area, f_sip) issued together, then the gphi and D gathers at both
// cells together, then u_p, u_m, the base and the m ions' sp_k =
// (scale_k D_k+) u_p and sm_k = (scale_k D_k-) u_m, written to S (2m, nf+1:
// rows 2k and 2k + 1; a few MB, which stay in L2).  ion_facet_kernel then
// sweeps the nd x nd x (nf+1) entries (a thread an entry, the facet
// fastest), reading E_pp .. E_mm once with the streaming hint and writing
// the 4 m rows of M with streaming stores.  The sweep keeps the device's
// traffic on a dozen arrays at nearby offsets; streaming a 32-facet tile
// through all nd x nd rows at once (as emi_facet does) spreads it over 192
// short runs and measured slower on the H100 than this sweep, and no faster
// than a sweep that recomputes the scalars for every entry.  The products
// are in the plain version's order and without contraction (this file's
// -fmad=false): unp += gphi ne over e from 0, (negpsi z_k) base, (scale D)
// u, sp E, (-sm) E, (-sp) E, sm E, so every output equals knp_facet_plain's
// exactly.
template <typename T>
__global__ void ion_facet_scalars_kernel(
    const T* __restrict__ gphi, const T* __restrict__ D, const T* __restrict__ z,
    const int* __restrict__ f_cp, const int* __restrict__ f_cm, const T* __restrict__ f_n,
    const T* __restrict__ f_area, const unsigned char* __restrict__ f_sip, T* __restrict__ S,
    int m, int d, int nc, int nf1, T negpsi) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nf1) return;
  const size_t n = (size_t)nc, n1 = (size_t)nf1;
  const int cp = f_cp[f], cm = f_cm[f];
  const bool sip = f_sip[f] != 0;
  const T area = f_area[f];
  T ne[KNP_MAXD], gp[KNP_MAXD], gm[KNP_MAXD];
#pragma unroll
  for (int e = 0; e < KNP_MAXD; ++e) ne[e] = e < d ? f_n[(size_t)e * n1 + f] : T(0);
#pragma unroll
  for (int e = 0; e < KNP_MAXD; ++e) {
    gp[e] = e < d ? gphi[(size_t)e * n + cp] : T(0);
    gm[e] = e < d ? gphi[(size_t)e * n + cm] : T(0);
  }
  T unp = T(0), unm = T(0);
#pragma unroll
  for (int e = 0; e < KNP_MAXD; ++e)
    if (e < d) {
      unp += gp[e] * ne[e];
      unm += gm[e] * ne[e];
    }
  const T u_p = unp > T(0) ? unp : T(0);
  const T u_m = -unm > T(0) ? -unm : T(0);
  const T base = sip ? area : T(0);
  for (int k = 0; k < m; ++k) {
    const T Dp = D[(size_t)k * n + cp], Dm = D[(size_t)k * n + cm];
    const T scale = (negpsi * z[k]) * base;
    S[(size_t)(2 * k) * n1 + f] = (scale * Dp) * u_p;
    S[(size_t)(2 * k + 1) * n1 + f] = (scale * Dm) * u_m;
  }
}

template <typename T>
__global__ void ion_facet_kernel(const T* __restrict__ S, const T* __restrict__ E_pp,
                                 const T* __restrict__ E_pm, const T* __restrict__ E_mp,
                                 const T* __restrict__ E_mm, T* __restrict__ Mpp,
                                 T* __restrict__ Mpm, T* __restrict__ Mmp, T* __restrict__ Mmm,
                                 int m, int nd, int nf1) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)nd * nd * nf1;
  if (idx >= per) return;
  const int f = (int)(idx % nf1);
  const size_t n1 = (size_t)nf1;
  const T epp = __ldcs(E_pp + idx), epm = __ldcs(E_pm + idx);
  const T emp = __ldcs(E_mp + idx), emm = __ldcs(E_mm + idx);
  for (int k = 0; k < m; ++k) {
    const T sp = S[(size_t)(2 * k) * n1 + f], sm = S[(size_t)(2 * k + 1) * n1 + f];
    const size_t o = (size_t)k * per + idx;
    __stcs(Mpp + o, sp * epp);
    __stcs(Mpm + o, (-sm) * epm);
    __stcs(Mmp + o, (-sp) * emp);
    __stcs(Mmm + o, sm * emm);
  }
}

// ion_membrane_emit: the membrane rhs and the emit of one KNP assembly in
// one call of two launches.  Static tables, built and checked once per
// solver (ops/assembly.knp_emit_tables), read through KnpEmitTables:
//   slots  (nfac, nc) a word per cell-facet slot: the facet index (bits
//          0-29), "the facet is a membrane facet" (bit 30), cf_is_plus
//          (bit 31) -- one load in place of cf_idx and cf_is_plus;
//   cells  (1 + nfac, ncm) the cells with a membrane slot: row 0 the cell,
//          row 1 + l slot l's word: the membrane slot mi (bits 0-29),
//          "membrane" (bit 30), cf_is_plus (bit 31) -- one load in place of
//          cf_idx -> inv_mem[cf_idx];
//   mcell  (2, nm) the membrane facets' cells cp, cm; area (nm,) =
//          f_area[fidx], so no fidx -> f_area chain.
// ion_membrane_emit_kernel, a thread an item over nm + m nd nc items:
//   * a membrane facet: its cells and the ion-independent part (the phi
//     gathers, jphi at each quadrature point) once, then each ion's
//     fractions, sources and quadrature sums -> b_p, b_m (the step's
//     buffers), within round-off of the plain version;
//   * a (k, i, cell) row: the slot words loaded first, the drift factor
//     once, then the nd entries of the row: the drift blocks (pair layout),
//     or the gathered upwind blocks plus the static operator (cell layout),
//     in the plain version's order; and the rhs row of a cell with no
//     membrane slot (b_cell plus its zero slot terms).
// ion_membrane_emit_rows_kernel then writes only the rhs rows of the ncm
// membrane cells, each slot reading b through its one word.  The membrane
// facets' dependent chains run beside the emit rows instead of on a grid of
// their own.  A cooperative design (the rows after a grid barrier in one
// launch, the grid at the co-resident limit) measured slower on the pair
// layout: 35.7-37.3 / 59.0-60.0 us a call against 22.9-23.5 / 38.4-45.1
// (float32 / float64, graph replay, time_wrappers.py --only k11e; PERF.md).
// The cell layout's instantiation asks for 4 resident blocks an SM (64
// registers: its emit rows are bound by device-memory bytes and need the
// warps), the pair layout's for none (its rows are light; the membrane
// facets' chains run faster unspilled).  With this file's -fmad=false the
// blocks and the rhs equal the plain emit's bit for bit.
struct KnpEmitTables {
  const void* Rp;        // (nq, nd, nm) membrane-presliced traces
  const void* Rm;
  const void* w_f;       // (nq,)
  const void* vol;       // (nc,)
  const void* phibar;    // (nd,)
  const void* area;      // (nm,)
  const int* slots;
  const int* cells;
  const int* mcell;
  int nq, nd, nfac, nc, nf1, nm, ncm;
};

template <typename T>
struct KnpEmitArgs {
  const T *z, *D, *c_k, *alpha_sum, *phi, *phi_M, *I_ch, *I_tot, *drift, *Mpp, *Mpm, *Mmp,
      *Mmm, *bcell, *statics;
  T *b_p, *b_m, *blocks, *rhs;
  KnpEmitTables t;
  int m, splitting;
  T F, Cfac0, psi;
};

// A membrane facet: its pointers restrict-qualified, so each ion's loads
// may be issued before the previous ion's stores.
template <typename T>
__device__ __forceinline__ void knp_emit_membrane_facet(
    const KnpEmitArgs<T>& a, int mm, const int* __restrict__ mcell,
    const T* __restrict__ area_m, const T* __restrict__ Rp, const T* __restrict__ Rm,
    const T* __restrict__ w_f, const T* __restrict__ z, const T* __restrict__ D,
    const T* __restrict__ c_k, const T* __restrict__ alpha_sum, const T* __restrict__ phi,
    const T* __restrict__ phi_M, const T* __restrict__ I_ch, const T* __restrict__ I_tot,
    T* __restrict__ b_p, T* __restrict__ b_m) {
  const KnpEmitTables& t = a.t;
  const int nd = t.nd, nq = t.nq, nm = t.nm;
  const size_t n = (size_t)t.nc, nmm = (size_t)nm;
  const int cp = mcell[mm], cm = mcell[nm + mm];
  const T area = area_m[mm];
  const T phiM = phi_M[mm], Itot = I_tot[mm];
  T php[KNP_MAXND], phm[KNP_MAXND];
#pragma unroll
  for (int e = 0; e < KNP_MAXND; ++e) {
    const bool on = e < nd;
    php[e] = on ? phi[(size_t)e * n + cp] : T(0);
    phm[e] = on ? phi[(size_t)e * n + cm] : T(0);
  }
  T jq[KNP_MAXQ];
  for (int q = 0; q < nq; ++q) {
    T tp = T(0), tm = T(0);
#pragma unroll
    for (int e = 0; e < KNP_MAXND; ++e) {
      const T rp = e < nd ? Rp[((size_t)q * nd + e) * nmm + mm] : T(0);
      const T rm = e < nd ? Rm[((size_t)q * nd + e) * nmm + mm] : T(0);
      tp += rp * php[e];
      tm += rm * phm[e];
    }
    jq[q] = tp - tm;
  }
  for (int k = 0; k < a.m; ++k) {
    const T zk = z[k];
    const T Dzz_p = D[(size_t)k * n + cp] * (zk * zk);
    const T Dzz_m = D[(size_t)k * n + cm] * (zk * zk);
    T aup[KNP_MAXND], aum[KNP_MAXND];
#pragma unroll
    for (int e = 0; e < KNP_MAXND; ++e) {
      const bool on = e < nd;
      const size_t op = (size_t)e * n + cp, om = (size_t)e * n + cm;
      aup[e] = on ? (Dzz_p * c_k[(size_t)k * nd * n + op]) / alpha_sum[op] : T(0);
      aum[e] = on ? (Dzz_m * c_k[(size_t)k * nd * n + om]) / alpha_sum[om] : T(0);
    }
    const T Cfac = a.Cfac0 / zk;            // C_M / (F dt) / z
    const T invFz = T(1) / (a.F * zk);
    const T Ikz = I_ch[(size_t)k * (nmm + 1) + mm] * invFz;
    // first pass: each point's weighted sources w vp, w vm; second pass:
    // their products with the traces summed over the points
    T wvp[KNP_MAXQ], wvm[KNP_MAXQ];
    for (int q = 0; q < nq; ++q) {
      T ap = T(0), am = T(0);
#pragma unroll
      for (int e = 0; e < KNP_MAXND; ++e) {
        const T rp = e < nd ? Rp[((size_t)q * nd + e) * nmm + mm] : T(0);
        const T rm = e < nd ? Rm[((size_t)q * nd + e) * nmm + mm] : T(0);
        ap += rp * aup[e];
        am += rm * aum[e];
      }
      const T jphi = jq[q];
      const T Cp = ap * Cfac, Cm = am * Cfac;
      const T sxp = a.splitting ? (ap * Itot) * invFz : T(0);
      const T sxm = a.splitting ? (am * Itot) * invFz : T(0);
      const T se = (Cp * phiM - Ikz) + sxp;
      const T si = (Cm * phiM - Ikz) + sxm;
      const T jC = Cp - Cm, aC = T(0.5) * (Cp + Cm);
      const T half = ((-jphi) * jC) * T(0.5);
      const T vp = -se + (half - jphi * aC);
      const T vm = si + (half + jphi * aC);
      const T w = w_f[q];
      wvp[q] = w * vp;
      wvm[q] = w * vm;
    }
    T accp[KNP_MAXND], accm[KNP_MAXND];
#pragma unroll
    for (int e = 0; e < KNP_MAXND; ++e) accp[e] = accm[e] = T(0);
    for (int q = 0; q < nq; ++q) {
#pragma unroll
      for (int e = 0; e < KNP_MAXND; ++e) {
        const T rp = e < nd ? Rp[((size_t)q * nd + e) * nmm + mm] : T(0);
        const T rm = e < nd ? Rm[((size_t)q * nd + e) * nmm + mm] : T(0);
        accp[e] += wvp[q] * rp;
        accm[e] += wvm[q] * rm;
      }
    }
#pragma unroll
    for (int e = 0; e < KNP_MAXND; ++e)
      if (e < nd) {
        b_p[((size_t)k * nd + e) * nmm + mm] = area * accp[e];
        b_m[((size_t)k * nd + e) * nmm + mm] = area * accm[e];
      }
  }
}

// A (k, i, cell) row: its pointers restrict-qualified, so the loads of the
// row's later entries may be issued before the stores of its earlier ones.
template <typename T, bool PAIR>
__device__ __forceinline__ void knp_emit_row(
    const KnpEmitArgs<T>& a, long long idx, const int* __restrict__ slots,
    const T* __restrict__ vol, const T* __restrict__ phibar, const T* __restrict__ z,
    const T* __restrict__ D, const T* __restrict__ drift, const T* __restrict__ bcell,
    const T* __restrict__ Mpp, const T* __restrict__ Mpm, const T* __restrict__ Mmp,
    const T* __restrict__ Mmm, const T* __restrict__ statics, T* __restrict__ blocks,
    T* __restrict__ rhs) {
  const KnpEmitTables& t = a.t;
  const int nd = t.nd, nfac = t.nfac, nc = t.nc;
  const int cell = (int)(idx % nc);
  const int ki = (int)(idx / nc);               // k * nd + i
  const int k = ki / nd, i = ki % nd;
  const size_t n = (size_t)nc;
  unsigned sw[KNP_MAXD + 1];
#pragma unroll
  for (int l = 0; l < KNP_MAXD + 1; ++l)
    sw[l] = l < nfac ? (unsigned)slots[(size_t)l * n + cell] : 0u;
  const T b0 = bcell[(size_t)ki * n + cell];
  const T pre = ((z[k] * a.psi) * (vol[cell] * D[(size_t)k * n + cell]))
                * drift[(size_t)i * n + cell];
  if (PAIR) {
#pragma unroll
    for (int j = 0; j < KNP_MAXND; ++j)
      if (j < nd) blocks[((size_t)ki * nd + j) * n + cell] = pre * phibar[j];
  } else {
    const int nn = nd * nd;
    const size_t n1 = (size_t)t.nf1;
    const size_t bo = (size_t)k * (nfac + 1) * nn;         // slot 0 of ion k
#pragma unroll
    for (int j = 0; j < KNP_MAXND; ++j) {
      if (j >= nd) break;
      const int ij = i * nd + j;
      const size_t mo = ((size_t)ki * nd + j) * n1;
      T diag = pre * phibar[j];
#pragma unroll
      for (int l = 0; l < KNP_MAXD + 1; ++l) {
        if (l >= nfac) break;
        const size_t f = sw[l] & KNP_IDX_MASK;
        const bool sel = (sw[l] >> 31) != 0u;
        diag = diag + (sel ? Mpp[mo + f] : Mmm[mo + f]);
        T off = sel ? Mpm[mo + f] : Mmp[mo + f];
        const size_t o = (bo + (size_t)(l + 1) * nn + ij) * n + cell;
        if (statics) off = off + statics[o];
        blocks[o] = off;
      }
      const size_t o = (bo + ij) * n + cell;
      if (statics) diag = diag + statics[o];
      blocks[o] = diag;
    }
  }
  unsigned mem = 0u;
#pragma unroll
  for (int l = 0; l < KNP_MAXD + 1; ++l) mem |= sw[l] & (1u << 30);
  if (mem) return;                              // ion_membrane_emit_rows_kernel's
  T r = b0;
  for (int l = 0; l < nfac; ++l) r = r + T(0);   // the zero terms of its slots
  rhs[(size_t)ki * n + cell] = r;
}

template <typename T>
__device__ __forceinline__ void knp_emit_membrane_row(const KnpEmitArgs<T>& a, long long idx) {
  const KnpEmitTables& t = a.t;
  const int ncm = t.ncm, nfac = t.nfac;
  const int tc = (int)(idx % ncm);
  const int ki = (int)(idx / ncm);
  const int cell = t.cells[tc];
  unsigned mw[KNP_MAXD + 1];
#pragma unroll
  for (int l = 0; l < KNP_MAXD + 1; ++l)
    mw[l] = l < nfac ? (unsigned)t.cells[(size_t)(l + 1) * ncm + tc] : 0u;
  const size_t n = (size_t)t.nc, bo = (size_t)ki * t.nm;
  T r = a.bcell[(size_t)ki * n + cell];
#pragma unroll
  for (int l = 0; l < KNP_MAXD + 1; ++l) {
    if (l >= nfac) break;
    const size_t mi = mw[l] & KNP_IDX_MASK;
    const T got = (mw[l] & (1u << 30)) ? ((mw[l] >> 31) ? a.b_p[bo + mi] : a.b_m[bo + mi])
                                       : T(0);
    r = r + got;
  }
  a.rhs[(size_t)ki * n + cell] = r;
}

template <typename T, bool PAIR>
__global__ void __launch_bounds__(KNP_THREADS, PAIR ? 1 : 4)
ion_membrane_emit_kernel(const KnpEmitArgs<T> a) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nm = a.t.nm;
  if (idx >= nm + (long long)a.m * a.t.nd * a.t.nc) return;
  if (idx < nm)
    knp_emit_membrane_facet(a, (int)idx, a.t.mcell, (const T*)a.t.area, (const T*)a.t.Rp,
                            (const T*)a.t.Rm, (const T*)a.t.w_f, a.z, a.D, a.c_k, a.alpha_sum,
                            a.phi, a.phi_M, a.I_ch, a.I_tot, a.b_p, a.b_m);
  else
    knp_emit_row<T, PAIR>(a, idx - nm, a.t.slots, (const T*)a.t.vol, (const T*)a.t.phibar,
                          a.z, a.D, a.drift, a.bcell, a.Mpp, a.Mpm, a.Mmp, a.Mmm, a.statics,
                          a.blocks, a.rhs);
}

template <typename T>
__global__ void __launch_bounds__(KNP_THREADS)
ion_membrane_emit_rows_kernel(const KnpEmitArgs<T> a) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < (long long)a.t.ncm * a.m * a.t.nd) knp_emit_membrane_row(a, idx);
}

template <typename T>
static int membrane_emit_launch(const KnpEmitArgs<T>& a, bool pair, void* stream) {
  const KnpEmitTables& t = a.t;
  if (t.nd < 1 || t.nd > KNP_MAXND || t.nfac < 1 || t.nfac > KNP_MAXD + 1 || t.nq < 0 ||
      t.nq > KNP_MAXQ || a.m < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned items = knp_blocks(t.nm + (long long)a.m * t.nd * t.nc);
  const long long rows = (long long)t.ncm * a.m * t.nd;
  if (pair)
    ion_membrane_emit_kernel<T, true><<<items, KNP_THREADS, 0, st>>>(a);
  else
    ion_membrane_emit_kernel<T, false><<<items, KNP_THREADS, 0, st>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || rows == 0) return rc;
  ion_membrane_emit_rows_kernel<T><<<knp_blocks(rows), KNP_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

#define KNP_ION_ENTRY(SFX, T)                                                            \
  extern "C" int knp_alpha_sum##SFX(const void* tables, const T* c, const T* ce, T* out,   \
                                    void* stream) {                                        \
    return alpha_sum_launch<T>(static_cast<const KnpCellTables*>(tables), c, ce, out,      \
                               stream);                                                    \
  }                                                                                        \
  extern "C" int knp_ion_cell##SFX(const void* tables, const T* phi, const T* c_n,        \
                                   T* gphi, T* drift, T* bcell, int m, double dt,          \
                                   void* stream) {                                         \
    return ion_cell_launch<T>(static_cast<const KnpCellTables*>(tables), phi, c_n, gphi,   \
                              drift, bcell, m, dt, stream);                                \
  }                                                                                        \
  extern "C" int knp_ion_facet##SFX(                                                       \
      const T* gphi, const T* D, const T* z, const int* f_cp, const int* f_cm,             \
      const T* f_n, const T* f_area, const unsigned char* f_sip, const T* E_pp,            \
      const T* E_pm, const T* E_mp, const T* E_mm, T* Mpp, T* Mpm, T* Mmp, T* Mmm, T* S,   \
      int m, int nd, int d, int nc, int nf1, double negpsi, void* stream) {                \
    cudaStream_t st = (cudaStream_t)stream;                                                \
    ion_facet_scalars_kernel<T><<<knp_blocks(nf1), KNP_THREADS, 0, st>>>(                  \
        gphi, D, z, f_cp, f_cm, f_n, f_area, f_sip, S, m, d, nc, nf1, (T)negpsi);          \
    ion_facet_kernel<T><<<knp_blocks((long long)nd * nd * nf1), KNP_THREADS, 0, st>>>(     \
        S, E_pp, E_pm, E_mp, E_mm, Mpp, Mpm, Mmp, Mmm, m, nd, nf1);                        \
    return (int)cudaGetLastError();                                                        \
  }                                                                                        \
  extern "C" int knp_membrane_emit##SFX(                                                   \
      const T* z, const T* D, const T* c_k, const T* alpha_sum, const T* phi,              \
      const T* phi_M, const T* I_ch, const T* I_tot, const T* drift, const T* Mpp,         \
      const T* Mpm, const T* Mmp, const T* Mmm, const T* bcell, const T* statics, T* b_p,  \
      T* b_m, T* blocks, T* rhs, const void* tables, int m, int splitting, int pair,       \
      double F, double Cfac0, double psi, void* stream) {                                  \
    KnpEmitArgs<T> a;                                                                      \
    a.z = z; a.D = D; a.c_k = c_k; a.alpha_sum = alpha_sum; a.phi = phi; a.phi_M = phi_M;  \
    a.I_ch = I_ch; a.I_tot = I_tot; a.drift = drift; a.Mpp = Mpp; a.Mpm = Mpm;             \
    a.Mmp = Mmp; a.Mmm = Mmm; a.bcell = bcell; a.statics = statics; a.b_p = b_p;           \
    a.b_m = b_m; a.blocks = blocks; a.rhs = rhs;                                           \
    a.t = *static_cast<const KnpEmitTables*>(tables);                                      \
    a.m = m; a.splitting = splitting;                                                      \
    a.F = (T)F; a.Cfac0 = (T)Cfac0; a.psi = (T)psi;                                        \
    return membrane_emit_launch<T>(a, pair != 0, stream);                                  \
  }

KNP_ION_ENTRY(_f32, float)
KNP_ION_ENTRY(_f64, double)
