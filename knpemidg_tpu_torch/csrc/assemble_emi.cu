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
//                  gathers.  The cell-facet slots come from the packed slot
//                  words K11's membrane emit reads (one table, built once).
//
// Bound: device-memory bandwidth.  The facet kernel must read the trace
// tables f_Rp/f_Rm, the n . grad(basis) rows and the facet scalars once,
// the static jump-jump tables E_pp..E_mm at the membrane facets only (they
// are multiplied by zero elsewhere), and write four facet block arrays and
// the two facet rhs arrays; the emit reads those and writes the operator.
// Design of the facet kernel: one block per tile of 32 facets and one warp
// per row i of the blocks, so every store is a coalesced row.  The block
// stages the tile's trace rows (nq x nd a side), both cells' kappa, the
// n . grad rows and the flux sums in shared memory with coalesced loads,
// forms each facet's kappa traces once per quadrature point, and only then
// does each (row, facet) thread sum, from shared memory, in the plain
// version's order: its row sums, shared with the other rows through shared
// memory, then one column j at a time the four penalty sums of entry
// (i, j) and the entry itself, stored before the next column's sums.  The tables are read from memory
// once a launch, not once per block entry.  A thread per (row, facet)
// rather than per (entry, facet) keeps nd times fewer threads a facet,
// so more facets are in flight on an SM at the registers a thread needs.
// The emit kernel runs one thread per (block entry, cell) with cells
// fastest; a thread per (row, cell) or per cell emits slower (each
// thread gathers from nd rows of the facet blocks at once, likely more
// than L2 keeps for the other cells of their sectors; PERF.md §6).
// Masked-out and dummy facets are written with selects, never products,
// so their blocks are exactly zero whatever their traces.
// No atomics: results repeat bit for bit.  The file is compiled without
// fused multiply-adds, so every product and sum of the facet kernel rounds
// as written, and the emit adds in the plain version's order (A_cell, slot
// 0..d) and equals its plain version exactly.
#include "common.cuh"

#define KNP_MAXND 4
#define KNP_MAXD 3
#define KNP_MAXNQ 12      // facet quadrature points: every triangle rule of fem/quadrature
#define EMI_TILE 32       // facets per emi_facet block, one a lane

// emi_cell: two cells a thread (CPT = 2: 16-byte double or 8-byte float
// vector accesses) where every row can be read in pairs, else one, the
// shapes (ND basis functions, D = ND - 1 directions, NI ions) known at
// compile time.  Two cells a thread measured 1-3% slower for emi_cell on
// the cell layout and 3-17% faster on the pair layout and for ion_cell
// (time_wrappers.py --only k10c,k11c; PERF.md §6).  Each cell's 28 values (at nd = 4, three ions: G, every
// ion's c and D, vol) are loaded before its first arithmetic, so they are
// in flight together; z, z * z, phibar, F psi and -F come by value.  The
// kernel reads each value once and writes each output once: it is bound by
// device-memory bytes, and at 124,416 cells a single wave, so what sets its
// pace is how many of a cell's loads are in flight at once.  The sums run
// in the order of the earlier runtime-shaped kernel (from zero, ions in
// order, then the basis functions) and without contraction (-fmad=false),
// so every output keeps its bits: the padded terms that kernel added were
// +0, which leaves a sum that starts from +0 unchanged.
template <typename T, int NI>
struct EmiCellArgs {
  const T *G, *vol, *D, *c;
  T *kappa, *kbar, *flux, *bcell;
  T z[NI], zz[NI], phibar[KNP_MAXND];
  T Fpsi, negF;
  int nc;
};

template <typename T, int ND, int NI, int CPT>
__global__ void __launch_bounds__(KNP_THREADS) emi_cell_kernel(const EmiCellArgs<T, NI> p) {
  constexpr int D = ND - 1;
  const int cell = (blockIdx.x * blockDim.x + threadIdx.x) * CPT;
  if (cell >= p.nc) return;
  const size_t n = (size_t)p.nc;
  T g[ND][D][CPT], ck[NI][ND][CPT], Dk[NI][CPT], vol[CPT];
#pragma unroll
  for (int a = 0; a < ND; ++a)
#pragma unroll
    for (int e = 0; e < D; ++e) knp_ld<T, CPT>(p.G + ((size_t)a * D + e) * n + cell, g[a][e]);
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    knp_ld<T, CPT>(p.D + (size_t)k * n + cell, Dk[k]);
#pragma unroll
    for (int a = 0; a < ND; ++a) knp_ld<T, CPT>(p.c + ((size_t)k * ND + a) * n + cell, ck[k][a]);
  }
  knp_ld<T, CPT>(p.vol + cell, vol);
  T kap_o[ND][CPT], kb_o[CPT], fl_o[D][CPT], bc_o[ND][CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    T kap[ND], fl[D];
#pragma unroll
    for (int a = 0; a < ND; ++a) kap[a] = T(0);
#pragma unroll
    for (int e = 0; e < D; ++e) fl[e] = T(0);
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const T zzD = p.zz[k] * Dk[k][q], zD = p.z[k] * Dk[k][q];
#pragma unroll
      for (int a = 0; a < ND; ++a) kap[a] += zzD * ck[k][a][q];
#pragma unroll
      for (int e = 0; e < D; ++e) {
        T gk = T(0);
#pragma unroll
        for (int a = 0; a < ND; ++a) gk += g[a][e][q] * ck[k][a][q];
        fl[e] += zD * gk;
      }
    }
    T kb = T(0);
#pragma unroll
    for (int a = 0; a < ND; ++a) {
      const T kv = p.Fpsi * kap[a];
      kap_o[a][q] = kv;
      kb += p.phibar[a] * kv;
    }
    kb_o[q] = kb;
#pragma unroll
    for (int e = 0; e < D; ++e) fl_o[e][q] = fl[e];
    const T s = p.negF * vol[q];
#pragma unroll
    for (int a = 0; a < ND; ++a) {
      T acc = T(0);
#pragma unroll
      for (int e = 0; e < D; ++e) acc += fl[e] * g[a][e][q];
      bc_o[a][q] = s * acc;
    }
  }
#pragma unroll
  for (int a = 0; a < ND; ++a) knp_st<T, CPT>(p.kappa + (size_t)a * n + cell, kap_o[a]);
  knp_st<T, CPT>(p.kbar + cell, kb_o);
#pragma unroll
  for (int e = 0; e < D; ++e) knp_st<T, CPT>(p.flux + (size_t)e * n + cell, fl_o[e]);
#pragma unroll
  for (int a = 0; a < ND; ++a) knp_st<T, CPT>(p.bcell + (size_t)a * n + cell, bc_o[a]);
}

template <typename T, int ND, int NI>
static int emi_cell_run(const KnpCellTables& t, const T* D, const T* c, T* kappa, T* kbar,
                        T* flux, T* bcell, double Fpsi, double negF, bool two,
                        cudaStream_t st) {
  EmiCellArgs<T, NI> p;
  p.G = static_cast<const T*>(t.G);
  p.vol = static_cast<const T*>(t.vol);
  p.D = D;
  p.c = c;
  p.kappa = kappa;
  p.kbar = kbar;
  p.flux = flux;
  p.bcell = bcell;
  for (int k = 0; k < NI; ++k) {
    p.z[k] = (T)t.z[k];
    p.zz[k] = (T)t.zz[k];
  }
  for (int a = 0; a < KNP_MAXND; ++a) p.phibar[a] = (T)t.phibar[a];
  p.Fpsi = (T)Fpsi;
  p.negF = (T)negF;
  p.nc = t.nc;
  if (two)
    emi_cell_kernel<T, ND, NI, 2><<<knp_blocks((t.nc + 1) / 2), KNP_THREADS, 0, st>>>(p);
  else
    emi_cell_kernel<T, ND, NI, 1><<<knp_blocks(t.nc), KNP_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// the ND and ion-count instantiations: nd = d + 1 in 2..4 (degree 1 on
// simplices), 1..KNP_CELL_MAXI ions; two cells a thread where every row
// can be read in pairs (nc even, the pointers aligned to two elements)
template <typename T>
static int emi_cell_launch(const KnpCellTables* t, const T* D, const T* c, T* kappa,
                           T* kbar, T* flux, T* bcell, double Fpsi, double negF,
                           void* stream) {
  if (t->d != t->nd - 1 || t->nc < 0) return (int)cudaErrorInvalidValue;
  if (t->nc == 0) return 0;
  const size_t v = 2 * sizeof(T);
  const bool two = t->nc % 2 == 0 && knp_aligned(t->G, v) &&
                   knp_aligned(t->vol, v) && knp_aligned(D, v) && knp_aligned(c, v) &&
                   knp_aligned(kappa, v) && knp_aligned(kbar, v) && knp_aligned(flux, v) &&
                   knp_aligned(bcell, v);
  cudaStream_t st = (cudaStream_t)stream;
#define EMI_CELL_NI(ND, NI)                                                                 \
  case NI:                                                                                  \
    return emi_cell_run<T, ND, NI>(*t, D, c, kappa, kbar, flux, bcell, Fpsi, negF, two, st);
#define EMI_CELL_ND(ND)                                                                     \
  case ND:                                                                                  \
    switch (t->n_ions) {                                                                    \
      EMI_CELL_NI(ND, 1) EMI_CELL_NI(ND, 2) EMI_CELL_NI(ND, 3)                              \
      EMI_CELL_NI(ND, 4) EMI_CELL_NI(ND, 5) EMI_CELL_NI(ND, 6)                              \
    }                                                                                       \
    return (int)cudaErrorInvalidValue;
  switch (t->nd) {
    EMI_CELL_ND(2)
    EMI_CELL_ND(3)
    EMI_CELL_ND(4)
  }
#undef EMI_CELL_ND
#undef EMI_CELL_NI
  return (int)cudaErrorInvalidValue;
}

// One block per tile of EMI_TILE consecutive facets, one warp per row i of
// the blocks (nd warps): lane l of warp i holds row i of the four blocks of
// facet f0 + l.  The block stages the tile's tables in shared memory (rows
// of EMI_TILE facets; dynamic, sized by nq and nd):
//   f_Rp, f_Rm (q, a); w kp, w km, w pen (q); kappa at cp, at cm (a), the
//   flux sums fp, fm; gnp, gnm (a); the row sums sPp, sPm, sMp, sMm (a);
//   the flux average.
template <typename T>
__global__ void __launch_bounds__(KNP_MAXND * EMI_TILE) emi_facet_kernel(
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
  extern __shared__ __align__(16) unsigned char emi_smem[];
  const int nqd = nq * nd;
  T* sRp = reinterpret_cast<T*>(emi_smem);
  T* sRm = sRp + nqd * EMI_TILE;
  T* sw = sRm + nqd * EMI_TILE;
  T* sk = sw + 3 * nq * EMI_TILE;
  T* sgn = sk + (2 * nd + 2) * EMI_TILE;
  T* sS = sgn + 2 * nd * EMI_TILE;
  T* sfavg = sS + 4 * nd * EMI_TILE;
  const int lane = threadIdx.x % EMI_TILE, i = threadIdx.x / EMI_TILE;
#define ROW(base, r) (base)[(r) * EMI_TILE + lane]
  const int f = blockIdx.x * EMI_TILE + lane;
  const bool live = f < nf1;
  const size_t n1 = (size_t)nf1, n = (size_t)nc;
  const int cp = live ? f_cp[f] : 0, cm = live ? f_cm[f] : 0;

  // stage 1: warp i loads column i of the trace tables at every quadrature
  // point and row i of n . grad, issued back to back, and gathers kappa at
  // both cells in row i; warps 0 and 1 sum the flux at cp and cm
#pragma unroll
  for (int q = 0; q < KNP_MAXNQ; ++q)
    if (q < nq) {
      const size_t o = (size_t)(q * nd + i) * n1 + f;
      ROW(sRp, q * nd + i) = live ? f_Rp[o] : T(0);
      ROW(sRm, q * nd + i) = live ? f_Rm[o] : T(0);
    }
  ROW(sgn, i) = live ? gnp[(size_t)i * n1 + f] : T(0);
  ROW(sgn, nd + i) = live ? gnm[(size_t)i * n1 + f] : T(0);
  ROW(sk, i) = live ? kappa[(size_t)i * n + cp] : T(0);
  ROW(sk, nd + i) = live ? kappa[(size_t)i * n + cm] : T(0);
  if (i < 2) {
    const int c = i == 0 ? cp : cm;
    T v = T(0);
    if (live) {
#pragma unroll
      for (int e = 0; e < KNP_MAXD; ++e)
        if (e < d) v += flux[(size_t)e * n + c] * f_n[(size_t)e * n1 + f];
    }
    ROW(sk, 2 * nd + i) = v;
  }
  __syncthreads();
  // stage 2: w kp, w km and w pen at each quadrature point and the flux
  // average, once a facet
  for (int q = i; q < nq; q += nd) {
    T kp = T(0), km = T(0);
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a)
      if (a < nd) {
        kp += ROW(sRp, q * nd + a) * ROW(sk, a);
        km += ROW(sRm, q * nd + a) * ROW(sk, nd + a);
      }
    const T w = w_f[q];
    ROW(sw, q) = w * kp;
    ROW(sw, nq + q) = w * km;
    ROW(sw, 2 * nq + q) = w * (T(0.5) * (kp + km));
  }
  if (i == nd - 1)
    ROW(sfavg, 0) = live && f_sip[f] != 0
                        ? (T(0.5) * F) * (ROW(sk, 2 * nd) + ROW(sk, 2 * nd + 1)) : T(0);
  __syncthreads();
  // stage 3: row i's sums S(R_v, k_u)[i] = sum_q (w_q k_u[q]) R_v[q, i] and
  // sum_q w_q R[q, i], shared with the other rows
  T sPp = 0, sPm = 0, sMp = 0, sMm = 0, wRp = 0, wRm = 0;
  for (int q = 0; q < nq; ++q) {
    const T w = w_f[q];
    const T wkp = ROW(sw, q), wkm = ROW(sw, nq + q);
    const T rp_i = ROW(sRp, q * nd + i), rm_i = ROW(sRm, q * nd + i);
    sPp += wkp * rp_i;
    sPm += wkm * rp_i;
    sMp += wkp * rm_i;
    sMm += wkm * rm_i;
    wRp += w * rp_i;
    wRm += w * rm_i;
  }
  ROW(sS, i) = sPp;
  ROW(sS, nd + i) = sPm;
  ROW(sS, 2 * nd + i) = sMp;
  ROW(sS, 3 * nd + i) = sMm;
  __syncthreads();
  if (!live) return;

  // stage 4: row i of the four blocks, one column j at a time: the penalty
  // sums sum_q (w_q pen_q) (R_v[q, i] R_u[q, j]), then the entries
  const bool sip = f_sip[f] != 0, mem = f_mem[f] != 0;
  const T area = f_area[f];
  const T hm = T(-0.5) * area, hp = T(0.5) * area;
  const T scale = (tau / f_havg[f]) * area;
  const T cs = C_phi * area;
  const T gnp_i = ROW(sgn, i), gnm_i = ROW(sgn, nd + i);
#pragma unroll 1   // one column's four penalty sums live at a time
  for (int j = 0; j < nd; ++j) {
    T Ppp = 0, Ppm = 0, Pmp = 0, Pmm = 0;
    for (int q = 0; q < nq; ++q) {
      const T wpen = ROW(sw, 2 * nq + q);
      const T rp_i = ROW(sRp, q * nd + i), rm_i = ROW(sRm, q * nd + i);
      const T rp_j = ROW(sRp, q * nd + j), rm_j = ROW(sRm, q * nd + j);
      Ppp += wpen * (rp_i * rp_j);
      Ppm += wpen * (rp_i * rm_j);
      Pmp += wpen * (rm_i * rp_j);
      Pmm += wpen * (rm_i * rm_j);
    }
    const T sPp_j = ROW(sS, j), sPm_j = ROW(sS, nd + j);
    const T sMp_j = ROW(sS, 2 * nd + j), sMm_j = ROW(sS, 3 * nd + j);
    const T gnp_j = ROW(sgn, j), gnm_j = ROW(sgn, nd + j);
    // -<avg(k grad u).n, [v]> and its transposed twin with the sides swapped
    const T t1_pp = (hm * sPp) * gnp_j, t2_pp = (hm * sPp_j) * gnp_i;
    const T t1_pm = (hm * sPm) * gnm_j, t2_pm = (hp * sMp_j) * gnp_i;
    const T t1_mp = (hp * sMp) * gnp_j, t2_mp = (hm * sPm_j) * gnm_i;
    const T t1_mm = (hp * sMm) * gnm_j, t2_mm = (hp * sMm_j) * gnm_i;
    T vpp = sip ? (t1_pp + t2_pp) + scale * Ppp : T(0);
    T vpm = sip ? (t1_pm + t2_pm) + (-scale) * Ppm : T(0);
    T vmp = sip ? (t1_mp + t2_mp) + (-scale) * Pmp : T(0);
    T vmm = sip ? (t1_mm + t2_mm) + scale * Pmm : T(0);
    const size_t o = (size_t)(i * nd + j) * n1 + f;
    if (mem) {
      // C_phi <[u],[v]>: the static jump-jump tables, read on membrane facets only
      vpp = vpp + cs * E_pp[o];
      vpm = vpm + (-cs) * E_pm[o];
      vmp = vmp + (-cs) * E_mp[o];
      vmm = vmm + cs * E_mm[o];
    }
    Mpp[o] = vpp;
    Mpm[o] = vpm;
    Mmp[o] = vmp;
    Mmm[o] = vmm;
  }
  // facet rhs: the flux average on SIP facets, the Robin source on membranes;
  // sum_q (w_q favg) R[q, i] with favg constant over the quadrature points
  const T favg = ROW(sfavg, 0);
  T bp = T(0), bm = T(0);
  for (int q = 0; q < nq; ++q) {
    const T wf = w_f[q] * favg;
    bp += wf * ROW(sRp, q * nd + i);
    bm += (-wf) * ROW(sRm, q * nd + i);
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
#undef ROW
}

// Row i of one cell's emit: the d + 1 = ND cell-facet slots' words (the
// facet index and cf_is_plus) given, all of the row's gathers are issued
// before its first store -- the ND diagonal-side and ND off-diagonal
// entries of each slot and the slot's b_p / b_m entry -- then the row's
// blocks, P_diag entries and rhs entry are written in the plain version's
// order of additions (diag = vk GG + slot 0 + ... + slot d, P_diag = diag +
// reg, rhs = b_cell + slot 0 + ... + slot d).  The pointers are
// restrict-qualified, so the row's loads may pass its stores.  PAIR: the
// pair emit's A_cell = vk GG and reg instead of the blocks and P_diag.
// The emit, a thread a block entry (i, j) and cell, cells fastest in a warp
// (every store coalesced) and the entries slowest, so the threads in flight
// gather from one or two rows (i, j) of the facet blocks at a time, which
// stay in L2 for the other cells of their 32-byte sectors.  A thread loads
// its cell's d + 1 = ND packed slot words (the table K11's membrane emit
// reads: the facet index in bits 0-29, cf_is_plus in bit 31) first, then
// issues all of its gathers -- the diagonal-side and off-diagonal entry of
// each slot, and in the j = 0 threads the rhs row's b_p / b_m entries --
// before its first store, and writes in the plain version's order of
// additions (diag = vk GG + slot 0 + ... + slot d, P_diag = diag + reg, rhs
// = b_cell + slot 0 + ... + slot d).  PAIR: the pair emit's A_cell = vk GG
// and reg instead of the blocks and P_diag.
template <typename T, int ND, bool PAIR>
__global__ void __launch_bounds__(KNP_THREADS)
    emi_emit_cell_kernel(const T* __restrict__ kbar, const T* __restrict__ vol,
                         const T* __restrict__ GG, const T* __restrict__ M0,
                         const T* __restrict__ Mpp, const T* __restrict__ Mpm,
                         const T* __restrict__ Mmp, const T* __restrict__ Mmm,
                         const T* __restrict__ bcell, const T* __restrict__ b_p,
                         const T* __restrict__ b_m, const int* __restrict__ slots,
                         T* __restrict__ blocks, T* __restrict__ rhs, T* __restrict__ pdiag,
                         int nc, int nf1, T inv_Lp2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)ND * ND * nc) return;
  const int cell = (int)(idx % nc);
  const int ij = (int)(idx / nc);
  const int i = ij / ND, j = ij % ND;
  const size_t n = (size_t)nc, n1 = (size_t)nf1;
  int f[ND];
  bool sel[ND];
#pragma unroll
  for (int l = 0; l < ND; ++l) {
    const unsigned w = (unsigned)slots[(size_t)l * n + cell];
    f[l] = (int)(w & KNP_IDX_MASK);
    sel[l] = (w >> 31) != 0u;
  }
  const T vk = vol[cell] * kbar[cell];
  const T gg = GG[(size_t)ij * n + cell];
  T dg[ND], og[ND], bs[ND], b0 = T(0);
  if (!PAIR) {
#pragma unroll
    for (int l = 0; l < ND; ++l) {
      const size_t o = (size_t)ij * n1 + f[l];
      dg[l] = (sel[l] ? Mpp : Mmm)[o];
      og[l] = (sel[l] ? Mpm : Mmp)[o];
    }
  }
  if (j == 0) {
    b0 = bcell[(size_t)i * n + cell];
#pragma unroll
    for (int l = 0; l < ND; ++l) bs[l] = (sel[l] ? b_p : b_m)[(size_t)i * n1 + f[l]];
  }
  T diag = vk * gg;
  const T reg = (vk * inv_Lp2) * M0[ij];
  if (PAIR) {
    blocks[(size_t)ij * n + cell] = diag;
    pdiag[(size_t)ij * n + cell] = reg;
  } else {
#pragma unroll
    for (int l = 0; l < ND; ++l) {
      diag = diag + dg[l];
      blocks[((size_t)(l + 1) * ND * ND + ij) * n + cell] = og[l];
    }
    blocks[(size_t)ij * n + cell] = diag;
    pdiag[(size_t)ij * n + cell] = diag + reg;
  }
  if (j == 0) {
    T r = b0;
#pragma unroll
    for (int l = 0; l < ND; ++l) r = r + bs[l];
    rhs[(size_t)i * n + cell] = r;
  }
}

// nd = d + 1 basis functions and cell facets (degree 1 on simplices)
template <typename T>
static int emi_emit_launch(const T* kbar, const T* vol, const T* GG, const T* M0,
                           const T* Mpp, const T* Mpm, const T* Mmp, const T* Mmm,
                           const T* bcell, const T* b_p, const T* b_m, const int* slots,
                           T* blocks, T* rhs, T* pdiag, int nd, int nfac, int nc, int nf1,
                           int pair, T inv_Lp2, void* stream) {
  if (nfac != nd || nc < 0) return (int)cudaErrorInvalidValue;
  if (nc == 0) return 0;
  const unsigned grid = knp_blocks((long long)nd * nd * nc);
  cudaStream_t st = (cudaStream_t)stream;
#define EMI_EMIT_ND(ND)                                                                     \
  if (nd == ND) {                                                                           \
    if (pair)                                                                               \
      emi_emit_cell_kernel<T, ND, true><<<grid, KNP_THREADS, 0, st>>>(                      \
          kbar, vol, GG, M0, Mpp, Mpm, Mmp, Mmm, bcell, b_p, b_m, slots, blocks, rhs, pdiag, \
          nc, nf1, inv_Lp2);                                                                \
    else                                                                                    \
      emi_emit_cell_kernel<T, ND, false><<<grid, KNP_THREADS, 0, st>>>(                     \
          kbar, vol, GG, M0, Mpp, Mpm, Mmp, Mmm, bcell, b_p, b_m, slots, blocks, rhs, pdiag, \
          nc, nf1, inv_Lp2);                                                                \
    return (int)cudaGetLastError();                                                         \
  }
  EMI_EMIT_ND(2)
  EMI_EMIT_ND(3)
  EMI_EMIT_ND(4)
#undef EMI_EMIT_ND
  return (int)cudaErrorInvalidValue;
}

#define KNP_EMI_ENTRY(SFX, T)                                                            \
  extern "C" int knp_emi_cell##SFX(const void* tables, const T* D, const T* c, T* kappa,   \
                                   T* kbar, T* flux, T* bcell, double Fpsi, double negF, \
                                   void* stream) {                                       \
    return emi_cell_launch<T>(static_cast<const KnpCellTables*>(tables), D, c, kappa,    \
                              kbar, flux, bcell, Fpsi, negF, stream);                    \
  }                                                                                      \
  extern "C" int knp_emi_facet##SFX(                                                     \
      const T* kappa, const T* flux, const T* gr, const int* inv_mem, const int* f_cp,   \
      const int* f_cm, const T* f_n, const T* f_area, const T* f_havg, const T* f_Rp,    \
      const T* f_Rm, const T* gnp, const T* gnm, const T* E_pp, const T* E_pm,           \
      const T* E_mp, const T* E_mm, const T* w_f, const unsigned char* f_sip,            \
      const unsigned char* f_mem, T* Mpp, T* Mpm, T* Mmp, T* Mmm, T* b_p, T* b_m,        \
      int nq, int nd, int d, int nc, int nf1, double tau, double C_phi, double F,        \
      void* stream) {                                                                    \
    if (nd < 2 || nd > KNP_MAXND || nq > KNP_MAXNQ) return (int)cudaErrorInvalidValue;   \
    const size_t smem = (size_t)(2 * nq * nd + 3 * nq + 8 * nd + 3) * EMI_TILE * sizeof(T); \
    emi_facet_kernel<T><<<(nf1 + EMI_TILE - 1) / EMI_TILE, nd * EMI_TILE, smem,          \
                          (cudaStream_t)stream>>>(                                       \
        kappa, flux, gr, inv_mem, f_cp, f_cm, f_n, f_area, f_havg, f_Rp, f_Rm, gnp, gnm, \
        E_pp, E_pm, E_mp, E_mm, w_f, f_sip, f_mem, Mpp, Mpm, Mmp, Mmm, b_p, b_m, nq, nd, \
        d, nc, nf1, (T)tau, (T)C_phi, (T)F);                                             \
    return (int)cudaGetLastError();                                                      \
  }                                                                                      \
  extern "C" int knp_emi_emit_cell##SFX(                                                 \
      const T* kbar, const T* vol, const T* GG, const T* M0, const T* Mpp, const T* Mpm, \
      const T* Mmp, const T* Mmm, const T* bcell, const T* b_p, const T* b_m,            \
      const int* slots, T* blocks, T* rhs, T* pdiag, int nd, int nfac, int nc, int nf1,  \
      int pair, double inv_Lp2, void* stream) {                                          \
    return emi_emit_launch<T>(kbar, vol, GG, M0, Mpp, Mpm, Mmp, Mmm, bcell, b_p, b_m,    \
                              slots, blocks, rhs, pdiag, nd, nfac, nc, nf1, pair,        \
                              (T)inv_Lp2, stream);                                       \
  }

KNP_EMI_ENTRY(_f32, float)
KNP_EMI_ENTRY(_f64, double)
