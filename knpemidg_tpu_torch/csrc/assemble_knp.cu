// Kernel K11: assembly of the KNP systems of all solved ions, degree 1.
//
// Replaces knpemidg_tpu/ops/assembly.py:678 assemble_knp_all (and the
// alpha_sum einsum of its caller), which XLA lowers to einsums, stacked
// gathers, selects and one scatter on the TPU.  Launches per assembly:
//
//   alpha_sum         per node: sum_k z_k^2 D_k c_k over all ions;
//   ion_cell          per cell: grad(phi), the drift G . grad(phi) and the
//                     mass part of the rhs (vol/dt) M0 c_n;
//   ion_facet         per facet: the upwind switch u_p, u_m shared by the
//                     ions (max(D un, 0) = D max(un, 0) since D > 0) and the
//                     m ions' four upwind blocks (m, nd, nd, nf+1): a
//                     facet's scalars, then the sweep over its entries;
//   ion_membrane_rhs  on the membrane-facet axis: the ion fractions alpha at
//                     both cells, the phi jump, the capacitive and channel
//                     sources and their quadrature sums -> b_p, b_m
//                     (m, nd, n_mem);
//   ion_emit_cell     per cell and ion: the drift block, the d+1 gathered
//                     upwind blocks, the static operator added last ->
//                     (m, K, nd, nd, nc), and the rhs with the membrane parts
//                     read through the inverse membrane map (no zero-filled
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

template <typename T>
__global__ void alpha_sum_kernel(const T* __restrict__ z, const T* __restrict__ D,
                                 const T* __restrict__ c, T* __restrict__ out, int n_ions,
                                 int nd, int nc) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nd * nc) return;
  const int cell = (int)(idx % nc);
  const size_t n = (size_t)nc;
  T acc = T(0);
  for (int k = 0; k < n_ions; ++k)
    acc += ((z[k] * z[k]) * D[(size_t)k * n + cell]) * c[(size_t)k * nd * n + idx];
  out[idx] = acc;
}

template <typename T>
__global__ void ion_cell_kernel(const T* __restrict__ phi, const T* __restrict__ c_n,
                                const T* __restrict__ G, const T* __restrict__ vol,
                                const T* __restrict__ M0, T* __restrict__ gphi,
                                T* __restrict__ drift, T* __restrict__ bcell, int m, int nd,
                                int d, int nc, T dt) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= nc) return;
  const size_t n = (size_t)nc;
  T g[KNP_MAXND][KNP_MAXD], gp[KNP_MAXD];
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a)
#pragma unroll
    for (int e = 0; e < KNP_MAXD; ++e)
      g[a][e] = (a < nd && e < d) ? G[((size_t)a * d + e) * n + cell] : T(0);
#pragma unroll
  for (int e = 0; e < KNP_MAXD; ++e) gp[e] = T(0);
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a)
    if (a < nd) {
      const T pa = phi[(size_t)a * n + cell];
#pragma unroll
      for (int e = 0; e < KNP_MAXD; ++e) gp[e] += g[a][e] * pa;
    }
#pragma unroll
  for (int e = 0; e < KNP_MAXD; ++e)
    if (e < d) gphi[(size_t)e * n + cell] = gp[e];
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a)
    if (a < nd) {
      T acc = T(0);
#pragma unroll
      for (int e = 0; e < KNP_MAXD; ++e) acc += g[a][e] * gp[e];
      drift[(size_t)a * n + cell] = acc;
    }
  const T vdt = vol[cell] / dt;
  for (int k = 0; k < m; ++k) {
    T ck[KNP_MAXND];
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a)
      ck[a] = a < nd ? c_n[((size_t)k * nd + a) * n + cell] : T(0);
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a)
      if (a < nd) {
        T acc = T(0);
#pragma unroll
        for (int b = 0; b < KNP_MAXND; ++b)
          if (b < nd) acc += M0[a * nd + b] * ck[b];
        bcell[((size_t)k * nd + a) * n + cell] = vdt * acc;
      }
  }
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

template <typename T>
__global__ void ion_membrane_rhs_kernel(
    const T* __restrict__ z, const T* __restrict__ D, const T* __restrict__ c_k,
    const T* __restrict__ alpha_sum, const T* __restrict__ phi, const T* __restrict__ phi_M,
    const T* __restrict__ I_ch, const T* __restrict__ I_tot, const T* __restrict__ Rp,
    const T* __restrict__ Rm, const int* __restrict__ mcp, const int* __restrict__ mcm,
    const int* __restrict__ fidx, const T* __restrict__ f_area, const T* __restrict__ w_f,
    T* __restrict__ b_p, T* __restrict__ b_m, int m, int nq, int nd, int nc, int nm,
    int ich_stride, int splitting, T F, T Cfac0) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m * nm) return;
  const int mm = idx % nm, k = idx / nm;
  const size_t n = (size_t)nc, nmm = (size_t)nm;
  const int cp = mcp[mm], cm = mcm[mm];
  const T zk = z[k];
  const T Dzz_p = D[(size_t)k * n + cp] * (zk * zk);
  const T Dzz_m = D[(size_t)k * n + cm] * (zk * zk);
  T aup[KNP_MAXND], aum[KNP_MAXND], php[KNP_MAXND], phm[KNP_MAXND];
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a) {
    const bool on = a < nd;
    const size_t op = (size_t)a * n + cp, om = (size_t)a * n + cm;
    aup[a] = on ? (Dzz_p * c_k[(size_t)k * nd * n + op]) / alpha_sum[op] : T(0);
    aum[a] = on ? (Dzz_m * c_k[(size_t)k * nd * n + om]) / alpha_sum[om] : T(0);
    php[a] = on ? phi[op] : T(0);
    phm[a] = on ? phi[om] : T(0);
  }
  const T Cfac = Cfac0 / zk;              // C_M / (F dt) / z
  const T invFz = T(1) / (F * zk);
  const T phiM = phi_M[mm], Itot = I_tot[mm];
  const T Ikz = I_ch[(size_t)k * ich_stride + mm] * invFz;
  T accp[KNP_MAXND], accm[KNP_MAXND];
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a) accp[a] = accm[a] = T(0);
  for (int q = 0; q < nq; ++q) {
    T rp[KNP_MAXND], rm[KNP_MAXND];
    T tp = T(0), tm = T(0), ap = T(0), am = T(0);
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a) {
      rp[a] = a < nd ? Rp[((size_t)q * nd + a) * nmm + mm] : T(0);
      rm[a] = a < nd ? Rm[((size_t)q * nd + a) * nmm + mm] : T(0);
      tp += rp[a] * php[a];
      tm += rm[a] * phm[a];
      ap += rp[a] * aup[a];
      am += rm[a] * aum[a];
    }
    const T jphi = tp - tm;
    const T Cp = ap * Cfac, Cm = am * Cfac;
    const T sxp = splitting ? (ap * Itot) * invFz : T(0);
    const T sxm = splitting ? (am * Itot) * invFz : T(0);
    const T se = (Cp * phiM - Ikz) + sxp;
    const T si = (Cm * phiM - Ikz) + sxm;
    const T jC = Cp - Cm, aC = T(0.5) * (Cp + Cm);
    const T half = ((-jphi) * jC) * T(0.5);
    const T vp = -se + (half - jphi * aC);
    const T vm = si + (half + jphi * aC);
    const T w = w_f[q];
#pragma unroll
    for (int a = 0; a < KNP_MAXND; ++a) {
      accp[a] += (w * vp) * rp[a];
      accm[a] += (w * vm) * rm[a];
    }
  }
  const T area = f_area[fidx[mm]];
#pragma unroll
  for (int a = 0; a < KNP_MAXND; ++a)
    if (a < nd) {
      b_p[((size_t)k * nd + a) * nmm + mm] = area * accp[a];
      b_m[((size_t)k * nd + a) * nmm + mm] = area * accm[a];
    }
}

template <typename T>
__global__ void ion_emit_cell_kernel(
    const T* __restrict__ z, const T* __restrict__ D, const T* __restrict__ vol,
    const T* __restrict__ drift, const T* __restrict__ phibar, const T* __restrict__ Mpp,
    const T* __restrict__ Mpm, const T* __restrict__ Mmp, const T* __restrict__ Mmm,
    const T* __restrict__ bcell, const T* __restrict__ b_p, const T* __restrict__ b_m,
    const int* __restrict__ inv_mem, const int* __restrict__ cf_idx,
    const unsigned char* __restrict__ cf_isp, const T* __restrict__ statics,
    T* __restrict__ blocks, T* __restrict__ rhs, int m, int nd, int nfac, int nc, int nf1,
    int nm, int pair, T psi) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * nd * nd * nc) return;
  const int cell = (int)(idx % nc);
  const long long kij = idx / nc;               // (k * nd + i) * nd + j
  const int ij = (int)(kij % (nd * nd));
  const int j = ij % nd, i = ij / nd;
  const int k = (int)(kij / (nd * nd));
  const size_t n = (size_t)nc, n1 = (size_t)nf1;
  T diag = (((z[k] * psi) * (vol[cell] * D[(size_t)k * n + cell]))
            * drift[(size_t)i * n + cell]) * phibar[j];
  if (pair) {
    blocks[(size_t)kij * n + cell] = diag;
  } else {
    const size_t mo = (size_t)kij * n1;
    const size_t bo = (size_t)k * (nfac + 1) * nd * nd;    // slot 0 of ion k
    for (int l = 0; l < nfac; ++l) {
      const int f = cf_idx[(size_t)l * n + cell];
      const bool sel = cf_isp[(size_t)l * n + cell] != 0;
      diag = diag + (sel ? Mpp[mo + f] : Mmm[mo + f]);
      T off = sel ? Mpm[mo + f] : Mmp[mo + f];
      const size_t o = (bo + (size_t)(l + 1) * nd * nd + ij) * n + cell;
      if (statics) off = off + statics[o];
      blocks[o] = off;
    }
    const size_t o = (bo + ij) * n + cell;
    if (statics) diag = diag + statics[o];
    blocks[o] = diag;
  }
  if (j != 0) return;
  const size_t ki = (size_t)k * nd + i;
  T r = bcell[ki * n + cell];
  for (int l = 0; l < nfac; ++l) {
    const int mi = inv_mem[cf_idx[(size_t)l * n + cell]];
    const bool sel = cf_isp[(size_t)l * n + cell] != 0;
    const T got = mi >= 0 ? (sel ? b_p[ki * nm + mi] : b_m[ki * nm + mi]) : T(0);
    r = r + got;
  }
  rhs[ki * n + cell] = r;
}

#define KNP_ION_ENTRY(SFX, T)                                                              \
  extern "C" int knp_alpha_sum##SFX(const T* z, const T* D, const T* c, T* out,            \
                                    int n_ions, int nd, int nc, void* stream) {            \
    alpha_sum_kernel<T><<<knp_blocks((long long)nd * nc), KNP_THREADS, 0,                  \
                          (cudaStream_t)stream>>>(z, D, c, out, n_ions, nd, nc);           \
    return (int)cudaGetLastError();                                                        \
  }                                                                                        \
  extern "C" int knp_ion_cell##SFX(const T* phi, const T* c_n, const T* G, const T* vol,   \
                                   const T* M0, T* gphi, T* drift, T* bcell, int m,        \
                                   int nd, int d, int nc, double dt, void* stream) {       \
    ion_cell_kernel<T><<<knp_blocks(nc), KNP_THREADS, 0, (cudaStream_t)stream>>>(          \
        phi, c_n, G, vol, M0, gphi, drift, bcell, m, nd, d, nc, (T)dt);                    \
    return (int)cudaGetLastError();                                                        \
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
  extern "C" int knp_ion_membrane_rhs##SFX(                                                \
      const T* z, const T* D, const T* c_k, const T* alpha_sum, const T* phi,              \
      const T* phi_M, const T* I_ch, const T* I_tot, const T* Rp, const T* Rm,             \
      const int* mcp, const int* mcm, const int* fidx, const T* f_area, const T* w_f,      \
      T* b_p, T* b_m, int m, int nq, int nd, int nc, int nm, int ich_stride,               \
      int splitting, double F, double Cfac0, void* stream) {                               \
    ion_membrane_rhs_kernel<T><<<knp_blocks((long long)m * nm), KNP_THREADS, 0,            \
                                 (cudaStream_t)stream>>>(                                  \
        z, D, c_k, alpha_sum, phi, phi_M, I_ch, I_tot, Rp, Rm, mcp, mcm, fidx, f_area,     \
        w_f, b_p, b_m, m, nq, nd, nc, nm, ich_stride, splitting, (T)F, (T)Cfac0);          \
    return (int)cudaGetLastError();                                                        \
  }                                                                                        \
  extern "C" int knp_ion_emit_cell##SFX(                                                   \
      const T* z, const T* D, const T* vol, const T* drift, const T* phibar,               \
      const T* Mpp, const T* Mpm, const T* Mmp, const T* Mmm, const T* bcell,              \
      const T* b_p, const T* b_m, const int* inv_mem, const int* cf_idx,                   \
      const unsigned char* cf_isp, const T* statics, T* blocks, T* rhs, int m, int nd,     \
      int nfac, int nc, int nf1, int nm, int pair, double psi, void* stream) {             \
    ion_emit_cell_kernel<T><<<knp_blocks((long long)m * nd * nd * nc), KNP_THREADS, 0,     \
                              (cudaStream_t)stream>>>(                                     \
        z, D, vol, drift, phibar, Mpp, Mpm, Mmp, Mmm, bcell, b_p, b_m, inv_mem, cf_idx,    \
        cf_isp, statics, blocks, rhs, m, nd, nfac, nc, nf1, nm, pair, (T)psi);             \
    return (int)cudaGetLastError();                                                        \
  }

KNP_ION_ENTRY(_f32, float)
KNP_ION_ENTRY(_f64, double)
