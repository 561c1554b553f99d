// Kernel C: the membrane ODE step of every tag in one launch, fixed-substep
// RK4 or Strang-split Rush-Larsen, with the solver's PDE -> ODE pushes read
// in place and its ODE -> PDE pulls written in place.
//
// Replaces knpemidg_tpu/membrane/engine.py:93 ode_step (a vmapped fori_loop
// of substeps over all membrane points of one tag, then the channel-current
// write-back at t + dt, engine.py:158-164) as knpemidg_tpu/solver.py:955-992
// Solver._ode_step drives it: per tag, the pushes (V from phi_M, E_<ion>,
// update_ode's values), the step, and the pulls (V into phi_M, I_ch_<ion>
// into I_ch).  Scheme "rk4" (rk4_point, engine.py:116) runs for every model
// with a device right-hand side; scheme "rush_larsen" (rl_point, :129-152)
// for the Hodgkin-Huxley model: per substep half an exponential update of
// the gates m, h, n at frozen V, a midpoint RK2 step of the rest with the
// gate rows of the right-hand side zeroed, and the second half gate update.
// A model without gating states (GlialKir) runs RK4 under "rush_larsen" too
// (engine.py:154).
//
// Bound: the chain of dependent arithmetic, not bandwidth.  Each point reads
// its states and parameters once (21 values for the HH model) and then runs
// n_sub * 4 model right-hand sides (25 * 4 = 100 evaluations with several
// exp() and divisions each) before writing back.  One thread a point keeps
// its state, parameters and RK4 stages in registers for the whole step, so
// device memory is touched once on the way in and once on the way out
// (points last: coalesced); but a thread's 100 evaluations are one chain
// of dependent arithmetic, which runs as long at 1 warp an SM partition as
// at 2: latency, not issue, sets it, and more SMs do not shorten it.  So the
// HH model runs each point on a group of HH_LANES = 8 lanes: lanes 0-5
// compute one of the six gating rates each (exp(-u), u = (V + c) / d, then
// vtrap's quotient or bh's, one instruction stream on per-lane constants),
// the group exchanges them with __shfl_sync, and every lane of the group
// runs the rest of the right-hand side on the same values; the group's
// first lane writes.  GlialKir (one exp pair a right-hand side) keeps a lane
// a point.
//
// All tags share one launch: a table passed by value (MembraneGrid, under
// 4 KB) gives each tag its first block, so a block belongs to one tag and
// switches once on its model and scheme.  Per parameter slot a tag may name
// a source (the Nernst row of the trace tensor, an update_ode value, ...)
// read in place of its own parameter row, and a source of V (phi_M at the
// tag's offset); the new V and the channel currents go straight into phi_M
// and I_ch at the tag's offset.
//
// Bits: every output equals the one-thread-a-point kernels this launch
// replaced.  Each rate keeps that kernel's expression, and where nvcc
// contracted an expression in the thread but would contract it otherwise
// once its inputs come from another lane, that contraction is written out
// (hh_rhs).
#include "common.cuh"

// Parameter slots: the PARAM_DEFAULTS order of the Python models
// (knpemidg_tpu_torch/models/hh.py, glial.py).  The wrapper checks that the
// model's parameter names match CUDA_PARAMS before launching.
enum {
  P_g_Na_bar = 0, P_g_K_bar, P_g_leak_Na, P_g_leak_K, P_E_Na, P_E_K, P_E_Cl,
  P_Cm, P_stim_amplitude, P_I_ch_Na, P_I_ch_K, P_I_ch_Cl, P_K_e, P_Na_i,
  P_m_K, P_m_Na, P_I_max, P_K_e_init, P_K_i_init
};

enum { MODEL_HH_MV = 1, MODEL_GLIAL_KIR = 2 };

template <typename T>
__device__ __forceinline__ T vtrap(T x, T y) {
  // x / (1 - exp(-x/y)) with the removable singularity at x = 0
  // (models/base.py vtrap)
  const T u = x / y;
  if (fabs(u) < T(1e-4)) return y * (T(1) + u / T(2) + u * u / T(12));
  return x / (T(1) - exp(-u));
}

template <typename T>
__device__ __forceinline__ T floor_mod(T t, T period) {
  // jnp.mod / torch.remainder semantics for a positive period
  return t - period * floor(t / period);
}

template <typename T>
__device__ __forceinline__ T pump_saturating(const T* p) {
  const T a = T(1) + p[P_m_K] / p[P_K_e];
  const T b = T(1) + p[P_m_Na] / p[P_Na_i];
  return p[P_I_max] / ((a * a) * (b * b * b));
}

// ---- Hodgkin-Huxley (emix mV/ms units) ------------------------------------
template <typename T>
__device__ __forceinline__ void hh_currents(T t, const T* y, const T* p, bool stim,
                                            T* i_Na, T* i_K) {
  const T m = y[0], h = y[1], n = y[2], V = y[3];
  const T i_stim =
      stim ? p[P_stim_amplitude] * exp(-floor_mod(t, T(20.0)) / T(2.0)) : T(0);
  const T i_pump = pump_saturating(p);
  *i_Na = (p[P_g_leak_Na] + p[P_g_Na_bar] * h * (m * m * m) + i_stim) * (V - p[P_E_Na]) +
          T(3) * i_pump;
  const T n2 = n * n;
  *i_K = (p[P_g_leak_K] + p[P_g_K_bar] * (n2 * n2)) * (V - p[P_E_K]) - T(2) * i_pump;
}

// Lanes a point of the HH model: its six rates on lanes 0-5 of a group of 8
// (a group never spans two warps).
constexpr int HH_LANES = 8;

// Rate r of the classic HH rates in mV and 1/ms (models/base.py
// hh_gating_rates_mV: am, bm, ah, bh, an, bn = 0.1 vtrap(V + 40, 10),
// 4 exp(-(V + 65) / 18), 0.07 exp(-(V + 65) / 20), 1 / (1 + exp(-(V + 35)
// / 10)), 0.01 vtrap(V + 55, 10), 0.125 exp(-(V + 65) / 80)) without its
// constant factor, as one lane of a point's group computes it: every rate
// is exp(-u), u = (V + c) / d, then vtrap's x / (1 - exp(-u)) (or its
// series) for am and an, 1 / (1 + exp(-u)) for bh, exp(-u) itself for bm,
// ah, bn.  Each value is bitwise the in-thread expression's (a negated
// quotient is the quotient of the negation); the lanes run one
// instruction stream on their own constants.
template <typename T>
__device__ __forceinline__ T hh_rate_leaf(T V, int r) {
  const T c = r == 0 ? T(40) : r == 3 ? T(35) : r == 4 ? T(55) : T(65);
  const T d = r == 1 ? T(18) : r == 2 ? T(20) : r == 5 ? T(80) : T(10);
  const T x = V + c;
  const T u = x / d;
  const T e = exp(-u);
  const bool bh = r == 3;
  const T q = (bh ? T(1) : x) / (bh ? T(1) + e : T(1) - e);
  if (r == 0 || r == 4) return fabs(u) < T(1e-4) ? d * (T(1) + u / T(2) + u * u / T(12)) : q;
  return bh ? q : e;
}

// The six rates of V at every lane of a point's group: lanes 0-5 compute one
// each (hh_rate_leaf), every lane applies the constant factors.
template <typename T>
__device__ __forceinline__ void hh_rates(T V, T* rates) {
  const int lane = threadIdx.x & 31, r = lane % HH_LANES, base = lane - r;
  const T leaf = hh_rate_leaf<T>(V, r);
  T g[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) g[j] = __shfl_sync(0xffffffffu, leaf, base + j);
  rates[0] = T(0.1) * g[0];
  rates[1] = T(4.0) * g[1];
  rates[2] = T(0.07) * g[2];
  rates[3] = g[3];
  rates[4] = T(0.01) * g[4];
  rates[5] = T(0.125) * g[5];
}

template <typename T>
__device__ __forceinline__ void hh_rhs(T t, const T* y, const T* p, bool stim, T* dy) {
  const T m = y[0], h = y[1], n = y[2], V = y[3];
  T rates[6];
  hh_rates<T>(V, rates);
  const T am = rates[0], bm = rates[1], ah = rates[2], bh = rates[3], an = rates[4],
          bn = rates[5];
  T i_Na, i_K;
  hh_currents<T>(t, y, p, stim, &i_Na, &i_K);
  // dy_g = (1 - g) a - g b as nvcc contracted it with the rates computed
  // in the thread, written out: with the rates from other lanes it would
  // contract the h row the other way
  dy[0] = fma(T(1) - m, am, -(m * bm));
  dy[1] = fma(-h, bh, (T(1) - h) * ah);
  dy[2] = fma(T(1) - n, an, -(n * bn));
  dy[3] = (-i_K - i_Na) / p[P_Cm];
}

// ---- glial Kir (emix mV/ms units) -----------------------------------------
template <typename T>
__device__ __forceinline__ void glial_currents(const T* y, const T* p, T* i_Na, T* i_K) {
  // R * TEMPERATURE / F of models/glial.py GlialKir, folded in double
  const double rt_f = 8.314e3 * 300e3 / 96485e3;
  const T V = y[0];
  const T i_pump = pump_saturating(p);
  const T E_K_init = T(rt_f) * log(p[P_K_e_init] / p[P_K_i_init]);
  const T dphi = V - p[P_E_K];
  const T A = T(1.0 + exp(18.4 / 42.4));   // a Python float in the plain version
  const T B = T(1) + exp(-(T(0.1186e3) + E_K_init) / T(0.0441e3));
  const T C = T(1) + exp((dphi + T(0.0185e3)) / T(0.0425e3));
  const T D = T(1) + exp(-(T(0.1186e3) + V) / T(0.0441e3));
  const T g_kir = sqrt(p[P_K_e] / p[P_K_e_init]) * (A * B) / (C * D);
  const T i_kir = p[P_g_leak_K] * g_kir * (V - p[P_E_K]);
  *i_Na = p[P_g_leak_Na] * (V - p[P_E_Na]) + T(3) * i_pump;
  *i_K = i_kir - T(2) * i_pump;
}

template <typename T, int MODEL>
__device__ __forceinline__ void model_rhs(T t, const T* y, const T* p, bool stim, T* dy) {
  if constexpr (MODEL == MODEL_HH_MV) {
    hh_rhs<T>(t, y, p, stim, dy);
  } else {
    T i_Na, i_K;
    glial_currents<T>(y, p, &i_Na, &i_K);
    dy[0] = (-i_K - i_Na - T(0)) / p[P_Cm];
  }
}

template <typename T, int MODEL>
__device__ __forceinline__ void model_currents(T t, const T* y, const T* p, bool stim,
                                               T* i_Na, T* i_K) {
  if constexpr (MODEL == MODEL_HH_MV) {
    hh_currents<T>(t, y, p, stim, i_Na, i_K);
  } else {
    glial_currents<T>(y, p, i_Na, i_K);
  }
}

// Half an exponential gate update of HH's m, h, n at frozen V = y[3]:
// y_g <- y_inf + (y_g - y_inf) exp(-hh (a + b)), y_inf = a / (a + b)
template <typename T>
__device__ __forceinline__ void hh_gate_half(T* y, T neg_hh) {
  T rates[6];
  hh_rates<T>(y[3], rates);
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const T a = rates[2 * g], b = rates[2 * g + 1];
    const T tau_inv = a + b;
    const T y_inf = a / tau_inv;
    y[g] = y_inf + (y[g] - y_inf) * exp(neg_hh * tau_inv);
  }
}

// Tags a launch takes, and the sizes of a tag entry's arrays (mirrored by
// knpemidg_tpu_torch/membrane/engine.py; the launcher checks the size).
#define KNP_MEM_MAX_TAGS 8
#define KNP_MEM_MAX_PARAMS 19
#define KNP_MEM_MAX_IONS 4

// what a block runs: the model and the scheme (0: no device function)
enum { KIND_HH_RK4 = 1, KIND_HH_RL = 2, KIND_GLIAL_RK4 = 3 };

struct MembraneTag {
  const void* states;        // (n_states, n) and (n_params, n), points last
  const void* params;
  void* states_out;          // the step's new states and params
  void* params_out;
  const void* v_src;         // V of point i is v_src[i]; null: the state's own
  const void* src[KNP_MEM_MAX_PARAMS];   // parameter k of point i is src[k][i];
                                         // null: params[k * n + i]
  int kind, stim, n, s0, n_states, n_params;
  int ich_slot[KNP_MEM_MAX_IONS];        // ion k's I_ch parameter slot, -1: 0
};

struct MembraneTable {
  void* phi_M;               // (n_mem,): V of point i of a tag at s0 + i
  void* I_ch;                // (n_ions, n_mem)
  int n_tags, n_ions, n_mem;
  MembraneTag tag[KNP_MEM_MAX_TAGS];
};

// The kernel's argument: the caller's table and each tag's first block,
// which the launcher lays out from the tags' kinds and point counts.
struct MembraneGrid {
  MembraneTable tab;
  int block0[KNP_MEM_MAX_TAGS];
};

// One point of one tag: load (with the pushes), integrate, write back (with
// the pulls).  The state's V is its last row (HH: m, h, n, V; GlialKir: V).
// An HH point runs on every lane of its group (their rates shared, see
// hh_rates) and its first lane writes it; a group past the tag's end runs
// its last point and writes nothing.
template <typename T, int MODEL, int NS, int NP, bool RL>
__device__ __forceinline__ void membrane_point(const MembraneTable& tab,
                                               const MembraneTag& e, long long i, T t0,
                                               T tend, T h, T h_half, T h_sixth,
                                               int n_sub) {
  constexpr int LANES = MODEL == MODEL_HH_MV ? HH_LANES : 1;
  const bool write = i < e.n && threadIdx.x % LANES == 0;
  if (i >= e.n) i = e.n - 1;
  const size_t nz = (size_t)e.n;
  const T* __restrict__ states = (const T*)e.states;
  const T* __restrict__ params = (const T*)e.params;
  T y[NS], p[NP];
#pragma unroll
  for (int s = 0; s < NS; ++s) y[s] = states[s * nz + i];
  if (e.v_src != nullptr) y[NS - 1] = ((const T*)e.v_src)[i];
#pragma unroll
  for (int k = 0; k < NP; ++k)
    p[k] = e.src[k] != nullptr ? ((const T*)e.src[k])[i] : params[k * nz + i];
  const bool stim = e.stim != 0;

  if constexpr (RL) {
    const T neg_hh = -h_half;
    T k1[NS], k2[NS], yt[NS];
    T tt = t0;
    for (int sub = 0; sub < n_sub; ++sub) {
      hh_gate_half<T>(y, neg_hh);
      hh_rhs<T>(tt, y, p, stim, k1);
      k1[0] = k1[1] = k1[2] = T(0);                 // gate rows frozen
#pragma unroll
      for (int s = 0; s < NS; ++s) yt[s] = y[s] + h_half * k1[s];
      hh_rhs<T>(tt + h_half, yt, p, stim, k2);
      k2[0] = k2[1] = k2[2] = T(0);
#pragma unroll
      for (int s = 0; s < NS; ++s) y[s] = y[s] + h * k2[s];
      hh_gate_half<T>(y, neg_hh);
      tt = tt + h;
    }
  } else {
    T k1[NS], k2[NS], k3[NS], k4[NS], yt[NS];
    T tt = t0;
    for (int sub = 0; sub < n_sub; ++sub) {
      model_rhs<T, MODEL>(tt, y, p, stim, k1);
#pragma unroll
      for (int s = 0; s < NS; ++s) yt[s] = y[s] + h_half * k1[s];
      model_rhs<T, MODEL>(tt + h_half, yt, p, stim, k2);
#pragma unroll
      for (int s = 0; s < NS; ++s) yt[s] = y[s] + h_half * k2[s];
      model_rhs<T, MODEL>(tt + h_half, yt, p, stim, k3);
#pragma unroll
      for (int s = 0; s < NS; ++s) yt[s] = y[s] + h * k3[s];
      model_rhs<T, MODEL>(tt + h, yt, p, stim, k4);
#pragma unroll
      for (int s = 0; s < NS; ++s)
        y[s] = y[s] + h_sixth * (k1[s] + T(2) * k2[s] + T(2) * k3[s] + k4[s]);
      tt = tt + h;
    }
  }

  T i_Na, i_K;
  model_currents<T, MODEL>(tend, y, p, stim, &i_Na, &i_K);
  p[P_I_ch_Na] = i_Na;
  p[P_I_ch_K] = i_K;
  p[P_I_ch_Cl] = T(0);
  if (!write) return;
  T* __restrict__ states_out = (T*)e.states_out;
  T* __restrict__ params_out = (T*)e.params_out;
#pragma unroll
  for (int s = 0; s < NS; ++s) states_out[s * nz + i] = y[s];
#pragma unroll
  for (int k = 0; k < NP; ++k) params_out[k * nz + i] = p[k];
  const size_t m = (size_t)e.s0 + i;
  ((T*)tab.phi_M)[m] = y[NS - 1];
  T* __restrict__ ich = (T*)tab.I_ch;
  for (int k = 0; k < tab.n_ions; ++k) {
    const int slot = e.ich_slot[k];
    T v = T(0);
#pragma unroll
    for (int q = 0; q < NP; ++q)
      if (q == slot) v = p[q];
    ich[(size_t)k * tab.n_mem + m] = v;
  }
}

// Threads a block: two warps, so the bench's step (4,416 HH points at 8
// lanes a point, 1,472 GlialKir points) takes 552 + 23 blocks, several on
// each of the card's 132 SMs.
constexpr int MEM_THREADS = 64;
static_assert(sizeof(MembraneGrid) <= 4096, "the kernel argument must stay under 4 KB");

static inline int knp_mem_lanes(int kind) { return kind == KIND_GLIAL_RK4 ? 1 : HH_LANES; }

// One launch for every tag of the table: block b belongs to the last tag
// whose block0 <= b; thread x of it to that tag's point
// ((b - block0) * MEM_THREADS + x) / lanes.
template <typename T>
__global__ void membrane_step_kernel(const __grid_constant__ MembraneGrid grid,
                                     const T* __restrict__ t_step, T dt, T h, T h_half,
                                     T h_sixth, int n_sub) {
  const MembraneTable& tab = grid.tab;
  int t = 0;
  while (t + 1 < tab.n_tags && (int)blockIdx.x >= grid.block0[t + 1]) ++t;
  const MembraneTag& e = tab.tag[t];
  const long long x = (long long)(blockIdx.x - grid.block0[t]) * MEM_THREADS + threadIdx.x;
  // the step time as the state's dtype holds it, and t + dt rounded in T
  const T t0 = *t_step;
  const T tend = t0 + dt;
  switch (e.kind) {
    case KIND_HH_RK4:
      membrane_point<T, MODEL_HH_MV, 4, 17, false>(tab, e, x / HH_LANES, t0, tend, h, h_half,
                                                   h_sixth, n_sub);
      break;
    case KIND_HH_RL:
      membrane_point<T, MODEL_HH_MV, 4, 17, true>(tab, e, x / HH_LANES, t0, tend, h, h_half,
                                                  h_sixth, n_sub);
      break;
    case KIND_GLIAL_RK4:
      if (x < e.n)
        membrane_point<T, MODEL_GLIAL_KIR, 1, 19, false>(tab, e, x, t0, tend, h, h_half,
                                                         h_sixth, n_sub);
      break;
  }
}

template <typename T>
static int membrane_step_launch(const void* table, int table_bytes, const void* t_step,
                                double dt, int n_sub, void* stream) {
  if (table_bytes != (int)sizeof(MembraneTable)) return (int)cudaErrorInvalidValue;
  MembraneGrid grid;
  grid.tab = *(const MembraneTable*)table;
  const MembraneTable& tab = grid.tab;
  if (tab.n_tags < 1 || tab.n_tags > KNP_MEM_MAX_TAGS || tab.n_ions < 0 ||
      tab.n_ions > KNP_MEM_MAX_IONS || n_sub < 1)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  for (int t = 0; t < tab.n_tags; ++t) {
    const MembraneTag& e = tab.tag[t];
    const bool hh = (e.kind == KIND_HH_RK4 || e.kind == KIND_HH_RL) && e.n_states == 4 &&
                    e.n_params == 17;
    const bool glial = e.kind == KIND_GLIAL_RK4 && e.n_states == 1 && e.n_params == 19;
    if (!(hh || glial) || e.n < 1) return (int)cudaErrorInvalidValue;
    grid.block0[t] = blocks;
    blocks += (int)(((long long)e.n * knp_mem_lanes(e.kind) + MEM_THREADS - 1) / MEM_THREADS);
  }
  // the same scalar roundings as the plain version: Python-float step sizes
  // cast to T
  const double h = dt / n_sub;
  membrane_step_kernel<T><<<blocks, MEM_THREADS, 0, (cudaStream_t)stream>>>(
      grid, (const T*)t_step, (T)dt, (T)h, (T)(0.5 * h), (T)(h / 6.0), n_sub);
  return (int)cudaGetLastError();
}

extern "C" int knp_membrane_step_f32(const void* table, int table_bytes, const void* t_step,
                                     double dt, int n_sub, void* stream) {
  return membrane_step_launch<float>(table, table_bytes, t_step, dt, n_sub, stream);
}

extern "C" int knp_membrane_step_f64(const void* table, int table_bytes, const void* t_step,
                                     double dt, int n_sub, void* stream) {
  return membrane_step_launch<double>(table, table_bytes, t_step, dt, n_sub, stream);
}
