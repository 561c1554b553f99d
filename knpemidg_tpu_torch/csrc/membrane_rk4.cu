// Kernel C: the membrane ODE step of every tag in one launch, fixed-substep
// RK4 or Strang-split Rush-Larsen, with the solver's PDE -> ODE pushes read
// in place and its ODE -> PDE pulls written in place; and ode_run, many
// steps of one tag in one launch.
//
// Replaces knpemidg_tpu/membrane/engine.py:93 ode_step (a vmapped fori_loop
// of substeps over all membrane points of one tag, then the channel-current
// write-back at t + dt, engine.py:158-164) as knpemidg_tpu/solver.py:955-992
// Solver._ode_step drives it: per tag, the pushes (V from phi_M, E_<ion>,
// update_ode's values), the step, and the pulls (V into phi_M, I_ch_<ion>
// into I_ch).  Scheme "rk4" (rk4_point, engine.py:116) runs for every model
// with a device right-hand side; scheme "rush_larsen" (rl_point, :129-152)
// for the Hodgkin-Huxley models: per substep half an exponential update of
// the gates m, h, n at frozen V, a midpoint RK2 step of the rest with the
// gate rows of the right-hand side zeroed, and the second half gate update.
// A model without gating states (the leak, glial and calibration models)
// runs RK4 under "rush_larsen" too (engine.py:154).  ode_run (engine.py:168,
// a lax.scan of n_steps ode_steps at t0 + k dt) is the same point loop
// wrapped in the step loop: the state stays in registers for every step.
//
// The device functions (a model's cuda_model_id, knpemidg_tpu_torch/models):
// the Hodgkin-Huxley model in mV/ms (HodgkinHuxleyMV, and HodgkinHuxleyAstro
// with the same parameter names) and in SI units (HodgkinHuxleySI), the
// passive leak (LeakSI), the glial Kir model (GlialKir) and its astrocyte
// variant (GlialKirAstro: the Michaelis pump and a Cl leak), and the two
// calibration systems (CalibrationEMIx, CalibrationAstro: ode_run only, they
// have no membrane potential to pull).
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
// HH models run each point on a group of HH_LANES = 8 lanes: lanes 0-5
// compute one of the six gating rates each (exp(-u), u = (V + c) / d, then
// vtrap's quotient or bh's, one instruction stream on per-lane constants),
// the group exchanges them with __shfl_sync, and every lane of the group
// runs the rest of the right-hand side on the same values; the group's
// first lane writes.  The one-state models (one exp pair a right-hand side)
// keep a lane a point, and so do the calibration systems (one point).
//
// All tags share one launch: a table passed by value (MembraneGrid, under
// 4 KB) gives each tag its first block, so a block belongs to one tag and
// switches once on its model and scheme.  Per parameter slot a tag may name
// a source (the Nernst row of the trace tensor, an update_ode value, ...)
// read in place of its own parameter row, and a source of V (phi_M at the
// tag's offset); the new V and the channel currents go straight into phi_M
// and I_ch at the tag's offset.
//
// Bits: every HH-MV and GlialKir output equals the one-thread-a-point
// kernels this launch replaced.  Each rate keeps that kernel's expression,
// and where nvcc contracted an expression in the thread but would contract
// it otherwise once its inputs come from another lane, that contraction is
// written out (hh_rhs).  The other models keep the plain versions'
// expression order and agree with them to round-off (pow, exp and log may
// round otherwise than torch's).
#include "common.cuh"

// Parameter slots: the PARAM_DEFAULTS order of the Python models
// (knpemidg_tpu_torch/models/).  The wrapper checks that a model's state
// and parameter names are its device function's (engine.CUDA_MODELS)
// before launching.  The HH models read the first 17 slots of P_*, GlialKir
// the first 19, GlialKirAstro all 20.
enum {
  P_g_Na_bar = 0, P_g_K_bar, P_g_leak_Na, P_g_leak_K, P_E_Na, P_E_K, P_E_Cl,
  P_Cm, P_stim_amplitude, P_I_ch_Na, P_I_ch_K, P_I_ch_Cl, P_K_e, P_Na_i,
  P_m_K, P_m_Na, P_I_max, P_K_e_init, P_K_i_init, P_g_leak_Cl
};
// LeakSI (15 slots)
enum {
  L_g_leak_Na = 0, L_g_leak_K, L_E_Na, L_E_K, L_E_Cl, L_Cm, L_stim_amplitude,
  L_I_ch_Na, L_I_ch_K, L_I_ch_Cl, L_K_e, L_Na_i, L_m_K, L_m_Na, L_I_max
};
// CalibrationEMIx (12 slots), CalibrationAstro (13)
enum {
  C_g_Na_bar = 0, C_g_K_bar, C_g_leak_Na_n, C_g_leak_K_n, C_g_leak_Na_g,
  C_g_leak_K_g, C_Cm, C_stim_amplitude, C_m_K, C_m_Na, C_I_max_n, C_I_max_g,
  C_g_leak_Cl_g
};

// the device functions: a model's cuda_model_id
enum {
  MODEL_HH_MV = 1, MODEL_GLIAL_KIR = 2, MODEL_HH_SI = 3, MODEL_LEAK_SI = 4,
  MODEL_GLIAL_ASTRO = 5, MODEL_CAL_EMIX = 6, MODEL_CAL_ASTRO = 7
};

template <typename T>
__device__ __forceinline__ T vtrap(T x, T y) {
  // x / (1 - exp(-x/y)) with the removable singularity at x = 0
  // (models/base.py vtrap)
  const T u = x / y;
  if (fabs(u) < T(1e-4)) return y * (T(1) + u / T(2) + u * u / T(12));
  return x / (T(1) - exp(-u));
}

template <typename T>
__device__ __forceinline__ T pos_mod(T t, T period) {
  // jnp.mod / torch.remainder for a positive period: the exact fmod,
  // shifted into [0, period) for a negative t
  const T r = fmod(t, period);
  return r < T(0) ? r + period : r;
}

template <typename T>
__device__ __forceinline__ T pump_sat(T I_max, T m_K, T K_e, T m_Na, T Na_i) {
  // models/base.py sodium_potassium_pump_saturating
  const T a = T(1) + m_K / K_e;
  const T b = T(1) + m_Na / Na_i;
  return I_max / ((a * a) * (b * b * b));
}

template <typename T>
__device__ __forceinline__ T pump_michaelis(T I_max, T m_K, T K_e, T m_Na, T Na_i) {
  // models/base.py sodium_potassium_pump_michaelis
  const T na = pow(Na_i, T(1.5));
  return I_max * (K_e / (K_e + m_K)) * (na / (na + pow(m_Na, T(1.5))));
}

// pump_sat on the P_* slots, written out: a call of pump_sat here makes
// nvcc contract the HH-MV write-back otherwise than in the kernel this one
// replaced, and its outputs are held to that kernel's bits
template <typename T>
__device__ __forceinline__ T pump_saturating(const T* p) {
  const T a = T(1) + p[P_m_K] / p[P_K_e];
  const T b = T(1) + p[P_m_Na] / p[P_Na_i];
  return p[P_I_max] / ((a * a) * (b * b * b));
}

// ---- Hodgkin-Huxley (emix mV/ms units; SI: volts, seconds) ----------------
template <typename T, bool SI>
__device__ __forceinline__ T hh_stimulus(T t, const T* p) {
  // SI: stim_amplitude exp(-mod(t, 0.03) / 0.002) (t < 0.125); mV/ms:
  // stim_amplitude exp(-mod(t, 20) / 2)
  if constexpr (SI)
    return p[P_stim_amplitude] * exp(-pos_mod(t, T(0.03)) / T(0.002)) * T(t < T(125e-3));
  return p[P_stim_amplitude] * exp(-pos_mod(t, T(20.0)) / T(2.0));
}

template <typename T, bool SI>
__device__ __forceinline__ void hh_currents(T t, const T* y, const T* p, bool stim,
                                            T* i_Na, T* i_K) {
  const T m = y[0], h = y[1], n = y[2], V = y[3];
  const T i_stim = stim ? hh_stimulus<T, SI>(t, p) : T(0);
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
// instruction stream on their own constants.  SI (hh_gating_rates_SI, V
// given as v = 1e3 V in mV, rates in 1/s): the same leaves but bh's,
// 1e3 / (exp((30 - (v + 65)) / 10) + 1): its exponent is -u with
// u = ((v + 65) - 30) / 10 bitwise (round to nearest is symmetric) and its
// numerator is 1e3.
template <typename T, bool SI = false>
__device__ __forceinline__ T hh_rate_leaf(T V, int r) {
  const T c = r == 0 ? T(40) : r == 3 ? (SI ? T(65) : T(35)) : r == 4 ? T(55) : T(65);
  const T d = r == 1 ? T(18) : r == 2 ? T(20) : r == 5 ? T(80) : T(10);
  const T x = SI && r == 3 ? (V + c) - T(30) : V + c;
  const T u = x / d;
  const T e = exp(-u);
  const bool bh = r == 3;
  const T q = (bh ? (SI ? T(1e3) : T(1)) : x) / (bh ? T(1) + e : T(1) - e);
  if (r == 0 || r == 4) return fabs(u) < T(1e-4) ? d * (T(1) + u / T(2) + u * u / T(12)) : q;
  return bh ? q : e;
}

// The six rates of V at every lane of a point's group: lanes 0-5 compute one
// each (hh_rate_leaf), every lane applies the constant factors (SI: the
// rates' 1e3 per second, V in volts as v = V * 1e3 mV).
template <typename T, bool SI = false>
__device__ __forceinline__ void hh_rates(T V, T* rates) {
  const int lane = threadIdx.x & 31, r = lane % HH_LANES, base = lane - r;
  const T leaf = SI ? hh_rate_leaf<T, true>(V * T(1e3), r) : hh_rate_leaf<T>(V, r);
  T g[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) g[j] = __shfl_sync(0xffffffffu, leaf, base + j);
  rates[0] = (SI ? T(0.1e3) : T(0.1)) * g[0];
  rates[1] = (SI ? T(4.0e3) : T(4.0)) * g[1];
  rates[2] = (SI ? T(0.07e3) : T(0.07)) * g[2];
  rates[3] = g[3];
  rates[4] = (SI ? T(0.01e3) : T(0.01)) * g[4];
  rates[5] = (SI ? T(0.125e3) : T(0.125)) * g[5];
}

// The six mV/ms rates of V in one thread (the calibration systems' neuron)
template <typename T>
__device__ __forceinline__ void hh_rates_thread(T V, T* rates) {
  T g[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) g[j] = hh_rate_leaf<T>(V, j);
  rates[0] = T(0.1) * g[0];
  rates[1] = T(4.0) * g[1];
  rates[2] = T(0.07) * g[2];
  rates[3] = g[3];
  rates[4] = T(0.01) * g[4];
  rates[5] = T(0.125) * g[5];
}

template <typename T, bool SI = false>
__device__ __forceinline__ void hh_rhs(T t, const T* y, const T* p, bool stim, T* dy) {
  const T m = y[0], h = y[1], n = y[2], V = y[3];
  T rates[6];
  hh_rates<T, SI>(V, rates);
  const T am = rates[0], bm = rates[1], ah = rates[2], bh = rates[3], an = rates[4],
          bn = rates[5];
  T i_Na, i_K;
  hh_currents<T, SI>(t, y, p, stim, &i_Na, &i_K);
  // dy_g = (1 - g) a - g b as nvcc contracted it with the rates computed
  // in the thread, written out: with the rates from other lanes it would
  // contract the h row the other way
  dy[0] = fma(T(1) - m, am, -(m * bm));
  dy[1] = fma(-h, bh, (T(1) - h) * ah);
  dy[2] = fma(T(1) - n, an, -(n * bn));
  dy[3] = (-i_K - i_Na) / p[P_Cm];
}

// ---- passive leak (SI units) ------------------------------------------------
// LeakSI: the SI stimulus with no t < 0.125 cut-off, always on (the model
// has no stimulus flag; stim_amplitude scales it)
template <typename T>
__device__ __forceinline__ void leak_currents(T t, const T* y, const T* p, T* i_Na, T* i_K) {
  const T V = y[0];
  const T i_stim = p[L_stim_amplitude] * exp(-pos_mod(t, T(0.03)) / T(0.002));
  const T i_pump = pump_sat(p[L_I_max], p[L_m_K], p[L_K_e], p[L_m_Na], p[L_Na_i]);
  *i_Na = (p[L_g_leak_Na] + i_stim) * (V - p[L_E_Na]) + T(3) * i_pump;
  *i_K = p[L_g_leak_K] * (V - p[L_E_K]) - T(2) * i_pump;
}

// ---- glial Kir (emix mV/ms units) -----------------------------------------
// ASTRO (GlialKirAstro): the astrocyte constants, the Michaelis pump and the
// Cl leak g_leak_Cl (V - E_Cl); GlialKir's Cl current is 0
template <typename T, bool ASTRO = false>
__device__ __forceinline__ void glial_currents(const T* y, const T* p, T* i_Na, T* i_K,
                                               T* i_Cl) {
  // R * TEMPERATURE / F of models/glial.py GlialKir / GlialKirAstro, folded
  // in double
  const double rt_f = ASTRO ? 8.315e3 * 307e3 / 96500e3 : 8.314e3 * 300e3 / 96485e3;
  const T V = y[0];
  const T i_pump =
      ASTRO ? pump_michaelis(p[P_I_max], p[P_m_K], p[P_K_e], p[P_m_Na], p[P_Na_i])
            : pump_saturating(p);
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
  *i_Cl = ASTRO ? p[P_g_leak_Cl] * (V - p[P_E_Cl]) : T(0);
}

// ---- calibration systems (emix mV/ms units, one point) ---------------------
// models/calibration.py CalibrationEMIx (11 states: m, h, n, V_n, V_g, K_e,
// K_n, K_g, Na_e, Na_n, Na_g) and, ASTRO, CalibrationAstro (Cl_e, Cl_n,
// Cl_g besides; the astro constants, the Michaelis pump on the glia and
// its Cl leak).  The model's Python-float constants (R T / F, E_K_init and
// the Kir's A B, the volume factors) are folded in double and meet the
// state's dtype where the plain version's do.
template <typename T, bool ASTRO>
__device__ __forceinline__ void calibration_rhs(T t, const T* y, const T* p, T* dy) {
  const double RTF = ASTRO ? 8.315e3 * 307e3 / 96500e3 : 8.314e3 * 300e3 / 96485e3;
  const double F = ASTRO ? 96500e3 : 96485e3;
  const double K_E_INIT = ASTRO ? 3.092970607490389 : 3.32597273958481;
  const double K_G_INIT = ASTRO ? 99.3100014897692 : 102.74050220804774;
  const double sE = 2.29e-6 / (F * 7.08e-11);
  const double sI = 2.29e-6 / (F * (3.42e-11 / 2.0));
  const double E_K_init = RTF * log(K_E_INIT / K_G_INIT);
  const double AB = (1.0 + exp(18.4 / 42.4)) * (1.0 + exp(-(0.1186e3 + E_K_init) / 0.0441e3));
  const T m = y[0], h = y[1], n = y[2], V_n = y[3], V_g = y[4];
  const T K_e = y[5], K_n = y[6], K_g = y[7], Na_e = y[8], Na_n = y[9], Na_g = y[10];
  const T E_Na_n = T(RTF) * log(Na_e / Na_n);
  const T E_K_n = T(RTF) * log(K_e / K_n);
  const T E_Na_g = T(RTF) * log(Na_e / Na_g);
  const T E_K_g = T(RTF) * log(K_e / K_g);
  T rates[6];
  hh_rates_thread<T>(V_n, rates);
  const T am = rates[0], bm = rates[1], ah = rates[2], bh = rates[3], an = rates[4],
          bn = rates[5];
  const T i_stim = p[C_stim_amplitude] * exp(-pos_mod(t, T(20.0)) / T(2.0));
  const T i_pump_n = pump_sat(p[C_I_max_n], p[C_m_K], K_e, p[C_m_Na], Na_n);
  const T i_pump_g = ASTRO ? pump_michaelis(p[C_I_max_g], p[C_m_K], K_e, p[C_m_Na], Na_g)
                           : pump_sat(p[C_I_max_g], p[C_m_K], K_e, p[C_m_Na], Na_g);
  // models/glial.py _kir_conductance with the class constants
  const T dphi = V_g - E_K_g;
  const T C = T(1) + exp((dphi + T(0.0185e3)) / T(0.0425e3));
  const T D = T(1) + exp(-(T(0.1186e3) + V_g) / T(0.0441e3));
  const T g_kir = sqrt(K_e / T(K_E_INIT)) * T(AB) / (C * D);
  const T i_kir = p[C_g_leak_K_g] * g_kir * (V_g - E_K_g);
  const T i_Na_n = (p[C_g_leak_Na_n] + p[C_g_Na_bar] * h * (m * m * m) + i_stim) *
                       (V_n - E_Na_n) + T(3) * i_pump_n;
  const T n2 = n * n;
  const T i_K_n = (p[C_g_leak_K_n] + p[C_g_K_bar] * (n2 * n2)) * (V_n - E_K_n) -
                  T(2) * i_pump_n;
  const T i_Na_g = p[C_g_leak_Na_g] * (V_g - E_Na_g) + T(3) * i_pump_g;
  const T i_K_g = i_kir - T(2) * i_pump_g;
  const T Cm = p[C_Cm];
  dy[0] = (T(1) - m) * am - m * bm;
  dy[1] = (T(1) - h) * ah - h * bh;
  dy[2] = (T(1) - n) * an - n * bn;
  dy[3] = (-i_K_n - i_Na_n) / Cm;
  dy[4] = (-i_K_g - i_Na_g) / Cm;
  dy[5] = (i_K_n + i_K_g) * T(sE);
  dy[6] = -i_K_n * T(sI);
  dy[7] = -i_K_g * T(sI);
  dy[8] = (i_Na_n + i_Na_g) * T(sE);
  dy[9] = -i_Na_n * T(sI);
  dy[10] = -i_Na_g * T(sI);
  if constexpr (ASTRO) {
    const T Cl_e = y[11], Cl_g = y[13];
    const T E_Cl_g = T(-RTF) * log(Cl_e / Cl_g);
    const T i_Cl_g = p[C_g_leak_Cl_g] * (V_g - E_Cl_g);
    dy[4] = dy[4] - i_Cl_g / Cm;
    dy[11] = -i_Cl_g * T(sE);      // (-i_Cl_n - i_Cl_g) sE with i_Cl_n = 0
    dy[12] = T(0);
    dy[13] = i_Cl_g * T(sI);
  }
}

__host__ __device__ constexpr bool hh_model(int model) { return model == MODEL_HH_MV || model == MODEL_HH_SI; }

template <typename T, int MODEL>
__device__ __forceinline__ void model_rhs(T t, const T* y, const T* p, bool stim, T* dy) {
  if constexpr (hh_model(MODEL)) {
    hh_rhs<T, MODEL == MODEL_HH_SI>(t, y, p, stim, dy);
  } else if constexpr (MODEL == MODEL_LEAK_SI) {
    T i_Na, i_K;
    leak_currents<T>(t, y, p, &i_Na, &i_K);
    dy[0] = (-i_K - i_Na) / p[L_Cm];
  } else if constexpr (MODEL == MODEL_GLIAL_KIR || MODEL == MODEL_GLIAL_ASTRO) {
    T i_Na, i_K, i_Cl;
    glial_currents<T, MODEL == MODEL_GLIAL_ASTRO>(y, p, &i_Na, &i_K, &i_Cl);
    dy[0] = (-i_K - i_Na - i_Cl) / p[P_Cm];
  } else {
    calibration_rhs<T, MODEL == MODEL_CAL_ASTRO>(t, y, p, dy);
  }
}

// The channel-current write-back at the end of a step (engine.py:158-164):
// the model's currents at t + dt into its I_ch_Na, I_ch_K, I_ch_Cl slots
// (the calibration systems have none)
template <typename T, int MODEL>
__device__ __forceinline__ void model_pull(T t, const T* y, T* p, bool stim) {
  if constexpr (hh_model(MODEL)) {
    T i_Na, i_K;
    hh_currents<T, MODEL == MODEL_HH_SI>(t, y, p, stim, &i_Na, &i_K);
    p[P_I_ch_Na] = i_Na;
    p[P_I_ch_K] = i_K;
    p[P_I_ch_Cl] = T(0);
  } else if constexpr (MODEL == MODEL_LEAK_SI) {
    T i_Na, i_K;
    leak_currents<T>(t, y, p, &i_Na, &i_K);
    p[L_I_ch_Na] = i_Na;
    p[L_I_ch_K] = i_K;
    p[L_I_ch_Cl] = T(0);
  } else if constexpr (MODEL == MODEL_GLIAL_KIR || MODEL == MODEL_GLIAL_ASTRO) {
    T i_Na, i_K, i_Cl;
    glial_currents<T, MODEL == MODEL_GLIAL_ASTRO>(y, p, &i_Na, &i_K, &i_Cl);
    p[P_I_ch_Na] = i_Na;
    p[P_I_ch_K] = i_K;
    p[P_I_ch_Cl] = i_Cl;
  }
}

// Half an exponential gate update of HH's m, h, n at frozen V = y[3]:
// y_g <- y_inf + (y_g - y_inf) exp(-hh (a + b)), y_inf = a / (a + b)
template <typename T, bool SI = false>
__device__ __forceinline__ void hh_gate_half(T* y, T neg_hh) {
  T rates[6];
  hh_rates<T, SI>(y[3], rates);
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
#define KNP_MEM_MAX_PARAMS 20
#define KNP_MEM_MAX_IONS 4

// what a block runs: the model and the scheme (0: no device function); the
// calibration kinds run only under ode_run (they have no V to pull)
enum {
  KIND_HH_RK4 = 1, KIND_HH_RL = 2, KIND_GLIAL_RK4 = 3, KIND_HHSI_RK4 = 4, KIND_HHSI_RL = 5,
  KIND_LEAK_RK4 = 6, KIND_GLIAL_ASTRO_RK4 = 7, KIND_CAL_EMIX_RK4 = 8, KIND_CAL_ASTRO_RK4 = 9
};

struct MembraneTag {
  const void* states;        // (n_states, n) and (n_params, n), points last
  const void* params;
  void* states_out;          // the step's new states and params
  void* params_out;
  const void* v_src;         // V of point i is v_src[i]; null: the state's own
  const void* src[KNP_MEM_MAX_PARAMS];   // parameter k of point i is src[k][i];
                                         // null: params[k * n + i]
  int kind, stim, n, s0, n_states, n_params;   // stim: the HH kinds' stimulus flag
  int ich_slot[KNP_MEM_MAX_IONS];        // ion k's I_ch parameter slot, -1: 0
};

struct MembraneTable {
  void* phi_M;               // (n_mem,): V of point i of a tag at s0 + i; null
                             // (ode_run): no pulls
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

// The times of a launch: a step starts at the step time as the state's
// dtype holds it (t_step) and pulls its currents at t + dt rounded in T;
// ode_run's step k starts at t0 + k dt, rounded in double then cast to T
// (JAX's t0 + k * dt with an integer k, then jnp.asarray(t, dtype)), and
// runs n_steps steps.
template <typename T>
struct MembraneTimes {
  const T* t_step;           // null: ode_run
  double t0, dt;
  long long n_steps;
  T dt_t, h, h_half, h_sixth;
  int n_sub;
};

// The substeps of one step from t0: RK4, or (RL) the Strang-split
// Rush-Larsen substep of the HH models.
template <typename T, int MODEL, int NS, bool RL>
__device__ __forceinline__ void membrane_substeps(T* y, const T* p, bool stim, T t0, T h,
                                                  T h_half, T h_sixth, int n_sub) {
  if constexpr (RL) {
    const T neg_hh = -h_half;
    T k1[NS], k2[NS], yt[NS];
    T tt = t0;
    for (int sub = 0; sub < n_sub; ++sub) {
      hh_gate_half<T, MODEL == MODEL_HH_SI>(y, neg_hh);
      model_rhs<T, MODEL>(tt, y, p, stim, k1);
      k1[0] = k1[1] = k1[2] = T(0);                 // gate rows frozen
#pragma unroll
      for (int s = 0; s < NS; ++s) yt[s] = y[s] + h_half * k1[s];
      model_rhs<T, MODEL>(tt + h_half, yt, p, stim, k2);
      k2[0] = k2[1] = k2[2] = T(0);
#pragma unroll
      for (int s = 0; s < NS; ++s) y[s] = y[s] + h * k2[s];
      hh_gate_half<T, MODEL == MODEL_HH_SI>(y, neg_hh);
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
}

// One point of one tag: load (with the pushes), integrate, write back (with
// the pulls).  The state's V is its last row (HH: m, h, n, V; the one-state
// models: V).  An HH point runs on every lane of its group (their rates
// shared, see hh_rates) and its first lane writes it; a group past the
// tag's end runs its last point and writes nothing.  RUN (ode_run): the
// substeps of n_steps steps, the channel currents written back after the
// last one only (no right-hand side reads them); a step (not RUN) keeps
// the one substep loop of the kernel it replaced, so the compiler contracts
// its write-back as it did there (bitwise the same outputs).
template <typename T, int MODEL, int NS, int NP, bool RL, bool RUN>
__device__ __forceinline__ void membrane_point(const MembraneTable& tab,
                                               const MembraneTag& e, long long i,
                                               const MembraneTimes<T>& tm) {
  constexpr int LANES = hh_model(MODEL) ? HH_LANES : 1;
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

  T t0;
  if constexpr (RUN) {
    t0 = T(tm.t0);
    for (long long step = 0; step < tm.n_steps; ++step) {
      t0 = T(__dadd_rn(tm.t0, __dmul_rn((double)step, tm.dt)));
      membrane_substeps<T, MODEL, NS, RL>(y, p, stim, t0, tm.h, tm.h_half, tm.h_sixth,
                                          tm.n_sub);
    }
  } else {
    t0 = *tm.t_step;
    membrane_substeps<T, MODEL, NS, RL>(y, p, stim, t0, tm.h, tm.h_half, tm.h_sixth,
                                        tm.n_sub);
  }

  model_pull<T, MODEL>(t0 + tm.dt_t, y, p, stim);
  if (!write) return;
  T* __restrict__ states_out = (T*)e.states_out;
  T* __restrict__ params_out = (T*)e.params_out;
#pragma unroll
  for (int s = 0; s < NS; ++s) states_out[s * nz + i] = y[s];
#pragma unroll
  for (int k = 0; k < NP; ++k) params_out[k * nz + i] = p[k];
  if (tab.phi_M == nullptr) return;
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

static inline bool knp_mem_hh(int kind) {
  return kind == KIND_HH_RK4 || kind == KIND_HH_RL || kind == KIND_HHSI_RK4 ||
         kind == KIND_HHSI_RL;
}

static inline int knp_mem_lanes(int kind) { return knp_mem_hh(kind) ? HH_LANES : 1; }

// a tag's (states, parameters) as its kind's device function reads them;
// the calibration kinds only under ode_run
static inline bool knp_mem_shape(int kind, int n_states, int n_params, bool run) {
  switch (kind) {
    case KIND_HH_RK4: case KIND_HH_RL: case KIND_HHSI_RK4: case KIND_HHSI_RL:
      return n_states == 4 && n_params == 17;
    case KIND_GLIAL_RK4: return n_states == 1 && n_params == 19;
    case KIND_LEAK_RK4: return n_states == 1 && n_params == 15;
    case KIND_GLIAL_ASTRO_RK4: return n_states == 1 && n_params == 20;
    case KIND_CAL_EMIX_RK4: return run && n_states == 11 && n_params == 12;
    case KIND_CAL_ASTRO_RK4: return run && n_states == 14 && n_params == 13;
    default: return false;
  }
}

// One launch for every tag of the table: block b belongs to the last tag
// whose block0 <= b; thread x of it to that tag's point
// ((b - block0) * MEM_THREADS + x) / lanes.  RUN: ode_run's instantiation,
// which also takes the calibration kinds.
template <typename T, bool RUN>
__global__ void membrane_step_kernel(const __grid_constant__ MembraneGrid grid,
                                     const MembraneTimes<T> tm) {
  const MembraneTable& tab = grid.tab;
  int t = 0;
  while (t + 1 < tab.n_tags && (int)blockIdx.x >= grid.block0[t + 1]) ++t;
  const MembraneTag& e = tab.tag[t];
  const long long x = (long long)(blockIdx.x - grid.block0[t]) * MEM_THREADS + threadIdx.x;
  switch (e.kind) {
    case KIND_HH_RK4:
      membrane_point<T, MODEL_HH_MV, 4, 17, false, RUN>(tab, e, x / HH_LANES, tm);
      break;
    case KIND_HH_RL:
      membrane_point<T, MODEL_HH_MV, 4, 17, true, RUN>(tab, e, x / HH_LANES, tm);
      break;
    case KIND_GLIAL_RK4:
      if (x < e.n) membrane_point<T, MODEL_GLIAL_KIR, 1, 19, false, RUN>(tab, e, x, tm);
      break;
    case KIND_HHSI_RK4:
      membrane_point<T, MODEL_HH_SI, 4, 17, false, RUN>(tab, e, x / HH_LANES, tm);
      break;
    case KIND_HHSI_RL:
      membrane_point<T, MODEL_HH_SI, 4, 17, true, RUN>(tab, e, x / HH_LANES, tm);
      break;
    case KIND_LEAK_RK4:
      if (x < e.n) membrane_point<T, MODEL_LEAK_SI, 1, 15, false, RUN>(tab, e, x, tm);
      break;
    case KIND_GLIAL_ASTRO_RK4:
      if (x < e.n) membrane_point<T, MODEL_GLIAL_ASTRO, 1, 20, false, RUN>(tab, e, x, tm);
      break;
    case KIND_CAL_EMIX_RK4:
      if constexpr (RUN)
        if (x < e.n) membrane_point<T, MODEL_CAL_EMIX, 11, 12, false, RUN>(tab, e, x, tm);
      break;
    case KIND_CAL_ASTRO_RK4:
      if constexpr (RUN)
        if (x < e.n) membrane_point<T, MODEL_CAL_ASTRO, 14, 13, false, RUN>(tab, e, x, tm);
      break;
  }
}

// Lays out the blocks and launches; t_step null: ode_run from t0 for
// n_steps steps (one tag, no pulls)
template <typename T>
static int membrane_launch(const void* table, int table_bytes, const void* t_step, double t0,
                           double dt, int n_sub, long long n_steps, void* stream) {
  if (table_bytes != (int)sizeof(MembraneTable)) return (int)cudaErrorInvalidValue;
  const bool run = t_step == nullptr;
  MembraneGrid grid;
  grid.tab = *(const MembraneTable*)table;
  const MembraneTable& tab = grid.tab;
  if (tab.n_tags < 1 || tab.n_tags > KNP_MEM_MAX_TAGS || tab.n_ions < 0 ||
      tab.n_ions > KNP_MEM_MAX_IONS || n_sub < 1 || n_steps < 1 ||
      (run && (tab.n_tags != 1 || tab.phi_M != nullptr)) || (!run && tab.phi_M == nullptr))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  for (int t = 0; t < tab.n_tags; ++t) {
    const MembraneTag& e = tab.tag[t];
    if (!knp_mem_shape(e.kind, e.n_states, e.n_params, run) || e.n < 1)
      return (int)cudaErrorInvalidValue;
    grid.block0[t] = blocks;
    blocks += (int)(((long long)e.n * knp_mem_lanes(e.kind) + MEM_THREADS - 1) / MEM_THREADS);
  }
  // the same scalar roundings as the plain version: Python-float step sizes
  // cast to T
  const double h = dt / n_sub;
  MembraneTimes<T> tm;
  tm.t_step = (const T*)t_step;
  tm.t0 = t0;
  tm.dt = dt;
  tm.n_steps = n_steps;
  tm.dt_t = (T)dt;
  tm.h = (T)h;
  tm.h_half = (T)(0.5 * h);
  tm.h_sixth = (T)(h / 6.0);
  tm.n_sub = n_sub;
  if (run)
    membrane_step_kernel<T, true><<<blocks, MEM_THREADS, 0, (cudaStream_t)stream>>>(grid, tm);
  else
    membrane_step_kernel<T, false><<<blocks, MEM_THREADS, 0, (cudaStream_t)stream>>>(grid, tm);
  return (int)cudaGetLastError();
}

extern "C" int knp_membrane_step_f32(const void* table, int table_bytes, const void* t_step,
                                     double dt, int n_sub, void* stream) {
  if (t_step == nullptr) return (int)cudaErrorInvalidValue;
  return membrane_launch<float>(table, table_bytes, t_step, 0.0, dt, n_sub, 1, stream);
}

extern "C" int knp_membrane_step_f64(const void* table, int table_bytes, const void* t_step,
                                     double dt, int n_sub, void* stream) {
  if (t_step == nullptr) return (int)cudaErrorInvalidValue;
  return membrane_launch<double>(table, table_bytes, t_step, 0.0, dt, n_sub, 1, stream);
}

// ode_run: n_steps steps of one tag from t0 in one launch
extern "C" int knp_membrane_run_f32(const void* table, int table_bytes, double t0, double dt,
                                    int n_sub, long long n_steps, void* stream) {
  return membrane_launch<float>(table, table_bytes, nullptr, t0, dt, n_sub, n_steps, stream);
}

extern "C" int knp_membrane_run_f64(const void* table, int table_bytes, double t0, double dt,
                                    int n_sub, long long n_steps, void* stream) {
  return membrane_launch<double>(table, table_bytes, nullptr, t0, dt, n_sub, n_steps, stream);
}
