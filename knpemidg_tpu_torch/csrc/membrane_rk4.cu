// Kernel C: membrane ODE step, fixed-substep RK4 or Strang-split
// Rush-Larsen.
//
// Replaces knpemidg_tpu/membrane/engine.py:93 ode_step: a vmapped fori_loop
// of substeps over all membrane points of one tag, followed by the
// channel-current write-back at t + dt (engine.py:158-164).  Scheme "rk4"
// (rk4_point, :116) runs for every model with a device right-hand side;
// scheme "rush_larsen" (rl_point, :129-152) for the Hodgkin-Huxley model:
// per substep half an exponential update of the gates m, h, n at frozen V,
// a midpoint RK2 step of the rest with the gate rows of the right-hand side
// zeroed, and the second half gate update.  A model without gating states
// (GlialKir) takes the RK4 kernel under "rush_larsen" too (engine.py:154).
//
// Bound: arithmetic latency, not bandwidth.  Each point reads its states and
// parameters once (23 values for the HH model) and then runs n_sub * 4 model
// right-hand sides (25 * 4 = 100 evaluations with several exp() each) before
// writing back.  Design: one thread per membrane point keeps its state,
// parameters and RK4 stages in registers for the whole step, so device
// memory is touched once on the way in and once on the way out; the
// points-last layout makes those loads and stores coalesced.  The model is
// chosen at launch by an integer id (the Python model's cuda_model_id).
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

// the classic HH rate functions in mV and 1/ms (models/base.py
// hh_gating_rates_mV): rates[0..5] = am, bm, ah, bh, an, bn
template <typename T>
__device__ __forceinline__ void hh_rates(T V, T* rates) {
  rates[0] = T(0.1) * vtrap(V + T(40), T(10));
  rates[1] = T(4.0) * exp(-(V + T(65)) / T(18));
  rates[2] = T(0.07) * exp(-(V + T(65)) / T(20));
  rates[3] = T(1) / (T(1) + exp(-(V + T(35)) / T(10)));
  rates[4] = T(0.01) * vtrap(V + T(55), T(10));
  rates[5] = T(0.125) * exp(-(V + T(65)) / T(80));
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
  dy[0] = (T(1) - m) * am - m * bm;
  dy[1] = (T(1) - h) * ah - h * bh;
  dy[2] = (T(1) - n) * an - n * bn;
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

template <typename T, int MODEL, int NS, int NP>
__global__ void membrane_rk4_kernel(const T* __restrict__ states,
                                    const T* __restrict__ params,
                                    T* __restrict__ states_out,
                                    T* __restrict__ params_out, int n, T t0, T tend,
                                    T h, T h_half, T h_sixth, int n_sub, int stim) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t nz = (size_t)n;
  T y[NS], p[NP];
#pragma unroll
  for (int s = 0; s < NS; ++s) y[s] = states[s * nz + i];
#pragma unroll
  for (int k = 0; k < NP; ++k) p[k] = params[k * nz + i];

  T k1[NS], k2[NS], k3[NS], k4[NS], yt[NS];
  T tt = t0;
  for (int sub = 0; sub < n_sub; ++sub) {
    model_rhs<T, MODEL>(tt, y, p, stim != 0, k1);
#pragma unroll
    for (int s = 0; s < NS; ++s) yt[s] = y[s] + h_half * k1[s];
    model_rhs<T, MODEL>(tt + h_half, yt, p, stim != 0, k2);
#pragma unroll
    for (int s = 0; s < NS; ++s) yt[s] = y[s] + h_half * k2[s];
    model_rhs<T, MODEL>(tt + h_half, yt, p, stim != 0, k3);
#pragma unroll
    for (int s = 0; s < NS; ++s) yt[s] = y[s] + h * k3[s];
    model_rhs<T, MODEL>(tt + h, yt, p, stim != 0, k4);
#pragma unroll
    for (int s = 0; s < NS; ++s)
      y[s] = y[s] + h_sixth * (k1[s] + T(2) * k2[s] + T(2) * k3[s] + k4[s]);
    tt = tt + h;
  }

  T i_Na, i_K;
  model_currents<T, MODEL>(tend, y, p, stim != 0, &i_Na, &i_K);
  p[P_I_ch_Na] = i_Na;
  p[P_I_ch_K] = i_K;
  p[P_I_ch_Cl] = T(0);
#pragma unroll
  for (int s = 0; s < NS; ++s) states_out[s * nz + i] = y[s];
#pragma unroll
  for (int k = 0; k < NP; ++k) params_out[k * nz + i] = p[k];
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

// Strang-split Rush-Larsen substeps of the HH model, one thread per point
template <typename T, int NP>
__global__ void membrane_rl_kernel(const T* __restrict__ states, const T* __restrict__ params,
                                   T* __restrict__ states_out, T* __restrict__ params_out,
                                   int n, T t0, T tend, T h, T h_half, int n_sub, int stim) {
  constexpr int NS = 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t nz = (size_t)n;
  T y[NS], p[NP];
#pragma unroll
  for (int s = 0; s < NS; ++s) y[s] = states[s * nz + i];
#pragma unroll
  for (int k = 0; k < NP; ++k) p[k] = params[k * nz + i];

  const T neg_hh = -h_half;
  T k1[NS], k2[NS], yt[NS];
  T tt = t0;
  for (int sub = 0; sub < n_sub; ++sub) {
    hh_gate_half<T>(y, neg_hh);
    hh_rhs<T>(tt, y, p, stim != 0, k1);
    k1[0] = k1[1] = k1[2] = T(0);                 // gate rows frozen
#pragma unroll
    for (int s = 0; s < NS; ++s) yt[s] = y[s] + h_half * k1[s];
    hh_rhs<T>(tt + h_half, yt, p, stim != 0, k2);
    k2[0] = k2[1] = k2[2] = T(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) y[s] = y[s] + h * k2[s];
    hh_gate_half<T>(y, neg_hh);
    tt = tt + h;
  }

  T i_Na, i_K;
  hh_currents<T>(tend, y, p, stim != 0, &i_Na, &i_K);
  p[P_I_ch_Na] = i_Na;
  p[P_I_ch_K] = i_K;
  p[P_I_ch_Cl] = T(0);
#pragma unroll
  for (int s = 0; s < NS; ++s) states_out[s * nz + i] = y[s];
#pragma unroll
  for (int k = 0; k < NP; ++k) params_out[k * nz + i] = p[k];
}

template <typename T>
static int membrane_rk4_launch(const T* states, const T* params, T* states_out,
                               T* params_out, int model_id, int stim, int n_states,
                               int n_params, int n, double t, double dt, int n_sub,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int grid = knp_blocks(n);
  // the same scalar roundings as the plain version: Python-float step
  // sizes cast to T, the step time t (already of type T) plus dt in T
  const double h = dt / n_sub;
  const T t0 = (T)t;
  const T tend = t0 + (T)dt;
  const T th = (T)h, th2 = (T)(0.5 * h), th6 = (T)(h / 6.0);
  if (model_id == MODEL_HH_MV && n_states == 4 && n_params == 17) {
    membrane_rk4_kernel<T, MODEL_HH_MV, 4, 17><<<grid, KNP_THREADS, 0, st>>>(
        states, params, states_out, params_out, n, t0, tend, th, th2, th6, n_sub, stim);
  } else if (model_id == MODEL_GLIAL_KIR && n_states == 1 && n_params == 19) {
    membrane_rk4_kernel<T, MODEL_GLIAL_KIR, 1, 19><<<grid, KNP_THREADS, 0, st>>>(
        states, params, states_out, params_out, n, t0, tend, th, th2, th6, n_sub, stim);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int membrane_rl_launch(const T* states, const T* params, T* states_out, T* params_out,
                              int model_id, int stim, int n_states, int n_params, int n,
                              double t, double dt, int n_sub, void* stream) {
  // the plain version's scalar roundings, as in membrane_rk4_launch
  const double h = dt / n_sub;
  const T t0 = (T)t;
  const T tend = t0 + (T)dt;
  if (model_id != MODEL_HH_MV || n_states != 4 || n_params != 17)
    return (int)cudaErrorInvalidValue;
  membrane_rl_kernel<T, 17><<<knp_blocks(n), KNP_THREADS, 0, (cudaStream_t)stream>>>(
      states, params, states_out, params_out, n, t0, tend, (T)h, (T)(0.5 * h), n_sub, stim);
  return (int)cudaGetLastError();
}

extern "C" int knp_membrane_rl_f32(const float* states, const float* params,
                                   float* states_out, float* params_out, int model_id,
                                   int stim, int n_states, int n_params, int n, double t,
                                   double dt, int n_sub, void* stream) {
  return membrane_rl_launch<float>(states, params, states_out, params_out, model_id, stim,
                                   n_states, n_params, n, t, dt, n_sub, stream);
}

extern "C" int knp_membrane_rl_f64(const double* states, const double* params,
                                   double* states_out, double* params_out, int model_id,
                                   int stim, int n_states, int n_params, int n, double t,
                                   double dt, int n_sub, void* stream) {
  return membrane_rl_launch<double>(states, params, states_out, params_out, model_id, stim,
                                    n_states, n_params, n, t, dt, n_sub, stream);
}

extern "C" int knp_membrane_rk4_f32(const float* states, const float* params,
                                    float* states_out, float* params_out, int model_id,
                                    int stim, int n_states, int n_params, int n, double t,
                                    double dt, int n_sub, void* stream) {
  return membrane_rk4_launch<float>(states, params, states_out, params_out, model_id, stim,
                                    n_states, n_params, n, t, dt, n_sub, stream);
}

extern "C" int knp_membrane_rk4_f64(const double* states, const double* params,
                                    double* states_out, double* params_out, int model_id,
                                    int stim, int n_states, int n_params, int n, double t,
                                    double dt, int n_sub, void* stream) {
  return membrane_rk4_launch<double>(states, params, states_out, params_out, model_id,
                                     stim, n_states, n_params, n, t, dt, n_sub, stream);
}
