"""Kernel C (membrane/engine.ode_step): one PDE step of 25 RK4 substeps of
the port's plain path against the JAX package in float64, per membrane
model (the CUDA kernel is held against the plain path in
tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_parity import rel

from knpemidg_tpu.membrane import engine as jengine
from knpemidg_tpu.models import glial as jglial, hh as jhh
from knpemidg_tpu_torch.membrane import engine
from knpemidg_tpu_torch.models import glial, hh

TOL = 1e-10      # 100 rhs evaluations with exp() in f64

# (name, jax model, port model, dt, t0, parameter scales)
MODELS = {
    "hh_mv": (lambda: jhh.HodgkinHuxleyMV(stimulus=True),
              lambda: hh.HodgkinHuxleyMV(stimulus=True), 0.1, 0.3,
              {"Cm": 2.0, "K_e": 3.3, "Na_i": 12.8, "E_K": -90.0, "E_Na": 50.0,
               "stim_amplitude": 5.0}),
    "glial_kir": (lambda: jglial.GlialKir(), lambda: glial.GlialKir(), 0.1, 0.3,
                  {"Cm": 2.0, "K_e": 3.3, "Na_i": 12.4, "E_K": -85.0, "E_Na": 55.0}),
    "hh_si": (lambda: jhh.HodgkinHuxleySI(stimulus=True),
              lambda: hh.HodgkinHuxleySI(stimulus=True), 1e-4, 0.02,
              {"Cm": 0.02, "K_e": 4.0, "Na_i": 12.8, "E_K": -0.09, "E_Na": 0.05,
               "stim_amplitude": 10.0}),
}


def _pair(name, n=300, seed=0):
    jmk, tmk, dt, t0, scales = MODELS[name]
    rng = np.random.default_rng(seed)
    jm = jengine.make_membrane(jmk(), np.zeros((n, 3)), dtype=jnp.float64)
    tm = engine.make_membrane(tmk(), np.zeros((n, 3)), device="cpu")
    states = np.asarray(jm.states) * rng.uniform(0.97, 1.03, jm.states.shape)
    jm = jengine.MembraneState(states=states, params=np.asarray(jm.params), model=jm.model)
    tm = engine.MembraneState(states=torch.as_tensor(states), params=tm.params,
                              model=tm.model)
    for key, val in scales.items():
        v = val * rng.uniform(0.9, 1.1, n)
        jm = jengine.set_param(jm, key, v)
        tm = engine.set_param(tm, key, v)
    return jm, tm, dt, t0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rk4_step_matches_jax(name):
    jm, tm, dt, t0 = _pair(name)
    ref = jengine.ode_step(jm, t0, dt, 25)
    got = engine.ode_step(tm, t0, dt, 25)
    for s in range(ref.states.shape[0]):
        assert rel(got.states[s], ref.states[s]) < TOL
    for key in ("I_ch_Na", "I_ch_K"):
        assert rel(engine.get_param(got, key), jengine.get_param(ref, key)) < TOL


def test_rush_larsen_matches_jax():
    jm, tm, dt, t0 = _pair("hh_mv", seed=1)
    ref = jengine.ode_step(jm, t0, dt, 25, scheme="rush_larsen")
    got = engine.ode_step(tm, t0, dt, 25, scheme="rush_larsen")
    assert rel(got.states, ref.states) < TOL


def test_step_returns_new_state():
    _, tm, dt, t0 = _pair("glial_kir")
    before = tm.states.clone()
    out = engine.ode_step(tm, t0, dt, 25)
    assert torch.equal(tm.states, before)
    assert not torch.equal(out.states, before)
