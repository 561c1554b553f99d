"""The membrane models of the port against the JAX package in float64:
each model's right-hand side, channel currents and gating rates at seeded
points, its plain ODE step under both schemes (the plain twin of kernel
K13), the plain ode_run of the calibration systems, and the kernel kinds
the tag table gives each model and each pair of tags that share a launch
(the CUDA kernel itself is held against the plain step in
tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import rel

from knpemidg_tpu.membrane import engine as jengine
from knpemidg_tpu.models import calibration as jcal, glial as jglial, hh as jhh, \
    leak as jleak
from knpemidg_tpu_torch.membrane import engine
from knpemidg_tpu_torch.models import calibration, glial, hh, leak

MV = {"Cm": 2.0, "K_e": 3.3, "Na_i": 12.8, "E_K": -90.0, "E_Na": 50.0, "E_Cl": -80.0,
      "stim_amplitude": 5.0}
SI = {"Cm": 0.02, "K_e": 4.0, "Na_i": 12.8, "E_K": -0.09, "E_Na": 0.05, "E_Cl": -0.08,
      "stim_amplitude": 10.0}
# name -> (JAX model, port model, parameter scales, dt, step time): the SI
# steps cross the HH-SI stimulus's t = 0.125 s cut-off four periods in
MODELS = {
    "hh_si": (lambda: jhh.HodgkinHuxleySI(), lambda: hh.HodgkinHuxleySI(), SI, 1e-4, 0.12495),
    "hh_astro": (jhh.HodgkinHuxleyAstro, hh.HodgkinHuxleyAstro, MV, 0.05, 0.3),
    "leak_si": (jleak.LeakSI, leak.LeakSI, SI, 1e-4, 0.12495),
    "glial_astro": (jglial.GlialKirAstro, glial.GlialKirAstro, MV, 0.05, 0.3),
    "cal_emix": (jcal.CalibrationEMIx, calibration.CalibrationEMIx, {}, 0.1, 30.0),
    "cal_astro": (jcal.CalibrationAstro, calibration.CalibrationAstro, {}, 0.1, 30.0),
}
RHS_TOL, STEP_TOL = 1e-13, 1e-12


def _pair(name, n=64, seed=0):
    """The same seeded points in both packages: states around the model's
    initial state, the parameters of ``MODELS`` scaled per point."""
    jmk, tmk, scales, dt, t0 = MODELS[name]
    rng = np.random.default_rng(seed)
    jm = jengine.make_membrane(jmk(), np.zeros((n, 3)), dtype=jnp.float64)
    states = np.asarray(jm.states) * rng.uniform(0.97, 1.03, jm.states.shape)
    params = np.asarray(jm.params) * rng.uniform(0.9, 1.1, jm.params.shape)
    for key, val in scales.items():
        params[jm.model.PARAMS[key]] = val * rng.uniform(0.9, 1.1, n)
    jm = jengine.MembraneState(states=states, params=params, model=jm.model)
    tm = engine.MembraneState(states=torch.as_tensor(states), params=torch.as_tensor(params),
                              model=tmk())
    return jm, tm, dt, t0


def _vmapped(fn, t, y, p):
    return jax.vmap(lambda yy, pp: fn(t, yy, pp), in_axes=-1, out_axes=-1)(
        jnp.asarray(y), jnp.asarray(p))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rhs_currents_and_rates_match_jax(name):
    jm, tm, _, t0 = _pair(name)
    t = torch.tensor(t0, dtype=torch.float64)
    ref = _vmapped(jm.model.rhs, t0, jm.states, jm.params)
    got = tm.model.rhs(t, tm.states, tm.params)
    for s in range(ref.shape[0]):
        assert rel(got[s], ref[s]) < RHS_TOL, s
    cur_ref = _vmapped(jm.model.currents, t0, jm.states, jm.params)
    cur = tm.model.currents(t, tm.states, tm.params)
    assert set(cur) == set(cur_ref)
    for key in cur:
        assert rel(cur[key], cur_ref[key]) < RHS_TOL, key
    if tm.model.gating_indices():
        ja, jb = _vmapped(jm.model.gating_rates, t0, jm.states, jm.params)
        a, b = tm.model.gating_rates(t, tm.states, tm.params)
        assert rel(a, ja) < RHS_TOL and rel(b, jb) < RHS_TOL


@pytest.mark.parametrize("scheme", ["rk4", "rush_larsen"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_plain_step_matches_jax(name, scheme):
    jm, tm, dt, t0 = _pair(name, seed=1)
    n_sub = 2 if name.startswith("cal") else 25
    ref = jengine.ode_step(jm, t0, dt, n_sub, scheme=scheme)
    got = engine.ode_step_plain(tm, t0, dt, n_sub, scheme=scheme)
    for s in range(ref.states.shape[0]):
        assert rel(got.states[s], ref.states[s]) < STEP_TOL, s
    for k in range(ref.params.shape[0]):
        assert rel(got.params[k], ref.params[k]) < STEP_TOL, k


@pytest.mark.parametrize("name", ["cal_emix", "cal_astro"])
def test_plain_ode_run_matches_jax(name):
    """200 steps of 0.1 ms at one point with two substeps, as the
    calibration pipeline runs them (from the model's initial state)."""
    jmk, tmk = MODELS[name][:2]
    jm = jengine.make_membrane(jmk(), np.zeros((1, 2)), dtype=jnp.float64)
    tm = engine.make_membrane(tmk(), np.zeros((1, 2)), device="cpu")
    ref = jengine.ode_run(jm, 0.0, 0.1, 200, n_sub=2)
    got = engine.ode_run(tm, 0.0, 0.1, 200, n_sub=2)
    for s in range(ref.states.shape[0]):
        assert rel(got.states[s], ref.states[s]) < STEP_TOL, (s, tm.model.STATE_NAMES[s])
    assert not torch.equal(got.states, tm.states)


# model -> its kinds under rk4 and Rush-Larsen (0: refused as a tag)
KINDS = {
    hh.HodgkinHuxleyMV: (engine.KIND_HH_RK4, engine.KIND_HH_RL),
    hh.HodgkinHuxleyAstro: (engine.KIND_HH_RK4, engine.KIND_HH_RL),
    hh.HodgkinHuxleySI: (engine.KIND_HHSI_RK4, engine.KIND_HHSI_RL),
    leak.LeakSI: (engine.KIND_LEAK_RK4, engine.KIND_LEAK_RK4),
    glial.GlialKir: (engine.KIND_GLIAL_RK4, engine.KIND_GLIAL_RK4),
    glial.GlialKirAstro: (engine.KIND_GLIAL_ASTRO_RK4, engine.KIND_GLIAL_ASTRO_RK4),
    calibration.CalibrationEMIx: (0, 0),
    calibration.CalibrationAstro: (0, 0),
}
# the pairs of tags one app's step launches together
PAIRS = [(leak.LeakSI, hh.HodgkinHuxleySI), (glial.GlialKirAstro, hh.HodgkinHuxleyAstro),
         (hh.HodgkinHuxleyMV, glial.GlialKir), (hh.HodgkinHuxleySI, hh.HodgkinHuxleySI)]


@pytest.mark.parametrize("scheme", ["rk4", "rush_larsen"])
def test_tag_table_kinds_of_every_model(scheme):
    """Each model's kind under the scheme, its table entry's sizes and
    stimulus flag and its I_ch slots for the ion order [K, Na, Cl]; a
    calibration system has no V and is refused as a tag (ode_run takes
    it)."""
    ions = ["K", "Na", "Cl"]
    for cls, kinds in KINDS.items():
        model = cls()
        table = engine.tag_table([(model, 0, 10)], 10, ions, scheme)
        e, = table.entries
        assert e.kind == kinds[scheme == "rush_larsen"], cls.__name__
        if not e.kind:
            assert table.chunks == () and "V as its last state" in e.refusal
            assert engine._kind(model, "rk4", tag=False)[0], cls.__name__
            continue
        tag = table.chunks[0].tag[0]
        assert (tag.n_states, tag.n_params) == (len(model.STATES), len(model.PARAMS))
        assert tag.stim == int(bool(getattr(model, "stimulus", False)))
        assert e.ich_slot == tuple(model.PARAMS[f"I_ch_{ion}"] for ion in ions)
        assert e.nernst_slot == tuple(model.PARAMS[f"E_{ion}"] for ion in ions)
    assert engine.MAX_PARAMS == len(glial.GlialKirAstro.PARAM_DEFAULTS) == 20


@pytest.mark.parametrize("scheme", ["rk4", "rush_larsen"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "-".join(c.__name__ for c in p))
def test_tag_table_of_mixed_tags(pair, scheme):
    """Two tags of different kinds share one chunk (one launch), each with
    its own kind, slice, sizes and slots."""
    models = [cls() for cls in pair]
    table = engine.tag_table([(models[0], 0, 7), (models[1], 7, 5)], 12, ["K", "Cl", "Na"],
                             scheme)
    tab, = table.chunks
    assert tab.n_tags == 2
    for j, (m, s0, n) in enumerate(zip(models, (0, 7), (7, 5))):
        assert tab.tag[j].kind == KINDS[type(m)][scheme == "rush_larsen"]
        assert (tab.tag[j].s0, tab.tag[j].n) == (s0, n)
        assert (tab.tag[j].n_states, tab.tag[j].n_params) == (len(m.STATES), len(m.PARAMS))
        assert list(tab.tag[j].ich_slot[:3]) == [m.PARAMS["I_ch_K"], m.PARAMS["I_ch_Cl"],
                                                 m.PARAMS["I_ch_Na"]]
