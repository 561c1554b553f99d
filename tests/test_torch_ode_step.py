"""The ODE step of the splitting (step 0) of the port against the JAX package
in float64: Solver._ode_step -- the PDE -> ODE pushes, every tag's membrane
step and the ODE -> PDE pulls, which on CPU tensors run through the tag
table's plain twin (engine.ode_step_tags_plain) -- on the EMIx fixture
(box_3d_axons(0): GlialKir and HodgkinHuxleyMV) at a state perturbed with
numpy-seeded noise, per scheme, first step and layout; an update_ode hook
that returns a non-contiguous tensor, a numpy array and a scalar; and the
static tag table itself."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_parity as tp
from test_torch_parity import rel

from knpemidg_tpu.membrane import engine as jengine
from knpemidg_tpu_torch.membrane import engine
from knpemidg_tpu_torch.models import glial, hh

TOL = 1e-12
LAYOUTS = ("cell", "pair")
_SOLVERS = {}


def _solvers(layout):
    """(JAX solver, port solver) on the EMIx fixture, built once per layout."""
    if layout not in _SOLVERS:
        Sj, St = tp.emix_jax()[0], tp.emix_torch()[0]
        if layout == "pair":
            Sj.enable_pair_layout()
            St.enable_pair_layout()
        _SOLVERS[layout] = (Sj, St)
    return _SOLVERS[layout]


def _states(Sj, St, seed=3):
    """A JAX state with perturbed concentrations, potential, time and
    membrane states, and the same state in the port (through numpy)."""
    rng = np.random.default_rng(seed)
    s = Sj._initial_state(0.0)
    noise = lambda a, w: jnp.asarray(np.asarray(a) * rng.uniform(1 - w, 1 + w, np.shape(a)))
    mem = {tag: jengine.MembraneState(states=noise(mm.states, 0.02),
                                      params=jnp.asarray(mm.params),
                                      model=mm.model) for tag, mm in s["mem"].items()}
    sj = dict(s, c=noise(s["c"], 0.01), c_elim=noise(s["c_elim"], 0.01),
              phi_M=noise(s["phi_M"], 0.1), t=jnp.asarray(0.3), mem=mem)
    return sj, tp.jax_state_for_torch(sj, St)


def _with_scheme(S, scheme):
    S.params = dataclasses.replace(S.params, ode_scheme=scheme)


def _assert_steps_equal(oj, ot):
    for tag, mj in oj["mem"].items():
        mt = ot["mem"][tag]
        assert rel(mt.states, mj.states) < TOL, ("states", tag)
        assert rel(mt.params, mj.params) < TOL, ("params", tag)
    assert rel(ot["phi_M"], oj["phi_M"]) < TOL
    assert rel(ot["I_ch"], oj["I_ch"]) < TOL
    for k in range(ot["I_ch"].shape[0]):
        assert rel(ot["I_ch"][k], oj["I_ch"][k]) < TOL, ("I_ch", k)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("first_step", [True, False])
@pytest.mark.parametrize("scheme", ["rk4", "rush_larsen"])
def test_ode_step_matches_jax(scheme, first_step, layout):
    Sj, St = _solvers(layout)
    _with_scheme(Sj, scheme)
    _with_scheme(St, scheme)
    sj, st = _states(Sj, St)
    before = {tag: (mm.states.clone(), mm.params.clone()) for tag, mm in st["mem"].items()}
    phi_M = st["phi_M"].clone()
    _assert_steps_equal(Sj._ode_step(sj, first_step=first_step),
                        St._ode_step(st, first_step=first_step))
    # the input state is left as it was
    assert torch.equal(st["phi_M"], phi_M)
    for tag, (y, p) in before.items():
        assert torch.equal(st["mem"][tag].states, y)
        assert torch.equal(st["mem"][tag].params, p)


def _jax_hook(self, tag, traces):
    plus = traces.plus(0)
    na = len(self.ion_list) - 1
    return {"K_e": jnp.stack([plus, 2 * plus], axis=1)[:, 0],
            "Na_i": np.asarray(traces.minus(na)) * 1.0, "m_K": 2.5}


def _torch_hook(self, tag, traces):
    plus = traces.plus(0)
    na = len(self.ion_list) - 1
    strided = torch.stack([plus, 2 * plus], dim=1)[:, 0]
    assert not strided.is_contiguous()
    return {"K_e": strided, "Na_i": traces.minus(na).numpy() * 1.0, "m_K": 2.5}


@pytest.mark.parametrize("scheme", ["rk4", "rush_larsen"])
def test_update_ode_values_of_any_form_match_jax(scheme):
    """A subclass's update_ode may return a non-contiguous tensor, a numpy
    array or a scalar: each is made one contiguous source of the tag's
    length, dtype and device, and the step equals the JAX package's with
    the same hook."""
    Sj, St = tp.emix_jax()[0], tp.emix_torch()[0]
    Sj.__class__ = type("HookedJax", (type(Sj),), {"update_ode": _jax_hook})
    St.__class__ = type("HookedTorch", (type(St),), {"update_ode": _torch_hook})
    _with_scheme(Sj, scheme)
    _with_scheme(St, scheme)
    sj, st = _states(Sj, St, seed=4)
    ot = St._ode_step(st, first_step=False)
    _assert_steps_equal(Sj._ode_step(sj, first_step=False), ot)
    for mm in ot["mem"].values():
        assert torch.all(engine.get_param(mm, "m_K") == 2.5)


def test_tag_table_of_the_emix_models():
    """Slots and block kinds of the EMIx models' table: the I_ch slots per
    ion (-1 for an ion the model has no current of), a refusal for a model
    without a device function, one chunk per 8 tags, and slices that must
    cover the membrane."""
    _, St = _solvers("cell")
    state = St._initial_state(0.0)
    for scheme, hh_kind in (("rk4", engine.KIND_HH_RK4), ("rush_larsen", engine.KIND_HH_RL)):
        _with_scheme(St, scheme)
        table = St._ode_table(state)
        assert St._ode_table(state) is table                 # built once
        assert table.n_mem == St.n_mem == 448 and table.n_ions == 3
        (g, h), = [table.entries]
        assert (g.s0, g.n, g.kind) == (0, 112, engine.KIND_GLIAL_RK4)
        assert (h.s0, h.n, h.kind) == (112, 336, hh_kind)
        assert g.ich_slot == h.ich_slot == (10, 11, 9)       # K, Cl, Na
        tab, = table.chunks
        assert (tab.n_tags, tab.n_ions, tab.n_mem) == (2, 3, 448)
        assert [(tab.tag[j].kind, tab.tag[j].s0, tab.tag[j].n) for j in range(2)] == [
            (g.kind, 0, 112), (h.kind, 112, 336)]
        assert [tab.tag[0].n_states, tab.tag[0].n_params, tab.tag[1].n_states,
                tab.tag[1].n_params] == [1, 19, 4, 17]
        assert list(tab.tag[0].ich_slot) == [10, 11, 9, 0]
    _with_scheme(St, "rk4")
    t = engine.tag_table([(hh.HodgkinHuxleyMV(), 0, 40)], 40, ["K", "Ca"])
    assert t.entries[0].ich_slot == (10, -1)
    si = engine.tag_table([(hh.HodgkinHuxleySI(), 0, 8)], 8)
    assert si.entries[0].kind == 0 and si.chunks == () and "HodgkinHuxleySI" in \
        si.entries[0].refusal
    many = engine.tag_table([(glial.GlialKir(), 100 * j, 100) for j in range(10)], 1000)
    assert [c.n_tags for c in many.chunks] == [8, 2]
    assert [many.chunks[1].tag[j].s0 for j in range(2)] == [800, 900]
    with pytest.raises(ValueError):
        engine.tag_table([(glial.GlialKir(), 0, 10), (glial.GlialKir(), 12, 10)], 22)


def test_ode_step_tags_over_ten_tags_equal_one_tag_steps():
    """Ten tags through ode_step_tags (plain twin on the CPU) equal ten
    one-tag ode_step calls, with V read from phi_M at each tag's offset."""
    rng = np.random.default_rng(5)
    n, tags = 30, 10
    models = [glial.GlialKir() if j % 2 else hh.HodgkinHuxleyMV() for j in range(tags)]
    mems = []
    for m in models:
        mm = engine.make_membrane(m, np.zeros((n, 3)), device="cpu")
        for key, val in {"Cm": 2.0, "K_e": 3.3, "Na_i": 12.8, "E_K": -90.0,
                         "E_Na": 50.0}.items():
            mm = engine.set_param(mm, key, val * rng.uniform(0.9, 1.1, n))
        mems.append(mm)
    table = engine.tag_table([(m, n * j, n) for j, m in enumerate(models)], n * tags,
                             ["Na", "K"], "rush_larsen")
    phi_M = torch.as_tensor(rng.uniform(-80.0, -60.0, n * tags))
    pushes = [engine.TagPush(v=(phi_M, n * j)) for j in range(tags)]
    out, phi_new, I_ch = engine.ode_step_tags(table, mems, pushes, 0.3, 0.1, 25)
    for j, (mm, got) in enumerate(zip(mems, out)):
        ref = engine.ode_step(mm.replace_state("V", phi_M[n * j:n * (j + 1)]), 0.3, 0.1, 25,
                              scheme="rush_larsen")
        assert torch.equal(got.states, ref.states) and torch.equal(got.params, ref.params)
        assert torch.equal(phi_new[n * j:n * (j + 1)], ref.get_state("V"))
        assert torch.equal(I_ch[:, n * j:n * (j + 1)],
                           torch.stack([engine.get_param(ref, "I_ch_Na"),
                                        engine.get_param(ref, "I_ch_K")]))
