"""ops/assembly of the port against the JAX package in float64: geometry
tables, EMI and all-ion KNP blocks, rhs and P_diag, and the membrane-trace
helpers (one field, and every ion field at once as the solver's ODE inputs
take them), on the EMIx fixture (3D) and the 2D neuron, at a state perturbed
from the initial one with numpy-seeded noise."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_parity as tp
from test_torch_parity import rel, t64

from knpemidg_tpu.ops import assembly as jasm
from knpemidg_tpu_torch.ops import assembly

TOL = 1e-12

FIXTURES = {"emix": (lambda: tp.emix_jax()[0], lambda: tp.emix_torch()[0]),
            "neuron2d": (lambda: tp.neuron_2d_jax()[0], lambda: tp.neuron_2d_torch()[0])}


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def solvers(request):
    jb, tb = FIXTURES[request.param]
    Sj, St = jb(), tb()
    rng = np.random.default_rng(7)
    c = np.asarray(Sj.c_init) * rng.uniform(0.99, 1.01, Sj.c_init.shape)
    c_elim = np.asarray(Sj.c_elim_init) * rng.uniform(0.99, 1.01, Sj.c_elim_init.shape)
    scale = float(np.abs(np.asarray(Sj._initial_state(0.0)["phi_M"])).max())
    phi = rng.standard_normal(Sj.phi_init.shape) * 0.1 * scale
    phi_M = rng.standard_normal(Sj.n_mem) * scale
    I_ch = rng.standard_normal((len(Sj.ion_list), Sj.n_mem)) * 1e-2
    inputs = dict(c=c, c_elim=c_elim, phi=phi, phi_M=phi_M, I_ch=I_ch, t=0.0)
    return Sj, St, inputs


def _pads_np(phi_M, I_ch):
    phi_M_pad = np.concatenate([phi_M, [0.0]])
    I_ch_pad = np.concatenate([I_ch, np.zeros((I_ch.shape[0], 1))], axis=1)
    return phi_M_pad, I_ch_pad, I_ch_pad.sum(axis=0)


def test_geometry_tables_match(solvers):
    Sj, St, _ = solvers
    for key, vj in Sj.g.items():
        if not hasattr(vj, "ndim") or key not in St.g:
            continue
        vt = St.g[key]
        if np.issubdtype(np.asarray(vj).dtype, np.floating):
            assert rel(vt, vj) < TOL, key
        else:
            assert np.array_equal(tp.to_np(vt), np.asarray(vj)), key
    for key in ("Rp", "Rm", "cp", "cm", "fidx"):
        assert np.allclose(tp.to_np(St.mem_dev[key]), np.asarray(Sj.mem_dev[key]),
                           rtol=TOL, atol=0), key


def test_emi_blocks_rhs_pdiag_match(solvers):
    Sj, St, x = solvers
    pM, _, Itot = _pads_np(x["phi_M"], x["I_ch"])
    bj, rj, pj = Sj._assemble_emi(jnp.asarray(x["c"]), jnp.asarray(x["c_elim"]),
                                  jnp.asarray(pM), jnp.asarray(Itot), 0.0)
    bt, rt, pt = St._assemble_emi(t64(x["c"]), t64(x["c_elim"]), t64(pM), t64(Itot),
                                  0.0)
    assert rel(bt, bj) < TOL
    assert rel(rt, rj) < TOL
    assert rel(pt, pj) < TOL


def test_knp_blocks_rhs_match(solvers):
    Sj, St, x = solvers
    pM, Ich, Itot = _pads_np(x["phi_M"], x["I_ch"])
    for k in range(Sj.N_ions):
        Sj._knp_static(k)
    bj, rj = Sj._knp_assemble_all(
        jnp.asarray(x["c"]), jnp.asarray(x["c_elim"]), jnp.asarray(x["phi"]),
        jnp.asarray(pM), jnp.asarray(Ich), jnp.asarray(Itot), 0.0, jnp.asarray(x["c"]))
    bt, rt = St._knp_assemble_all(t64(x["c"]), t64(x["c_elim"]), t64(x["phi"]),
                                  t64(pM), t64(Ich), t64(Itot), 0.0, t64(x["c"]))
    assert bt.shape == tuple(bj.shape)
    assert rel(bt, bj) < TOL
    assert rel(rt, rj) < TOL


def test_membrane_helpers_match(solvers):
    Sj, St, x = solvers
    gj, mj, gt, mt = Sj.g, Sj.mem_dev, St.g, St.mem_dev
    phi, c0 = x["phi"], x["c"][0]
    assert rel(assembly.jump_phi_M_m(gt, mt, t64(phi)),
               jasm.jump_phi_M_m(gj, mj, jnp.asarray(phi))) < TOL
    for side in ("p", "m"):
        assert rel(assembly.membrane_avg_m(gt, mt, t64(c0), side),
                   jasm.membrane_avg_m(gj, mj, jnp.asarray(c0), side)) < TOL
    p = Sj.params
    assert rel(assembly.nernst_potential_m(gt, mt, t64(c0), 1.0, p.F, p.R, p.temperature),
               jasm.nernst_potential_m(gj, mj, jnp.asarray(c0), 1.0, p.F, p.R,
                                       p.temperature)) < TOL
    zj = np.asarray(Sj.z[:-1])
    assert rel(assembly.eliminated_concentration(t64(x["c"]), t64(zj), St.rho, 1.0),
               jasm.eliminated_concentration(jnp.asarray(x["c"]), jnp.asarray(zj),
                                             Sj.rho, 1.0)) < TOL


def _ion_fields(St, x):
    """The solver's ion fields in ion-list order (the solved ions, then the
    eliminated one) and their Nernst factors RT/(zF)."""
    p = St.params
    fields = [t64(f) for f in x["c"]] + [t64(x["c_elim"])]
    coefs = [assembly.nernst_coef(float(ion.z), p.F, p.R, p.temperature)
             for ion in St.ion_list]
    return fields, coefs


@pytest.mark.parametrize("quantity", ["plus", "minus", "nernst", "jump"])
def test_membrane_traces_m_plain_matches_jax(solvers, quantity):
    """The batched ODE-input traces (plus and minus facet averages and the
    Nernst potential of every ion field) against the JAX package's
    one-field helpers; the jump as minus - plus against jump_phi_M_m."""
    Sj, St, x = solvers
    gj, mj, p = Sj.g, Sj.mem_dev, Sj.params
    fields, coefs = _ion_fields(St, x)
    tr = assembly.membrane_traces_m_plain(St.g, St.mem_dev, fields, coefs)
    assert tuple(tr.shape) == (3, len(fields), St.n_mem)
    assert torch.equal(assembly.membrane_traces_m(St.g, St.mem_dev, fields, coefs), tr)
    for k, (f, ion) in enumerate(zip(fields, Sj.ion_list)):
        fj = jnp.asarray(f.numpy())
        if quantity in ("plus", "minus"):
            ref = jasm.membrane_avg_m(gj, mj, fj, "p" if quantity == "plus" else "m")
            got = tr[0 if quantity == "plus" else 1, k]
        elif quantity == "nernst":
            ref = jasm.nernst_potential_m(gj, mj, fj, float(ion.z), p.F, p.R,
                                          p.temperature)
            got = tr[2, k]
        else:
            ref, got = jasm.jump_phi_M_m(gj, mj, fj), tr[1, k] - tr[0, k]
        assert rel(got, ref) < TOL, (quantity, ion.name)


@pytest.mark.parametrize("push", ["V", "E", "update_ode"])
def test_ode_inputs_push_the_one_field_traces(solvers, push):
    """Solver._ode_inputs computes every ion's traces in one call; each tag
    gets exactly (bitwise) what a loop over the one-field functions on all
    membrane facets, sliced to the tag, gives: the membrane potential, the
    Nernst potentials E_* and StandardSolver's K_e / Na_i."""
    _, St, x = solvers
    from knpemidg_tpu_torch.membrane.engine import get_param

    p = St.params
    state = dict(St._initial_state(0.0), c=t64(x["c"]).contiguous(),
                 c_elim=t64(x["c_elim"]), phi_M=t64(x["phi_M"]))
    fields, _ = _ion_fields(St, x)
    pushed = St._ode_inputs(state, first_step=False)
    assert sorted(pushed) == sorted(state["mem"])
    n = 0
    for tag, mm in pushed.items():
        s0, s1 = St.tables.slices[tag]
        if push == "V":
            want = {"V": state["phi_M"][s0:s1]}
            got = {"V": mm.get_state("V")}
        elif push == "E":
            want = {f"E_{ion.name}": assembly.nernst_potential_m(
                St.g, St.mem_dev, f, float(ion.z), p.F, p.R, p.temperature)[s0:s1]
                for f, ion in zip(fields, St.ion_list) if mm.has_param(f"E_{ion.name}")}
            got = {k: get_param(mm, k) for k in want}
        else:
            na = St._na_index if St._na_index is not None else len(St.ion_list) - 1
            want = {"K_e": assembly.membrane_avg_m(St.g, St.mem_dev, fields[St._k_index],
                                                   "p")[s0:s1],
                    "Na_i": assembly.membrane_avg_m(St.g, St.mem_dev, fields[na],
                                                    "m")[s0:s1]}
            got = {k: get_param(mm, k) for k in want}
        for k in want:
            assert torch.equal(got[k], want[k]), (tag, k)
            n += 1
    assert n > 0
