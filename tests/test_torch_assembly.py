"""ops/assembly of the port against the JAX package in float64: geometry
tables, EMI and all-ion KNP blocks, rhs and P_diag, and the membrane-trace
helpers, on the EMIx fixture (3D) and the 2D neuron, at a state perturbed
from the initial one with numpy-seeded noise."""
import numpy as np
import pytest
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
