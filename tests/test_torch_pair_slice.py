"""The pair-layout slice of the port against the JAX package in float64:
``enable_pair_layout()`` in both packages, then two splitting steps of the
EMIx fixture (box_3d_axons(0)) and of the 2D neuron (nd = 3) with equal
Krylov counts and fields after unpad_state; plus the pair preconditioner
data and applies built from the same state."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

import test_torch_parity as tp
from test_torch_parity import rel, t64

from knpemidg_tpu.parallel.sharding import unpad_state as junpad
from knpemidg_tpu.solvers import twolevel as jtl
from knpemidg_tpu_torch.parallel.sharding import unpad_state
from knpemidg_tpu_torch.solvers import twolevel

TOL = 1e-8
FIELDS = ("phi", "c", "c_elim", "phi_M")


def _pair_run(make_jax, make_torch, Tstop):
    Sj, spj = make_jax()
    St, spt = make_torch()
    Sj.enable_pair_layout()
    St.enable_pair_layout()
    sj = Sj.solve_system_active(Tstop, 0.0, spj)
    st = St.solve_system_active(Tstop, 0.0, spt)
    return Sj, junpad(Sj, sj), St, unpad_state(St, st)


def test_emix_pair_two_steps_match_jax():
    Sj, sj, St, st = _pair_run(tp.emix_jax, tp.emix_torch, 0.2)
    assert Sj.stats.emi_niters == St.stats.emi_niters == [3, 9]
    assert Sj.stats.knp_niters == St.stats.knp_niters == [[11, 8], [9, 5]]
    assert St.n_cells_pad == Sj.n_cells_pad == 7914
    for key in FIELDS:
        assert st[key].shape[-1] == (St.n_mem if key == "phi_M" else St.n_cells)
        assert rel(st[key], sj[key]) < TOL, key


def test_neuron_2d_pair_two_steps_match_jax():
    Sj, sj, St, st = _pair_run(tp.neuron_2d_jax, tp.neuron_2d_torch, 2e-4)
    assert Sj.stats.emi_niters == St.stats.emi_niters
    assert Sj.stats.knp_niters == St.stats.knp_niters
    for key in FIELDS:
        assert rel(st[key], sj[key]) < TOL, key


@pytest.fixture(scope="module")
def pc_setup():
    """Both EMIx solvers on the pair layout; JAX's initial state with its
    frozen pair preconditioner, carried into the port."""
    Sj, spj = tp.emix_jax()
    St, spt = tp.emix_torch()
    Sj.enable_pair_layout()
    St.enable_pair_layout()
    sj = Sj.attach_pc(Sj._initial_state(0.0), spj)
    st = tp.jax_state_for_torch(sj, St)
    return Sj, spj, sj, St, spt, st


def test_pair_preconditioner_data_match_jax(pc_setup):
    """build_two_level(v=pair_v_sums, nbr=pair_nbr) for EMI (compartment
    and moment data included) and KNP, from the port's own pair
    assembly of the same state."""
    Sj, spj, sj, St, spt, st = pc_setup
    pc = St._build_pc({k: v for k, v in st.items() if k != "pc"}, spt)
    for part in ("emi", "knp"):
        assert sorted(pc[part]) == sorted(sj["pc"][part]), part
        for key, val in pc[part].items():
            ref = sj["pc"][part][key]
            assert val.shape == tuple(ref.shape), (part, key)
            assert rel(val, ref) < 1e-10, (part, key)
    assert pc["emi"]["mom_W"].shape[-2:] == (2 * St.nd, St.pairs["int_f"].shape[0])


def test_pair_preconditioner_applies_match_jax(pc_setup):
    """The live-masked two-level applies on (2nd, 2nd, npair) diagonals
    with agg_size // 2 pair chunks, both pair_bj variants; the batched KNP
    apply unmasked in the full form and as the solver makes it (halves,
    masked)."""
    Sj, spj, sj, St, spt, st = pc_setup
    pMj, Ichj, Itj = Sj._pads(sj)
    blocks, rhs, Pd = Sj._assemble_emi(sj["c"], sj["c_elim"], pMj, Itj, sj["t"],
                                       pair=True)
    rng = np.random.default_rng(9)
    r = rng.standard_normal(Pd.shape[1:]) * np.asarray(Sj._pair_mask)
    blocks_t = (t64(blocks[0]), t64(blocks[1]))
    for pair_bj in ("halves", "full"):
        spj_b = dataclasses.replace(spj, pair_bj=pair_bj)
        spt_b = dataclasses.replace(spt, pair_bj=pair_bj)
        fj = Sj._make_precond(blocks, Pd, spj_b, sym=True, pc=sj["pc"]["emi"])
        ft = St._make_precond(blocks_t, t64(Pd), spt_b, pc=st["pc"]["emi"])
        assert rel(ft(t64(r)), fj(jnp.asarray(r))) < 1e-10, pair_bj

    bK, _ = Sj._knp_assemble_all(sj["c"], sj["c_elim"], sj["phi"], pMj, Ichj, Itj,
                                 sj["t"], sj["c"])
    agg = spj.agg_size // 2
    pdK_bj = bK[0] * Sj._pair_bj_halves[None]
    R = rng.standard_normal(bK[0].shape[:2] + bK[0].shape[-1:])
    gj = jtl.two_level_apply_batched(sj["pc"]["knp"], pdK_bj, agg)
    data = {k: t64(v) for k, v in sj["pc"]["knp"].items()}
    gt = twolevel.two_level_apply_batched(data, t64(pdK_bj), agg)
    ref = gj(jnp.asarray(R))
    assert rel(gt(t64(R)), ref) < 1e-10
    # the solver's form: the halves flag on the halves diagonal, the live
    # mask applied to the result
    lm = np.asarray(Sj._pair_mask, dtype=np.float64)[None]
    gh = twolevel.two_level_apply_batched(data, t64(pdK_bj), agg, halves=True, buffer=True)
    assert rel(gh(t64(R)) * t64(lm), np.asarray(ref) * lm) < 1e-10
