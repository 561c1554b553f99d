"""solvers/twolevel of the port against the JAX package in float64: the
frozen coarse, compartment and order-2 moment data of the EMI and KNP
preconditioners built from the same (JAX-assembled) blocks, and the single
and batched applies."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_parity as tp
from test_torch_parity import rel, t64

from knpemidg_tpu.solvers import twolevel as jtl
from knpemidg_tpu_torch.solvers import twolevel

TOL = 1e-10      # explicit Cholesky inverses of equilibrated matrices (cond ~1e5)


@pytest.fixture(scope="module")
def setup():
    Sj, spj = tp.emix_jax()
    St, spt = tp.emix_torch()
    state = Sj.attach_pc(Sj._initial_state(0.0), spj)
    phi_M_pad, I_ch_pad, I_ch_tot_pad = Sj._pads(state)
    blocks, rhs, Pd = Sj._assemble_emi(state["c"], state["c_elim"], phi_M_pad,
                                       I_ch_tot_pad, state["t"])
    blocksK, _ = Sj._knp_assemble_all(state["c"], state["c_elim"], state["phi"],
                                      phi_M_pad, I_ch_pad, I_ch_tot_pad,
                                      state["t"], state["c"])
    return dict(Sj=Sj, St=St, spj=spj, spt=spt, pc=state["pc"], blocks=blocks,
                Pd=Pd, blocksK=blocksK)


def test_emi_coarse_and_moment_data_match(setup):
    St, spt, pc = setup["St"], setup["spt"], setup["pc"]
    blocks, Pd = t64(setup["blocks"]), t64(setup["Pd"])
    oh, ids = St._comp_arrays()
    data = twolevel.build_two_level(blocks, St.g["nbr"], spt.agg_size, sym=True,
                                    comp_onehot=oh, comp_ids=ids,
                                    extra_diag=Pd - blocks[0], ridge=spt.coarse_ridge)
    data.update(St._emi_moment_data(blocks, spt))
    assert sorted(data) == sorted(pc["emi"])
    for key in data:
        assert data[key].shape == tuple(pc["emi"][key].shape), key
        assert rel(data[key], pc["emi"][key]) < TOL, key


def test_knp_coarse_data_match(setup):
    St, spt, pc = setup["St"], setup["spt"], setup["pc"]
    data = St._build_knp_pc(t64(setup["blocksK"]), spt)
    assert sorted(data) == sorted(pc["knp"])
    for key in data:
        assert rel(data[key], pc["knp"][key]) < TOL, key


def test_two_level_applies_match(setup):
    Sj, pc = setup["Sj"], setup["pc"]
    agg = setup["spt"].agg_size
    rng = np.random.default_rng(11)
    r = rng.standard_normal(setup["Pd"].shape[1:])
    fj = jtl.two_level_apply_fn(pc["emi"], setup["Pd"], agg)
    pc_t = {k: t64(v) for k, v in pc["emi"].items()}
    ft = twolevel.two_level_apply_fn(pc_t, t64(setup["Pd"]), agg)
    assert rel(ft(t64(r)), fj(jnp.asarray(r))) < TOL

    bK = setup["blocksK"]
    R = rng.standard_normal((bK.shape[0],) + r.shape)
    gj = jtl.two_level_apply_batched(pc["knp"], bK[:, 0], agg)
    gt = twolevel.two_level_apply_batched({k: t64(v) for k, v in pc["knp"].items()},
                                          t64(bK)[:, 0].contiguous(), agg)
    assert rel(gt(t64(R)), gj(jnp.asarray(R))) < TOL


def test_cell_two_level_applies_into_buffers_match(setup):
    """The cell layout's applies as the step makes them (on the card the
    block-Jacobi apply folded into K6's prolong-add and K7's one-launch
    apply): the inverse into a buffer, the KNP one from the slot-0 view of
    the operator in place, every apply into one output (buffer=True); two
    consecutive applies each against the JAX package's to 1e-12, the
    second overwriting the first."""
    pc = setup["pc"]
    agg = setup["spt"].agg_size
    rng = np.random.default_rng(12)
    Pd, bK = setup["Pd"], setup["blocksK"]
    fj = jtl.two_level_apply_fn(pc["emi"], Pd, agg)
    gj = jtl.two_level_apply_batched(pc["knp"], bK[:, 0], agg)
    view = t64(bK)[:, 0]
    assert not view.is_contiguous()
    ft = twolevel.two_level_apply_fn({k: t64(v) for k, v in pc["emi"].items()}, t64(Pd), agg,
                                     buffer=True, inv_out=torch.zeros(Pd.shape,
                                                                      dtype=torch.float64))
    gt = twolevel.two_level_apply_batched({k: t64(v) for k, v in pc["knp"].items()}, view, agg,
                                          buffer=True, inv_out=torch.empty(view.shape,
                                                                           dtype=torch.float64))
    for f_t, f_j, shape in ((ft, fj, Pd.shape[1:]), (gt, gj, (bK.shape[0],) + Pd.shape[1:])):
        outs = []
        for _ in range(2):
            r = rng.standard_normal(shape)
            z = f_t(t64(r))
            assert rel(z, f_j(jnp.asarray(r))) < 1e-12
            outs.append(z)
        assert outs[0] is outs[1]


def test_moment_vectors_match(setup):
    Sj, St, spt = setup["Sj"], setup["St"], setup["spt"]
    assert rel(St._emi_moment_W(spt), Sj._emi_moment_W(setup["spj"])) < 1e-14


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_equilibration_floor_keeps_dead_entries_finite(dtype):
    d = np.array([0.0, 1e-11, 3e-11, 0.0], dtype=dtype)
    got = twolevel._equilibration_scale(torch.as_tensor(d))
    ref = jtl._equilibration_scale(jnp.asarray(d))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_unported_coarse_options_raise(setup):
    """The coarse_ridge NaN-fallback ladder (ridge < 1e-5) stays unported;
    above max_dense the build is three-level (d1inv), no longer refused."""
    St = setup["St"]
    blocks = t64(setup["blocks"])
    three = twolevel.build_two_level(blocks, St.g["nbr"], 64, sym=True, max_dense=16)
    assert three["d1inv"].shape == (St.n_cells // 64 + (St.n_cells % 64 > 0),)
    assert three["inv"].shape[0] <= 16
    with pytest.raises(NotImplementedError):
        twolevel.build_two_level(blocks, St.g["nbr"], 64, sym=True, ridge=1e-7)
