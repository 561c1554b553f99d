"""Picard steps of the port (Solver.solve_for_time_step_picard and
solve_system_passive(picard=True)) against the JAX package in float64 on
the CPU: the MMS problem at mms_square(2) with direct solves, the
iterative inner solves against the direct ones, and one Picard step of
the 2D neuron on the iterative main path."""
import numpy as np
import pytest
import torch

import test_torch_parity as tp
from test_torch_parity import rel
from test_torch_mms import DIRECT, DT_SPACE, build, mean_shifted

from knpemidg_tpu import config as jcfg
from knpemidg_tpu_torch import config as tcfg

# tests/test_picard.py's iterative inner solves
ITERATIVE = dict(direct_emi=False, direct_knp=False, rtol_emi=1e-13, atol_emi=0.0,
                 rtol_knp=1e-12, atol_knp=0.0, max_it_emi=50000, max_it_knp=5000,
                 gmres_restart=40)


def _picard(pkg, sp_kw, tol=1e-8, **kw):
    S, _ = build(pkg, 2, DT_SPACE)
    S.splitting_scheme = False
    cfg = jcfg if pkg == "jax" else tcfg
    st, stats, it = S.solve_for_time_step_picard(S._initial_state(0.0),
                                                 cfg.SolverParams(**sp_kw), tol=tol, **kw)
    return S, st, stats, it


@pytest.fixture(scope="module")
def direct_pair():
    return _picard("jax", DIRECT), _picard("torch", DIRECT)


def test_picard_direct_matches_jax(direct_pair):
    """The direct Picard step at res 2 (tol 1e-8): the same iterations as
    the JAX package's, c and c_elim to rel 1e-10 (as the direct step in
    test_torch_mms.py), the mean-shifted phi to 1e-7, t advanced by dt."""
    (_, sj, _, itj), (St, st, stats, itt) = direct_pair
    assert itt == itj and itt >= 2
    assert rel(st["c"], sj["c"]) < 1e-10
    assert rel(st["c_elim"], sj["c_elim"]) < 1e-10
    assert rel(mean_shifted(st["phi"]), mean_shifted(sj["phi"])) < 1e-7
    assert float(st["t"]) == pytest.approx(DT_SPACE)
    assert stats["emi_iters"] == 0 and stats["knp_iters"] == [0, 0]


def test_picard_iterative_matches_direct(direct_pair):
    """The Picard step with the iterative inner solves (tests/test_picard.py's
    parameters) reaches the direct Picard step's fixed point: c to 1e-8,
    the mean-shifted phi to 1e-4."""
    _, (_, sd, _, _) = direct_pair
    _, si, stats, it = _picard("torch", ITERATIVE)
    assert it >= 1 and stats["emi_iters"] > 0
    assert float(np.abs(tp.to_np(si["c"]) - tp.to_np(sd["c"])).max()) < 1e-8
    assert float(np.abs(mean_shifted(si["phi"]) - mean_shifted(sd["phi"])).max()) < 1e-4


def test_passive_picard_loop_matches_jax(direct_pair):
    """solve_system_passive(picard=True), two Picard steps with direct
    solves, against the JAX package's loop (on the fixture's solver, whose
    jitted assemblies are cached): c to rel 1e-10; each step recorded with
    a zero wall."""
    (Sj, _, _, _), _ = direct_pair
    St, _ = build("torch", 2, DT_SPACE)
    sj = Sj.solve_system_passive(2 * DT_SPACE, 0.0, jcfg.SolverParams(**DIRECT), picard=True)
    st = St.solve_system_passive(2 * DT_SPACE, 0.0, tcfg.SolverParams(**DIRECT), picard=True)
    assert rel(st["c"], sj["c"]) < 1e-10
    assert rel(st["c_elim"], sj["c_elim"]) < 1e-10
    assert St.stats.step_walls == [0.0, 0.0]
    assert St.stats.emi_niters == Sj.stats.emi_niters[-2:] == [0, 0]


def test_picard_raises_at_max_iter():
    """max_iter reached before the change of c drops below tol raises
    RuntimeError, as the JAX package's Picard step does."""
    with pytest.raises(RuntimeError, match="max iterations"):
        _picard("torch", DIRECT, tol=1e-30, max_iter=1)


def test_neuron_2d_picard_step_matches_jax():
    """One Picard step of the 2D neuron on the iterative main path (the
    batched GMRES KNP solve with the frozen time level c_n): the same
    Picard iterations and Krylov counts of the last inner step as the JAX
    package's, fields to rel 1e-8, t advanced by dt."""
    Sj, spj = tp.neuron_2d_jax()
    St, spt = tp.neuron_2d_torch()
    sj, statj, itj = Sj.solve_for_time_step_picard(Sj.attach_pc(Sj._initial_state(0.0), spj),
                                                   spj)
    st, statt, itt = St.solve_for_time_step_picard(St.attach_pc(St._initial_state(0.0), spt),
                                                   spt)
    assert itt == itj and itt >= 2
    assert statt["emi_iters"] == int(statj["emi_iters"])
    assert statt["knp_iters"] == np.asarray(statj["knp_iters"]).tolist()
    for key in ("phi", "c", "c_elim", "phi_M"):
        assert rel(st[key], sj[key]) < 1e-8, key
    assert float(st["t"]) == pytest.approx(St.params.dt)
    assert torch.equal(St.c_init, St._initial_state(0.0)["c"])
