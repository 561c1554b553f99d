"""The port's EMI-only solver (SolverEMI / StandardSolverEMI) and its
solver-stats files against the JAX package in float64 on the CPU:
tests/test_solver_emi.py's 2D neuron, the Picard step, the stats files of
the EMI-only and of the full solver, the skipped KNP build and the
function-type phi_M init."""
import os

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_parity as tp
from test_torch_parity import rel
from test_solver_emi import build_emi_solver

from knpemidg_tpu.config import SolverParams as JSolverParams
import knpemidg_tpu_torch as kt

EMI_KW = dict(direct_emi=False, direct_knp=False, rtol_emi=1e-5, atol_emi=1e-40)


@pytest.fixture(scope="module")
def jax_emi():
    """The JAX package's EMI-only solver of tests/test_solver_emi.py, built
    once for this file's protocols (its jitted steps compile once); each
    protocol starts it from a new stats record (_fresh)."""
    return build_emi_solver()


def _fresh(S):
    """S with its stats record reset, as a new solver's: a protocol's
    counts and stats files are its own."""
    S.stats.__init__()
    return S


def test_emi_only_three_steps_match_jax(jax_emi):
    """Three steps of the EMI-only solver: the EMI counts equal the JAX
    package's, phi_M and phi to rel 1e-10, c unchanged bit for bit, the
    KNP counts zero."""
    Sj, St = _fresh(jax_emi), chip_smoke.emi_2d_solver(device="cpu")
    sj = Sj.solve_system_active(3 * Sj.params.dt, 0.0, JSolverParams(**EMI_KW))
    st = St.solve_system_active(3 * St.params.dt, 0.0, kt.SolverParams(**EMI_KW))
    assert St.stats.emi_niters == Sj.stats.emi_niters
    assert all(n > 0 for n in St.stats.emi_niters)
    assert St.stats.knp_niters == [[0, 0]] * 3
    assert rel(st["phi_M"], sj["phi_M"]) < 1e-10
    assert rel(st["phi"], sj["phi"]) < 1e-10
    assert torch.equal(st["c"], St.c_init) and torch.equal(st["c_elim"], St.c_elim_init)
    assert float(st["t"]) == pytest.approx(float(sj["t"]))


def test_emi_only_builds_no_knp():
    """attach_pc of the EMI-only solver builds the EMI preconditioner and
    no KNP static operator or KNP preconditioner."""
    S = chip_smoke.emi_2d_solver(device="cpu")
    sp = kt.SolverParams(**EMI_KW)
    state = S.attach_pc(S._initial_state(0.0), sp)
    assert sorted(state["pc"]) == ["emi"]
    assert not getattr(S, "_knp_static_blocks", {})


def test_emi_only_picard_is_one_iteration():
    """With frozen concentrations the Picard step is one inner EMI step:
    one iteration, phi and phi_M equal to the plain EMI step's to 1e-12, t
    advanced by dt, c unchanged."""
    sp = kt.SolverParams(**dict(EMI_KW, rtol_emi=1e-10))
    S = chip_smoke.emi_2d_solver(device="cpu")
    st_pic, stats, iters = S.solve_for_time_step_picard(S._initial_state(0.0), sp)
    assert iters == 1
    assert stats["emi_iters"] > 0 and stats["emi_converged"]
    S2 = chip_smoke.emi_2d_solver(device="cpu")
    st_plain, _ = S2._pde_step(S2.attach_pc(S2._initial_state(0.0), sp), sp)
    assert float(torch.max(torch.abs(st_pic["phi"] - st_plain["phi"]))) < 1e-12
    assert float(torch.max(torch.abs(st_pic["phi_M"] - st_plain["phi_M"]))) < 1e-12
    assert float(st_pic["t"]) == pytest.approx(float(st_plain["t"]))
    assert torch.equal(st_pic["c"], S.c_init)


def _stats_files(path):
    """{file name: its lines} of a stats directory."""
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name)) as f:
            out[name] = f.read().splitlines()
    return out


def _check_stats_match(Sj, St, dj, dt_, phases):
    fj, ft = _stats_files(dj), _stats_files(dt_)
    assert sorted(ft) == sorted(fj)
    for name in fj:
        assert ft[name][:2] == fj[name][:2], name          # num cells, dofs
        assert len(ft[name]) == len(fj[name]), name
        if "niter" in name:
            assert ft[name] == fj[name], name
    for rec in St.stats.phase_records:
        assert sorted(rec) == sorted(phases)
        assert all(v > 0.0 for v in rec.values())


def test_emi_only_stats_files_match_jax(tmp_path, jax_emi):
    """save_solver_stats on the EMI-only solver: the phased step times the
    EMI phases only; the stats files' names, header lines and line counts
    equal the JAX package's, the iteration files line for line."""
    Sj, St = _fresh(jax_emi), chip_smoke.emi_2d_solver(device="cpu")
    dj, dt_ = str(tmp_path / "jax") + "/", str(tmp_path / "torch") + "/"
    Sj.solve_system_active(3 * Sj.params.dt, 0.0, JSolverParams(**EMI_KW), filename=dj,
                           save_solver_stats=True)
    St.solve_system_active(3 * St.params.dt, 0.0, kt.SolverParams(**EMI_KW), filename=dt_,
                           save_solver_stats=True)
    _check_stats_match(Sj, St, dj + "solver", dt_ + "solver", ("emi_assem", "emi_solve"))
    assert St.stats.emi_niters == Sj.stats.emi_niters


def test_solver_stats_files_match_jax(tmp_path):
    """save_solver_stats on the full solver (2D neuron, two steps): the four
    timed phases, the stats files as the JAX package writes them, and the
    phased step's Krylov counts equal to the JAX package's phased step's
    (whose EMI solve starts without the linear predictor)."""
    (Sj, spj), (St, spt) = tp.neuron_2d_jax(), tp.neuron_2d_torch()
    dj, dt_ = str(tmp_path / "jax") + "/", str(tmp_path / "torch") + "/"
    Sj.solve_system_active(2e-4, 0.0, spj, filename=dj, save_solver_stats=True)
    St.solve_system_active(2e-4, 0.0, spt, filename=dt_, save_solver_stats=True)
    _check_stats_match(Sj, St, dj + "solver", dt_ + "solver",
                       ("emi_assem", "emi_solve", "knp_assem", "knp_solve"))
    assert St.stats.emi_niters == Sj.stats.emi_niters
    assert St.stats.knp_niters == Sj.stats.knp_niters


def test_emi_only_function_phi_M_init():
    """A callable function-type phi_M init is evaluated at the membrane
    facets' midpoints; an array is taken as it is."""
    f = lambda x: -0.07 + 1e-3 * x[0] / 1e-5
    S = chip_smoke.emi_2d_solver(device="cpu")
    S.params.phi_M_init_type, S.params.phi_M_init = "function", f
    want = np.asarray([f(x) for x in S.tables.midpoints])
    assert np.array_equal(S._initial_state(0.0)["phi_M"].numpy(), want)
    S.params.phi_M_init = want * 2.0
    assert np.array_equal(S._initial_state(0.0)["phi_M"].numpy(), want * 2.0)
