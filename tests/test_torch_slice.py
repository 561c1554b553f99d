"""The whole splitting step of the port against the JAX package in
float64: two steps of the EMIx-style setup (emi_ritz=0; the Ritz runs are
in test_torch_ritz.py) and of the 2D
neuron, with equal Krylov counts and matching fields; plus the package
rules (no jax import, unsupported options raise) and the state exchange."""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import test_torch_parity as tp
from test_torch_parity import rel

import knpemidg_tpu_torch as kt
from knpemidg_tpu_torch import emix
from knpemidg_tpu_torch import solver as tsolver
from knpemidg_tpu_torch.ops import assembly as tassembly
from knpemidg_tpu_torch.ops import coarse as tcoarse
from knpemidg_tpu_torch.ops import krylov_ops as tkrylov_ops
from knpemidg_tpu_torch.solvers import twolevel as ttwolevel

TOL = 1e-8
FIELDS = ("phi", "c", "c_elim", "phi_M")


def _run_both(make_jax, make_torch, Tstop):
    Sj, spj = make_jax()
    St, spt = make_torch()
    sj = Sj.solve_system_active(Tstop, 0.0, spj)
    st = St.solve_system_active(Tstop, 0.0, spt)
    return Sj, sj, St, st


@pytest.fixture(scope="module")
def emix_run():
    return _run_both(tp.emix_jax, tp.emix_torch, 0.2)


def test_emix_two_steps_match_jax(emix_run):
    Sj, sj, St, st = emix_run
    assert Sj.stats.emi_niters == St.stats.emi_niters == [7, 4]
    assert Sj.stats.knp_niters == St.stats.knp_niters == [[4, 3], [2, 2]]
    for key in FIELDS:
        assert rel(st[key], sj[key]) < TOL, key
    assert abs(float(st["t"]) - float(sj["t"])) < 1e-12


@pytest.mark.parametrize("refresh", [0, 1])
def test_neuron_2d_two_steps_match_jax(refresh):
    """refresh=1 rebuilds the frozen preconditioner before the second step
    (pc_refresh_every)."""
    def with_refresh(make):
        def made():
            S, sp = make()
            return S, dataclasses.replace(sp, pc_refresh_every=refresh)
        return made

    Sj, sj, St, st = _run_both(with_refresh(tp.neuron_2d_jax),
                               with_refresh(tp.neuron_2d_torch), 2e-4)
    assert Sj.stats.emi_niters == St.stats.emi_niters
    assert Sj.stats.knp_niters == St.stats.knp_niters
    for key in FIELDS:
        assert rel(st[key], sj[key]) < TOL, key


def test_run_block_matches_solve_system_active(emix_run):
    """run_block (no first-step special case) gives the same two steps:
    the phi_M seed equals each model's resting V."""
    _, _, St, st = emix_run
    S2, sp = tp.emix_torch()
    state0 = S2.attach_pc(S2._initial_state(0.0), sp)
    out, stats = S2.run_block(state0, sp, 2)
    assert stats["emi_iters"] == St.stats.emi_niters
    assert stats["knp_iters"] == St.stats.knp_niters
    assert all(stats["emi_converged"]) and all(stats["knp_converged"])
    for key in FIELDS:
        assert rel(out[key], st[key]) < 1e-12, key


def test_state_numpy_round_trip(emix_run):
    _, _, St, st = emix_run
    st_np = kt.state_to_numpy(st)
    back = kt.state_from_numpy(st_np, "cpu", torch.float64)
    for key in ("c", "c_elim", "phi", "phi_prev", "phi_M", "I_ch", "t"):
        assert torch.equal(back[key], st[key]), key
    for tag, mm in st["mem"].items():
        assert torch.equal(back["mem"][tag].states, mm.states)
        assert back["mem"][tag].model is mm.model
    for part in st["pc"]:
        for k, v in st["pc"][part].items():
            assert torch.equal(back["pc"][part][k], v)


@pytest.mark.parametrize("override", [
    {"knp_ritz": 8}, {"gmres_orth": "mgs"}, {"knp_solver": "cg"},
    {"gmres_rot": "carry"}, {"emi_moment_blocked": True},
    {"pair_bj": "none"}, {"pc_refresh_factor": 2.0}, {"precond": "two_level_mult"},
    {"coarse_ridge": 1e-7},
])
def test_unsupported_solver_options_raise(override):
    S, _ = tp.neuron_2d_torch()
    kw = tp.solver_params_kw()
    kw.update(override)
    with pytest.raises(NotImplementedError):
        S.solve_system_active(2e-4, 0.0, kt.SolverParams(**kw))


def test_unsupported_setups_raise():
    S, _ = tp.neuron_2d_torch()
    with pytest.raises(NotImplementedError):
        S.enable_pair_layout(interleave=False)
    with pytest.raises(NotImplementedError):
        kt.StandardSolver(S.params, S.ion_list, degree_emi=2)
    with pytest.raises(NotImplementedError):
        S.solve_system_active(2e-4, 0.0, kt.SolverParams(**tp.solver_params_kw()),
                              filename="out/", save_fields=True)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device argument the solver runs on the CUDA card, and
    raises (never falls back to the CPU) when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = tp.emix_mesh_torch()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        emix.build_solver(mesh)
    S = emix.build_solver(mesh, device="cpu")
    assert S.device.type == "cpu"
    assert S.g["vol"].device.type == S.D.device.type == "cpu"
    assert all(mm.states.device.type == "cpu" for mm in S.mem_models.values())


def test_port_imports_no_jax():
    code = ("import sys; import knpemidg_tpu_torch, knpemidg_tpu_torch.emix, "
            "knpemidg_tpu_torch._cuda, knpemidg_tpu_torch.ops.pairs, "
            "knpemidg_tpu_torch.ops.coarse, knpemidg_tpu_torch.solvers.twolevel, "
            "knpemidg_tpu_torch.parallel.sharding, "
            "knpemidg_tpu_torch.profile_step, knpemidg_tpu_torch.probes, "
            "knpemidg_tpu_torch.ops.krylov_ops; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'knpemidg_tpu' or m.startswith('knpemidg_tpu.')]; "
            "assert not bad, bad")
    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


COARSE_WRAPPERS = {"restrict", "solve", "prolong_add"}
ASSEMBLY_WRAPPERS = {"emi_cell", "emi_facet", "emi_emit_cell", "alpha_sum", "knp_cell",
                     "knp_facet", "knp_membrane_emit", "membrane_traces_m",
                     "jump_phi_M_m", "eliminated_concentration"}
CELL_WRAPPERS = {"bell_matvec", "bell_matvec_multi", "block_jacobi_inverse",
                 "block_jacobi_apply"} | COARSE_WRAPPERS | ASSEMBLY_WRAPPERS
KRYLOV_WRAPPERS = {"pcg_dot", "pcg_update", "pcg_dot2_direction", "gmres_start",
                   "gmres_cgs_dot", "gmres_arnoldi", "gmres_solve_update"}
CELL_WRAPPERS |= KRYLOV_WRAPPERS
PAIR_WRAPPERS = {"pair_matvec", "pair_matvec_multi", "to_pair", "from_pair",
                 "gather_blocks_pair", "gather_blocks_pair_multi",
                 "block_jacobi_inverse", "block_jacobi_apply"} | COARSE_WRAPPERS \
    | ASSEMBLY_WRAPPERS | KRYLOV_WRAPPERS


def _tensors(a):
    """The tensors in an argument, through tuples (the coarse operands and
    their workspace) and lists (to_pair's sources)."""
    if isinstance(a, torch.Tensor):
        yield a
    elif isinstance(a, (tuple, list)):
        for b in a:
            yield from _tensors(b)


@pytest.mark.parametrize("pair", [False, True])
def test_kernel_inputs_are_contiguous_on_main_path(monkeypatch, pair):
    """The CUDA wrappers raise on non-contiguous tensors; on the CPU the
    same wrappers take anything, so check here that the main path (cell or
    pair layout, with Ritz deflation) hands every kernel wrapper contiguous
    tensors of the working dtype.  The block-Jacobi inverse reads its
    diagonal blocks in place: each system's blocks cells-last and
    contiguous (slot 0 of the KNP operator, whose systems lie apart)."""
    calls = []

    def strict(fn):
        def wrapped(*args, **kw):
            for i, a in enumerate(list(args) + list(kw.values())):
                for t in _tensors(a):
                    if fn.__name__ == "block_jacobi_inverse" and i == 0:
                        nd, nc = t.shape[-2:]
                        assert t.stride()[-3:] == (nd * nc, nc, 1), fn.__name__
                    else:
                        assert t.is_contiguous(), fn.__name__
                    assert t.dtype in (torch.float64, torch.int32), fn.__name__
            calls.append(fn.__name__)
            return fn(*args, **kw)
        return wrapped

    for mod in (tsolver, ttwolevel, tassembly, tcoarse, tkrylov_ops):
        for name in CELL_WRAPPERS | PAIR_WRAPPERS:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, strict(getattr(mod, name)))
    S, sp = tp.neuron_2d_torch(emi_ritz=8)
    if pair:
        S.enable_pair_layout()
    st = S.solve_system_active(2e-4, 0.0, sp)
    assert "ritz_W" in st["pc"]["emi"]
    assert (PAIR_WRAPPERS if pair else CELL_WRAPPERS) <= set(calls)
