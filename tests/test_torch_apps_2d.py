"""Two steps of the port's 2D app (knpemidg_tpu_torch.apps.run_2D) against
the JAX package's examples/run_2D.py in float64 on the CPU: the Krylov
counts and the fields."""
import jax.numpy as jnp
import torch

import test_torch_parity as tp

from knpemidg_tpu_torch.apps import run_2D

F64 = torch.float64
FIELD_TOL = 1e-10


def test_run_2d_two_steps_match_jax():
    """Two steps of the 2D app at the JAX app's SolverParams (AUTO Ritz
    deflation): equal float64 Krylov counts, fields to rel 1e-10."""
    from run_2D import build_solver
    from knpemidg_tpu.config import SolverParams

    Sj = build_solver(resolution=0, dtype=jnp.float64)
    sj = Sj.solve_system_active(2 * Sj.params.dt, 0.0, SolverParams(
        direct_emi=False, direct_knp=False, rtol_emi=1e-5, atol_emi=1e-40,
        rtol_knp=1e-7, atol_knp=1e-40, resolution=0))
    St = run_2D.build_solver(resolution=0, dtype=F64, device="cpu")
    st = St.solve_system_active(2 * St.params.dt, 0.0,
                                run_2D.solver_params(0, verbose=False))
    assert St.stats.emi_niters == Sj.stats.emi_niters
    assert St.stats.knp_niters == [list(map(int, k)) for k in Sj.stats.knp_niters]
    for key in ("phi", "c", "c_elim", "phi_M", "I_ch"):
        assert tp.rel(st[key], sj[key]) < FIELD_TOL, key
    (mj,), (mt,) = sj["mem"].values(), st["mem"].values()
    assert tp.rel(mt.states, mj.states) < FIELD_TOL
