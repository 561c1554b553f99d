"""EMI-only solver (torch port of knpemidg_tpu/solver_emi.py).

The structure of :class:`knpemidg_tpu_torch.solver.Solver`, but only the
potential is solved: the concentrations stay at their initial values, so a
step is ODE -> EMI solve -> phi_M update.  The Nernst potentials and the
membrane traces of K_e / Na_i come from the frozen concentration fields.

A Picard step (the inherited solve_for_time_step_picard) is one EMI solve
and phi_M update: with frozen concentrations the change of c is zero after
the first inner step.  The step runs the EMI kernels of the main path (the
assembly, the two-level apply, PCG and the jump); no KNP kernel.
"""
from __future__ import annotations

import numpy as np

from .config import SolverParams
from .solver import Solver, Traces
from .solvers.direct import solve_direct


class SolverEMI(Solver):
    _emi_only = True          # attach_pc builds no KNP static operator or pc

    def _pde_step(self, state, solver_params: SolverParams, c_n=None,
                  advance_time: bool = True):
        """One EMI step: the assembly into the step's emit buffers, then PCG
        (or the host direct solve with ``direct_emi``, cell layout), then
        the jump.  ``c_n`` / ``advance_time`` as in Solver._pde_step, so the
        inherited Picard step works; the concentrations are frozen, so
        ``c_n`` is unused.  The KNP counts are zeros."""
        sp_ = solver_params
        pads = self._pads(state)
        stats = {}
        if sp_.direct_emi:
            if self.pair_layout:
                raise NotImplementedError("direct solves on the pair layout are not ported")
            phi_M_pad, _, I_ch_tot_pad = pads
            blocks, rhs, _ = self._assemble_emi(state["c"], state["c_elim"], phi_M_pad,
                                                I_ch_tot_pad, state["t"])
            phi = self._tensor(solve_direct(blocks, self.g["nbr"], rhs,
                                            nullspace_constant=True)).contiguous()
            stats["emi_iters"], stats["emi_converged"] = 0, True
        else:
            pc = state.get("pc")
            blocks, rhs, Pd = self._emi_assemble_step(state, pads)
            phi, stats["emi_iters"], stats["emi_converged"] = self._emi_solve_iterative(
                blocks, Pd, rhs, state["phi"], sp_, pc=pc.get("emi") if pc else None,
                phi_prev=state.get("phi_prev"), step=True)
        stats["knp_iters"] = [0] * self.N_ions
        stats["knp_converged"] = True
        return self._finalize_step(state, stats, state["c"], phi, state["t"],
                                   advance_time)

    def _phi_M_function(self):
        """phi_M of a function-type init: a callable is evaluated at the
        membrane facets' midpoints, values are taken as they are."""
        f = self.params.phi_M_init
        if callable(f):
            return self._tensor(np.asarray([f(x) for x in self.tables.midpoints]))
        return super()._phi_M_function()


class StandardSolverEMI(SolverEMI):
    """The K_e / Na_i trace pushes of the reference EMI-only loop; ion
    order [K, *, Na eliminated]."""

    def update_ode(self, tag, traces: Traces):
        return {
            "K_e": traces.plus(0),
            "Na_i": traces.minus(len(self.ion_list) - 1),
        }
