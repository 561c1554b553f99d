"""Rat neuron morphology simulation (the port of examples/run_rat_neuron.py)
on the JAX app's fallback morphology: a procedural ~108 um bifurcating
neuron (soma + trunk + two branches, mesh.generators.bifurcating_neuron).
The real 228-16MG.CNG morphology is not in the repository, nor is the
mesh reader it needs ported.

* membrane facets from cell-tag disagreement between neighbour cells,
* the membrane split by position into soma/dendrite (tag 2, HH-SI without
  stimulus) and distal processes (tag 1, the passive LeakSI),
* the synaptic stimulus g_syn = 200 S/m^2 at the distal branch tips.

main() takes the JAX app's SolverParams but writes no field or stats
files: H5 output is not ported.

    python -m knpemidg_tpu_torch.apps.run_rat_neuron  (on the card)
"""
from ..config import StimParams
from ..mesh.generators import bifurcating_neuron
from ..models.hh import HodgkinHuxleySI
from ..models.leak import LeakSI
from ..solver import StandardSolver
from .run_2D import si_physics, solver_params as _solver_params


def build_solver(resolution=0, dt=1.0e-4, dtype=None, g_syn=200.0, device="cuda"):
    params, ion_list = si_physics(dt)
    # synaptic input at the distal branch tips (0.14 * length)
    stim_params = StimParams(
        stimulus={"stim_amplitude": g_syn},
        stimulus_locator=lambda x: x[1] < 15.0e-6, g_syn_bar=g_syn,
    )
    S = StandardSolver(params, ion_list, dtype=dtype, device=device)
    S.setup_domain(bifurcating_neuron(resolution), quad_degree=2)
    S.setup_parameters()
    S.setup_FEM_spaces()
    S.setup_membrane_model(stim_params, {
        1: LeakSI(),
        2: HodgkinHuxleySI(stimulus=False),
    })
    return S


def solver_params(**overrides):
    """The JAX app's SolverParams."""
    return _solver_params(**overrides)


def main(Tstop=1.0e-2, device="cuda"):
    S = build_solver(device=device)
    state = S.solve_system_active(Tstop, 0.0, solver_params())
    return S, state


if __name__ == "__main__":
    main()
