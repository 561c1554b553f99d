"""Idealized 2D geometry with a Hodgkin-Huxley membrane (the port of
examples/run_2D.py).

A 62 x 4 um box with one embedded rectangular "neuron" (cells tagged 1), SI
units, three ion species (K, Cl, Na; Na eliminated), the HH-SI membrane on
facet tag 1 with an exponentially decaying periodic synaptic stimulus on
x < 20 um.  main() takes the JAX app's SolverParams but writes no field or
stats files: H5 output is not ported.

    python -m knpemidg_tpu_torch.apps.run_2D          (on the card)
"""
from ..config import Ion, PhysicalParams, SolverParams, StimParams
from ..mesh.generators import box_2d_neuron
from ..models.hh import HodgkinHuxleySI
from ..solver import StandardSolver

# initial concentrations (mol/m^3 = mM) of the idealized geometries
NA_I, NA_E = 12.838513108648856, 100.71925900027354
K_I, K_E = 124.15397583491901, 3.3236967382705265
D_NA, D_K, D_CL = 1.33e-9, 1.96e-9, 2.03e-9       # m^2/s
V_REST = -0.07438609374462003                     # V


def si_physics(dt, n_subdomains=2):
    """PhysicalParams and the ion list [K, Cl, Na] (Na eliminated) of the
    idealized-geometry apps (SI units), shared by run_2D, run_3D and
    run_rat_neuron."""
    params = PhysicalParams(
        dt=dt,
        n_steps_ODE=25,
        C_M=0.02,                  # F/m^2
        temperature=300.0,         # K
        F=96485.0,                 # C/mol
        R=8.314,                   # J/(K mol)
        phi_M_init=V_REST,
        phi_M_init_type="constant",
        rho_sub={k: 0.0 for k in range(n_subdomains)},
    )
    ion_list = [
        Ion(name="K", z=1.0, D_sub={0: D_K, 1: D_K},
            c_init_sub={0: K_E, 1: K_I}, c_init_sub_type="constant"),
        Ion(name="Cl", z=-1.0, D_sub={0: D_CL, 1: D_CL},
            c_init_sub={0: NA_E + K_E, 1: NA_I + K_I}, c_init_sub_type="constant"),
        Ion(name="Na", z=1.0, D_sub={0: D_NA, 1: D_NA},
            c_init_sub={0: NA_E, 1: NA_I}, c_init_sub_type="constant"),
    ]
    return params, ion_list


def build_solver(resolution=0, dt=1.0e-4, dtype=None, device="cuda"):
    params, ion_list = si_physics(dt)
    g_syn_bar = 10.0
    stim_params = StimParams(
        stimulus={"stim_amplitude": g_syn_bar},
        stimulus_locator=lambda x: x[0] < 20e-6,
        g_syn_bar=g_syn_bar,
    )
    S = StandardSolver(params, ion_list, dtype=dtype, device=device)
    S.setup_domain(box_2d_neuron(resolution))
    S.setup_parameters()
    S.setup_FEM_spaces()
    S.setup_membrane_model(stim_params, {1: HodgkinHuxleySI(stimulus=True)})
    return S


def solver_params(resolution=0, **overrides):
    """The JAX app's SolverParams (iterative solves at the reference
    tolerances)."""
    kw = dict(direct_emi=False, direct_knp=False,
              rtol_emi=1e-5, atol_emi=1e-40,
              rtol_knp=1e-7, atol_knp=1e-40,
              resolution=resolution, verbose=True)
    kw.update(overrides)
    return SolverParams(**kw)


def main(resolution=0, Tstop=2.0e-2, device="cuda"):
    S = build_solver(resolution, device=device)
    state = S.solve_system_active(Tstop, 0.0, solver_params(resolution))
    return S, state


if __name__ == "__main__":
    main()
