"""The EMIx brain-tissue setup (examples/run_EMIx_simulation.py of the JAX
package) on the port: glial Kir membranes on tag 1, Hodgkin-Huxley neuron
membranes on tag 2, mm/cm units (mC, mK, cm^2/ms), dt = 0.1 ms."""
from __future__ import annotations

from .config import Ion, PhysicalParams, SolverParams, StimParams
from .models.glial import GlialKir
from .models.hh import HodgkinHuxleyMV
from .solver import StandardSolver


def build_solver(mesh, dtype=None, device="cuda", dt=0.1, pair=False):
    """StandardSolver on ``mesh`` (coordinates in cm) with the EMIx physics,
    ions, stimulus and membrane models, set up through setup_membrane_model,
    on the CUDA card unless ``device`` names another.  ``pair=True``
    switches to the interleaved pair layout (enable_pair_layout), the
    layout of the JAX package's benchmark."""
    params = PhysicalParams(
        dt=dt,                      # ms
        n_steps_ODE=25,
        C_M=2.0,                    # uF/cm^2
        temperature=300e3,          # mK
        F=96485e3,                  # mC/mol
        R=8.314e3,                  # mJ/(K mol)
        phi_M_init=0.0,             # taken from the ODE initial states
        phi_M_init_type="constant",
        rho_sub={0: 0.0, 1: 0.0, 2: 0.0},
    )

    # calibrated initial concentrations
    K_e, K_n, K_g = 3.3236967382613933, 124.15397583492471, 102.75563828644862
    Na_e, Na_n, Na_g = 100.71925900028181, 12.838513108606818, 12.39731187972181
    Cl_e, Cl_n, Cl_g = Na_e + K_e, Na_n + K_n, Na_g + K_g

    D_Na, D_K, D_Cl = 1.33e-8, 1.96e-8, 2.03e-8     # cm^2/ms

    ion_list = [
        Ion(name="K", z=1.0, D_sub={0: D_K, 1: D_K, 2: D_K},
            c_init_sub={0: K_e, 1: K_g, 2: K_n}),
        Ion(name="Cl", z=-1.0, D_sub={0: D_Cl, 1: D_Cl, 2: D_Cl},
            c_init_sub={0: Cl_e, 1: Cl_g, 2: Cl_n}),
        Ion(name="Na", z=1.0, D_sub={0: D_Na, 1: D_Na, 2: D_Na},
            c_init_sub={0: Na_e, 1: Na_g, 2: Na_n}),
    ]

    g_syn_bar = 5.0                 # mS/cm^2
    stim_params = StimParams(
        stimulus={"stim_amplitude": g_syn_bar},
        stimulus_locator=lambda x: x[0] < 3.0e-4,   # cm
        g_syn_bar=g_syn_bar,
    )

    S = StandardSolver(params, ion_list, dtype=dtype, device=device)
    S.setup_domain(mesh, quad_degree=2)
    S.setup_parameters()
    S.setup_FEM_spaces()
    # the initial phi_M comes from each membrane model's resting state
    S.setup_membrane_model(
        stim_params, {1: GlialKir(), 2: HodgkinHuxleyMV(stimulus=True)}
    )
    if pair:
        S.enable_pair_layout()
    return S


def solver_params(**overrides):
    """The benchmark's SolverParams (bench.py of the JAX package): the
    production tolerances, every other option at its default (emi_ritz
    AUTO: 24 Ritz fields on the cell layout, none on the pair layout)."""
    kw = dict(
        direct_emi=False, direct_knp=False,
        rtol_emi=1e-5, atol_emi=1e-40,
        rtol_knp=1e-7, atol_knp=2e-40,
        max_it_emi=1000, max_it_knp=1000, gmres_restart=30, agg_size=64,
    )
    kw.update(overrides)
    return SolverParams(**kw)
