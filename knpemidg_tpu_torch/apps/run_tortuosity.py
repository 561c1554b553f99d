"""Local astrocyte depolarization with tortuosity (the port of
examples/run_tortuosity.py).

* per-subdomain diffusion scaled by tortuosity 1/lambda^2,
* immobile background charge rho per subdomain from the calibrated
  electroneutrality defect,
* a volumetric ion source/sink: a space-time indicator injecting K+ and
  removing Na+ inside an ROI box during [0.2, t_syn] ms (Ion.f_source),
* the astro membrane models (HodgkinHuxleyAstro on the neuron, GlialKirAstro
  with its Cl leak and Michaelis pump on the glia), ion order [K, Na, Cl]
  so Na_i is taken from ion 1.

``mesh`` is required (subdomains 0 ECS, 1 neuron, 2 glial; membrane tags 1
neuron, 2 glial, 3 a second neuron): the EMIx volume mesh the JAX app
loads by default is not in the repository.  main() takes the JAX app's
SolverParams but writes no field or stats files: H5 output is not ported.
"""
import numpy as np

from ..config import Ion, PhysicalParams, SolverParams, StimParams
from ..models.glial import GlialKirAstro
from ..models.hh import HodgkinHuxleyAstro
from ..solver import Solver, Traces


class AstroSolver(Solver):
    """K_e from the ECS trace; Na_i from solved ion 1 (the ion order is
    [K, Na, Cl])."""

    def update_ode(self, tag, traces: Traces):
        return {"K_e": traces.plus(0), "Na_i": traces.minus(1)}


def roi_source(g_syn, t_syn, sign, roi):
    """Space-time indicator source: sign * g_syn inside the box ``roi``
    ((xmin, xmax), (ymin, ymax), (zmin, zmax)) for 0.2 <= t <= t_syn, as a
    callable(x, t) of the cells-last quadrature points x (nq, d, nc) ->
    (nq, nc) in x's dtype."""
    (xmin, xmax), (ymin, ymax), (zmin, zmax) = roi

    def f(x, t):
        inside = (
            (x[..., 0, :] >= xmin) & (x[..., 0, :] <= xmax)
            & (x[..., 1, :] >= ymin) & (x[..., 1, :] <= ymax)
            & (x[..., 2, :] >= zmin) & (x[..., 2, :] <= zmax)
        )
        active = (t >= 0.2) & (t <= t_syn)
        return sign * g_syn * (inside & active).to(x.dtype)

    return f


def build_solver(dt=0.05, lambda_i=3.2 * 4, lambda_e=1.6 * 4, g_syn=26.0,
                 t_syn=1.2, mesh=None, roi=None, dtype=None, device="cuda"):
    if mesh is None:
        raise FileNotFoundError(
            "run_tortuosity needs mesh=: the EMIx volume mesh that the JAX app "
            "loads by default is not in the repository")
    # calibrated initial values
    K_e, K_g, K_n = 3.092970607490389, 99.3100014897692, 124.13988964240784
    Na_e, Na_g, Na_n = 144.60625137617149, 15.775818906083778, 12.850454639128186
    Cl_e, Cl_g, Cl_n = 133.62525154406637, 5.203660274163705, 5.0

    # immobile background charge = electroneutrality defect per subdomain
    rho = {
        0: -(Na_e + K_e - Cl_e),
        1: -(Na_n + K_n - Cl_n),
        2: -(Na_g + K_g - Cl_g),
    }
    params = PhysicalParams(
        dt=dt, n_steps_ODE=25, C_M=1.0, temperature=307e3,
        F=96500e3, R=8.315e3,
        phi_M_init=0.0, phi_M_init_type="constant", rho_sub=rho,
    )
    D_Na, D_K, D_Cl = 1.33e-8, 1.96e-8, 2.03e-8     # cm^2/ms
    le2, li2 = lambda_e**2, lambda_i**2

    if roi is None:
        roi = ((2700e-7, 3100e-7), (1700e-7, 2100e-7), (1800e-7, 2200e-7))
    f_K = roi_source(g_syn, t_syn, +1.0, roi)
    f_Na = roi_source(g_syn, t_syn, -1.0, roi)

    # ion order [K, Na, Cl]: Cl eliminated
    ion_list = [
        Ion(name="K", z=1.0,
            D_sub={0: D_K / le2, 1: D_K / li2, 2: D_K / li2},
            c_init_sub={0: K_e, 1: K_n, 2: K_g}, f_source=f_K),
        Ion(name="Na", z=1.0,
            D_sub={0: D_Na / le2, 1: D_Na / li2, 2: D_Na / li2},
            c_init_sub={0: Na_e, 1: Na_n, 2: Na_g}, f_source=f_Na),
        Ion(name="Cl", z=-1.0,
            D_sub={0: D_Cl / le2, 1: D_Cl / li2, 2: D_Cl / li2},
            c_init_sub={0: Cl_e, 1: Cl_n, 2: Cl_g}),
    ]
    stim_params = StimParams(stimulus={"stim_amplitude": 0.0},
                             stimulus_locator=lambda x: True, g_syn_bar=0.0)

    S = AstroSolver(params, ion_list, dtype=dtype, device=device)
    S.setup_domain(mesh, quad_degree=2)
    S.setup_parameters()
    S.setup_FEM_spaces()
    tags = set(np.unique(mesh.if_tags)) - {0, 10}
    models = {1: HodgkinHuxleyAstro(), 2: GlialKirAstro(), 3: HodgkinHuxleyAstro()}
    S.setup_membrane_model(stim_params, {t: models[t] for t in sorted(tags)})
    return S


def solver_params(**overrides):
    """The JAX app's SolverParams."""
    kw = dict(direct_emi=False, direct_knp=False,
              rtol_emi=1e-5, atol_emi=1e-40, threshold_emi=0.9,
              rtol_knp=1e-7, atol_knp=1e-40, threshold_knp=0.75, verbose=True,
              pc_refresh_every=50)
    kw.update(overrides)
    return SolverParams(**kw)


def main(mesh, Tstop=2.0, device="cuda"):
    S = build_solver(mesh=mesh, device=device)
    state = S.solve_system_active(Tstop, 0.0, solver_params())
    return S, state
