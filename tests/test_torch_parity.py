"""Shared fixtures of the PyTorch port's parity tests (tests/test_torch_*.py);
this module holds no tests of its own.

Both packages are set up from the same description: the EMIx physics on
box_3d_axons(0, length_factor=1) scaled to cm, and the idealised 2D neuron
(box_2d_neuron(0), SI units, HH-SI membrane).  Each package builds its own
mesh with its own generator; inputs that are not set up by the solvers come
from numpy.random.default_rng(seed) and reach both packages as numpy arrays.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import knpemidg_tpu_torch as kt  # noqa: E402
from knpemidg_tpu_torch import emix  # noqa: E402

F64 = torch.float64


def rel(a, b):
    """Relative 2-norm difference of two arrays (numpy, jax or torch)."""
    a = to_np(a).astype(np.float64)
    b = to_np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def to_np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def t64(v):
    return torch.as_tensor(np.array(v, dtype=np.float64))


def solver_params_kw(**overrides):
    """bench.py's SolverParams with Ritz deflation off (the ritz-0
    references: EMIx cell EMI [7, 4], KNP [[4, 3], [2, 2]]; pair [3, 9],
    [[11, 8], [9, 5]]); ``overrides`` replace entries."""
    kw = dict(direct_emi=False, direct_knp=False, rtol_emi=1e-5,
              atol_emi=1e-40, rtol_knp=1e-7, atol_knp=2e-40,
              max_it_emi=1000, max_it_knp=1000, gmres_restart=30,
              agg_size=64, emi_ritz=0)
    kw.update(overrides)
    return kw


def auto_params_kw(**overrides):
    """bench.py's SolverParams exactly (emi_ritz AUTO: 24 Ritz fields on the
    cell layout, none on the pair layout)."""
    return solver_params_kw(emi_ritz=-1, **overrides)


# ---------------------------------------------------------------------------
# 3D EMIx fixture
# ---------------------------------------------------------------------------

def emix_mesh_jax():
    from knpemidg_tpu.mesh.generators import box_3d_axons

    mesh = box_3d_axons(0, length_factor=1)
    mesh.vertices *= 1e2
    return mesh


def emix_mesh_torch():
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    mesh = box_3d_axons(0, length_factor=1)
    mesh.vertices *= 1e2
    return mesh


def emix_jax(**overrides):
    """(JAX solver, JAX SolverParams) in float64, Ritz deflation off unless
    ``overrides`` say otherwise."""
    import jax.numpy as jnp
    from run_EMIx_simulation import build_solver
    from knpemidg_tpu.config import SolverParams

    S = build_solver(mesh=emix_mesh_jax(), dtype=jnp.float64)
    return S, SolverParams(**solver_params_kw(**overrides))


def emix_torch(device="cpu", dtype=F64, pair=False, **overrides):
    """(port solver, port SolverParams) with Ritz deflation off unless
    ``overrides`` say otherwise; ``pair`` enables the interleaved pair
    layout."""
    S = emix.build_solver(emix_mesh_torch(), dtype=dtype, device=device, pair=pair)
    return S, emix.solver_params(**{"emi_ritz": 0, **overrides})


def emix_jax_auto(**overrides):
    """emix_jax with bench.py's SolverParams exactly (AUTO Ritz)."""
    return emix_jax(emi_ritz=-1, **overrides)


def emix_torch_auto(device="cpu", dtype=F64, pair=False, **overrides):
    """The port's EMIx solver with emix.solver_params() as shipped (AUTO
    Ritz: EMI [5, 3], KNP [[1, 1], [2, 1]] on the cell layout)."""
    S = emix.build_solver(emix_mesh_torch(), dtype=dtype, device=device, pair=pair)
    return S, emix.solver_params(**overrides)


# ---------------------------------------------------------------------------
# 2D neuron fixture (examples/run_2D.py physics)
# ---------------------------------------------------------------------------

def _neuron_2d(pkg, device="cpu"):
    """StandardSolver of package ``pkg`` ("jax" or "torch") on
    box_2d_neuron(0) with the run_2D physics, in float64 (the port's on
    ``device``)."""
    if pkg == "jax":
        import jax.numpy as jnp
        from knpemidg_tpu.config import Ion, PhysicalParams, StimParams
        from knpemidg_tpu.mesh.generators import box_2d_neuron
        from knpemidg_tpu.models.hh import HodgkinHuxleySI
        from knpemidg_tpu.solver import StandardSolver
        kw = dict(dtype=jnp.float64)
    else:
        from knpemidg_tpu_torch.config import Ion, PhysicalParams, StimParams
        from knpemidg_tpu_torch.mesh.generators import box_2d_neuron
        from knpemidg_tpu_torch.models.hh import HodgkinHuxleySI
        from knpemidg_tpu_torch.solver import StandardSolver
        kw = dict(dtype=F64, device=device)
    params = PhysicalParams(
        dt=1.0e-4, n_steps_ODE=25, C_M=0.02, temperature=300.0, F=96485.0,
        R=8.314, phi_M_init=-0.07438609374462003, phi_M_init_type="constant",
        rho_sub={0: 0.0, 1: 0.0})
    Na_i, Na_e = 12.838513108648856, 100.71925900027354
    K_i, K_e = 124.15397583491901, 3.3236967382705265
    Cl_i, Cl_e = Na_i + K_i, Na_e + K_e
    D_Na, D_K, D_Cl = 1.33e-9, 1.96e-9, 2.03e-9
    ions = [
        Ion(name="K", z=1.0, D_sub={0: D_K, 1: D_K}, c_init_sub={0: K_e, 1: K_i}),
        Ion(name="Cl", z=-1.0, D_sub={0: D_Cl, 1: D_Cl},
            c_init_sub={0: Cl_e, 1: Cl_i}),
        Ion(name="Na", z=1.0, D_sub={0: D_Na, 1: D_Na},
            c_init_sub={0: Na_e, 1: Na_i}),
    ]
    stim = StimParams(stimulus={"stim_amplitude": 10.0},
                      stimulus_locator=lambda x: x[0] < 20e-6, g_syn_bar=10.0)
    S = StandardSolver(params, ions, **kw)
    S.setup_domain(box_2d_neuron(0))
    S.setup_parameters()
    S.setup_FEM_spaces()
    S.setup_membrane_model(stim, {1: HodgkinHuxleySI(stimulus=True)})
    return S


def neuron_2d_jax(**overrides):
    from knpemidg_tpu.config import SolverParams

    return _neuron_2d("jax"), SolverParams(**solver_params_kw(**overrides))


def neuron_2d_torch(**overrides):
    return _neuron_2d("torch"), kt.SolverParams(**solver_params_kw(**overrides))


# ---------------------------------------------------------------------------
# seeded two-level preconditioner data (kernels K6 / K7)
# ---------------------------------------------------------------------------

N_COMP, NW, NR = 3, 6, 4      # compartments, moment fields, Ritz fields


def _spd(rng, n, cond=1e3):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.geomspace(1.0, 1.0 / cond, n)) @ Q.T


def two_level_data(rng, nd, nc, agg, groups=("As", "comp", "mom", "ritz"), m=None):
    """Seeded numpy two-level data of the shapes build_two_level and the
    deflation builds give (the groups named in ``groups``); ``m`` adds a
    leading system axis to the coarse entries (the batched KNP data)."""
    n = -(-nc // agg)
    lead = () if m is None else (m,)

    def coarse_mat():
        A = np.stack([_spd(rng, n) for _ in range(m or 1)])
        return A if m else A[0]

    d = {"inv": coarse_mat(), "s": rng.uniform(0.5, 2.0, lead + (n,))}
    if "As" in groups:
        d["As"] = coarse_mat()
    d.update(_deflation_data(rng, nd, nc, groups))
    return d


def _deflation_data(rng, nd, nc, groups):
    """The compartment ("comp"), moment ("mom") and Ritz ("ritz") groups of
    two_level_data over nc cells."""
    d = {}
    if "comp" in groups:
        comp = np.repeat(np.arange(N_COMP), -(-nc // N_COMP))[:nc]
        d["comp_onehot"] = (comp[None, :] == np.arange(N_COMP)[:, None]).astype(float)
        d["comp_onehot"][:, -5:] = 0.0                 # inert pad cells: no compartment
        d["comp_inv"], d["comp_As"] = _spd(rng, N_COMP), _spd(rng, N_COMP)
        d["comp_s"] = rng.uniform(0.5, 2.0, N_COMP)
    for key, k in (("mom", NW), ("ritz", NR)):
        if key in groups:
            d[f"{key}_W"] = rng.standard_normal((k, nd, nc))
            d[f"{key}_inv"] = _spd(rng, k)
            d[f"{key}_s"] = rng.uniform(0.5, 2.0, k)
    return d


def three_level_data(rng, nd, nc, agg, groups=("As", "comp", "mom", "ritz"), m=None, k2=4,
                     spd=True):
    """Seeded numpy three-level data of the shapes build_two_level gives
    above max_dense: n_agg = ceil(nc / agg) chunks in n2 = ceil(n_agg / k2)
    super-chunks, the dense inv (and As) on n2 rows, d1inv on the chunks,
    and the deflation groups of two_level_data.  ``spd=False`` draws the
    dense matrices as scaled normal ones (the kernels' order of operations
    does not need them SPD, and a QR at thousands of rows takes seconds)."""
    n_agg = -(-nc // agg)
    n2 = -(-n_agg // k2)
    lead = () if m is None else (m,)

    def coarse_mat():
        A = np.stack([_spd(rng, n2) if spd else rng.standard_normal((n2, n2)) / np.sqrt(n2)
                      for _ in range(m or 1)])
        return A if m else A[0]

    d = {"inv": coarse_mat(), "s": rng.uniform(0.5, 2.0, lead + (n2,)),
         "d1inv": rng.uniform(0.5, 2.0, lead + (n_agg,))}
    if "As" in groups:
        d["As"] = coarse_mat()
    d.update(_deflation_data(rng, nd, nc, groups))
    return d


def jax_state_for_torch(S_jax_state, S_torch):
    """A JAX solver state (pc included) as a port state on the CPU in f64,
    through the numpy layout of state_to_numpy / state_from_numpy."""
    st_np = kt.state_to_numpy(S_jax_state)
    models = {tag: mm.model for tag, mm in S_torch.mem_models.items()}
    return kt.state_from_numpy(st_np, "cpu", F64, models=models)


def cuda_or_skip():
    import pytest

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (kernels run on the card only)")
    return torch.device("cuda")


def gmres_operators(rng, mb, n, easy=()):
    """mb nonsymmetric, diagonally dominant dense operators (n x n), the
    systems in ``easy`` close to the identity (they converge first)."""
    A = np.empty((mb, n, n))
    for s in range(mb):
        scale = 0.02 if s in easy else 0.6
        A[s] = (np.eye(n) * (2.0 + rng.uniform(size=n))
                + scale * rng.normal(size=(n, n)) / np.sqrt(n))
    return A


def gmres_torch_ops(A, dtype=F64, device="cpu"):
    """The batched matvec of operators A (mb, n, n) and its Jacobi
    preconditioner, on vectors of any shape (mb, ...) of n entries a
    system."""
    At = torch.as_tensor(A, dtype=dtype, device=device)
    dinv = 1.0 / torch.diagonal(At, dim1=1, dim2=2)

    def mv(v):
        return torch.einsum("sij,sj->si", At, v.reshape(v.shape[0], -1)).reshape(v.shape)

    def pc(v):
        return (dinv * v.reshape(v.shape[0], -1)).reshape(v.shape)

    return mv, pc


def gmres_stepwise(matvec, b, precond, rtol, atol, max_it, restart):
    """krylov.gmres_batched from a zero guess as it was before the
    look-ahead: the flag read after every Arnoldi step; the same K9
    entries.  Returns (x, iters, resnorm, converged, cycles ended by the
    flag before the restart)."""
    from knpemidg_tpu_torch.ops import krylov_ops as ko

    mb, shape = b.shape[0], b.shape
    n = b.numel() // mb
    bv = b.reshape(mb, n)
    Aop = lambda v: precond(matvec(v.reshape(shape))).reshape(mb, n).contiguous()
    res_of = lambda x: precond((bv - matvec(x.reshape(shape)).reshape(mb, n))
                               .reshape(shape)).reshape(mb, n).contiguous()
    m = restart
    wk = ko.gmres_work(mb, n, m, b.dtype, b.device)
    bz = precond(bv.reshape(shape)).reshape(mb, n).contiguous()
    ko.gmres_cgs_dot(bz[None], bz, 1, wk.h1, wk)
    wk.tol.copy_(torch.clamp(rtol * torch.sqrt(wk.h1[:, 0]), min=atol))
    max_cycles = -(-max_it // restart)
    x = torch.zeros_like(bv)
    it = torch.zeros(mb, dtype=torch.int32, device=b.device)
    k = early = 0
    while True:
        ko.gmres_start(res_of(x), wk)
        if not (k < max_cycles and bool(wk.flag)):
            break
        j = 0
        while True:
            ko.gmres_arnoldi(Aop(wk.V[j]), wk, j)
            j += 1
            if j >= m or not bool(wk.flag):
                break
        early += j < m
        ko.gmres_solve_update(wk, x)
        it += wk.ks
        k += 1
    return (x.reshape(shape), it.tolist(), wk.beta.clone(),
            bool(torch.all(wk.beta <= wk.tol)), early)
