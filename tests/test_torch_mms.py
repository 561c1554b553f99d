"""The MMS verification path of the port against the JAX package in float64
on the CPU: the manufactured problems' callables, the error norms, the host
direct solve, the MMS assembly, one passive direct step, the iterative
path against the direct one (res 2), the port's own space and time
convergence rates, and the single-system GMRES."""
from functools import partial

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_parity import rel, t64

from knpemidg_tpu import config as jcfg
from knpemidg_tpu.fem import norms as jnorms
from knpemidg_tpu.mesh.generators import mms_square as jmms_square
from knpemidg_tpu.mms import problems as jprob
from knpemidg_tpu.ops.spmv import bell_matvec as jbm
from knpemidg_tpu.solver import Solver as JSolver
from knpemidg_tpu.solvers import direct as jdirect
from knpemidg_tpu.solvers import krylov as jkry
from knpemidg_tpu_torch import config as tcfg
from knpemidg_tpu_torch.fem import norms
from knpemidg_tpu_torch.mesh.generators import mms_square
from knpemidg_tpu_torch.mms import problems
from knpemidg_tpu_torch.ops.spmv import bell_matvec
from knpemidg_tpu_torch.solver import Solver
from knpemidg_tpu_torch.solvers import direct
from knpemidg_tpu_torch.solvers import krylov

# the reference protocol's constants (tests/test_mms_space.py)
D_SUB = {"a": {1: 6.0, 0: 5.0}, "b": {1: 3.0, 0: 4.0}, "c": {1: 1.0, 0: 2.0}}
C_SUB = {"a": {1: 1.0, 0: 2.0}, "b": {1: 2.0, 0: 4.0}, "c": {1: 3.0, 0: 2.0}}
Z = {"a": 1.0, "b": -1.0, "c": 1.0}
DT_SPACE = 1e-10
TSTOP_TIME = 2.0e-2
# tests/test_mms_iterative.py's SolverParams
ITERATIVE = dict(direct_emi=False, direct_knp=False, rtol_emi=1e-13, atol_emi=0.0,
                 rtol_knp=1e-12, atol_knp=0.0, max_it_emi=50000, max_it_knp=5000,
                 gmres_restart=40)
DIRECT = dict(direct_emi=True, direct_knp=True)
# Krylov counts of the iterative run at res 2, two steps: the JAX package's
# on the CPU, and the port's on the CPU (the EMI counts differ; ROADMAP.md
# section 3: a stagnating PCG at rtol 1e-13 with C_phi = 1e10)
JAX_COUNTS_RES2 = ([577, 220], [[1, 1], [1, 1]])
PORT_COUNTS_RES2 = ([585, 192], [[1, 1], [1, 1]])


def mms_params(dt):
    return {"F": 1.0, "R": 1.0, "temperature": 1.0, "C_phi": 1.0 / dt,
            "z": [Z[n] for n in "abc"], "D": [D_SUB[n] for n in "abc"],
            "C": [C_SUB[n] for n in "abc"]}


def build(pkg, res, dt, kind="space"):
    """An MMS solver of package ``pkg`` ("jax" or "torch", the port on the
    CPU) on mms_square(res), set up for solve_system_passive; its problem."""
    jax = pkg == "jax"
    prob = jprob if jax else problems
    mms = (prob.setup_mms_space if kind == "space" else prob.setup_mms_time)(mms_params(dt))
    cfg = jcfg if jax else tcfg
    params = cfg.PhysicalParams(dt=dt, F=1.0, R=1.0, temperature=1.0, C_M=1.0,
                                C_phi=1.0 / dt, phi_M_init=0.0, phi_M_init_type="constant",
                                rho_sub={0: 0.0, 1: 0.0})
    ions = [cfg.Ion(name=n, z=Z[n], D_sub=D_SUB[n],
                    c_init_sub={s: mms.init_c[k][s] for s in (0, 1)},
                    c_init_sub_type="expression", C_sub=C_SUB[n])
            for k, n in enumerate("abc")]
    S = JSolver(params, ions, mms=mms) if jax else Solver(params, ions, mms=mms, device="cpu")
    S.setup_domain((jmms_square if jax else mms_square)(res))
    S.setup_parameters()
    S.setup_FEM_spaces()
    return S, mms


def run(pkg, res, sp_kw, n_steps=2, dt=DT_SPACE, kind="space", tstop=None):
    S, mms = build(pkg, res, dt, kind)
    cfg = jcfg if pkg == "jax" else tcfg
    st = S.solve_system_passive(tstop or n_steps * dt, 0.0, cfg.SolverParams(**sp_kw))
    return S, mms, st


def host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def mean_shifted(phi):
    p = host(phi)
    return p - p.mean()


def errors(S, mms, state, T=None):
    """L2 errors of a, b, c and the mean-shifted phi, as the nightly tests
    compute them (tests/test_mms_space.py run_resolution)."""
    mesh = S.mesh
    ex = (lambda f: (lambda x: f(x))) if T is None else (lambda f: (lambda x: f(x, T)))
    c = host(state["c"]).transpose(0, 2, 1)
    fields = [("a", c[0]), ("b", c[1]), ("c", host(state["c_elim"]).T)]
    errs = {}
    for k, (name, u) in enumerate(fields):
        errs[name] = np.sqrt(sum(norms.l2_error(mesh, u, ex(mms.exact_c[k][s]), subdomain=s)
                                 ** 2 for s in (0, 1)))
    phi = host(state["phi"]).T
    shift = sum(norms.integral(mesh, ex(mms.exact_phi[s]), subdomain=s)
                for s in (0, 1)) - norms.integral(mesh, phi)
    errs["phi"] = np.sqrt(sum(norms.l2_error(mesh, phi, ex(mms.exact_phi[s]), subdomain=s,
                                             shift=-shift) ** 2 for s in (0, 1)))
    return errs


def rates(hs, errs, key):
    es = np.array([e[key] for e in errs])
    return np.log(es[1:] / es[:-1]) / np.log(np.array(hs[1:]) / np.array(hs[:-1]))


@pytest.fixture(scope="module")
def res2():
    """Both packages' solvers at res 2 (space problem) set up for a
    passive run: the JAX package's after its one-step direct run through
    the entry point (its jitted assemblies cached), with that run's state;
    the port's before any step."""
    Sj, mj, stj = run("jax", 2, DIRECT, n_steps=1)
    St, mt = build("torch", 2, DT_SPACE)
    St.splitting_scheme = False
    return Sj, mj, St, mt, stj


def jax_assemblers(Sj):
    """The JAX step's jitted EMI and per-ion KNP assemblies (cached by its
    run): emi(c, c_elim, phi_M_pad, I_ch_tot_pad, t), knp[k](c, c_elim,
    phi, phi_M_pad, I_ch_pad, I_ch_tot_pad, t, c_n)."""
    emi = Sj._jit(("asm_emi", Sj.splitting_scheme, False),
                  partial(Sj._assemble_emi, pair=False))
    knp = [Sj._jit(("asm_knp", k, Sj.splitting_scheme), partial(Sj._assemble_knp_ion, k))
           for k in range(Sj.N_ions)]
    return emi, knp


def _eval_points(S):
    g = S.g
    return {"facet": g["f_qp"], "cell": g["cell_qp"], "exterior": g["e_qp"]}


@pytest.mark.parametrize("kind", ["space", "time"])
def test_mms_callables_match_jax(res2, kind):
    """Every device callable of the manufactured problem at the facet, cell
    and exterior quadrature points of mms_square(2), and the numpy exact
    solutions and initial data at the cell nodes, against the JAX
    package's, rel 1e-12."""
    Sj, _, St, _, _ = res2
    mj = (jprob.setup_mms_space if kind == "space" else jprob.setup_mms_time)(
        mms_params(1e-3))
    mt = (problems.setup_mms_space if kind == "space" else problems.setup_mms_time)(
        mms_params(1e-3))
    assert mt.wall_tags == mj.wall_tags and problems.WALL_NORMALS == jprob.WALL_NORMALS
    pj, pt = _eval_points(Sj), _eval_points(St)
    tj, tt = jnp.asarray(0.3), torch.tensor(0.3, dtype=torch.float64)
    pairs = [(mj.f_phi[s], mt.f_phi[s], "cell") for s in (0, 1)]
    pairs += [(mj.f_c[k][s], mt.f_c[k][s], "cell") for k in range(3) for s in (0, 1)]
    for w in mj.wall_tags:
        pairs += [(mj.g_phi[w], mt.g_phi[w], "facet"), (mj.g_J_phi[w], mt.g_J_phi[w], "facet")]
        pairs += [(mj.g_robin_1[k][w], mt.g_robin_1[k][w], "facet") for k in range(3)]
        pairs += [(mj.g_robin_2[k][w], mt.g_robin_2[k][w], "facet") for k in range(3)]
    pairs += [(mj.neumann[k], mt.neumann[k], "exterior") for k in range(3)]
    for fj, ft, where in pairs:
        got = ft(pt[where], tt)
        assert got.dtype == torch.float64 and got.shape[-1] == pt[where].shape[-1]
        assert rel(got, fj(pj[where], tj)) < 1e-12
    nodes = Sj.geom.nodes
    for fj, ft in ([(mj.exact_phi[s], mt.exact_phi[s]) for s in (0, 1)]
                   + [(mj.exact_c[k][s], mt.exact_c[k][s]) for k in range(3) for s in (0, 1)]):
        assert rel(ft(nodes, 0.3), fj(nodes, 0.3)) < 1e-12
    for k in range(3):
        for s in (0, 1):
            assert rel(mt.init_c[k][s](nodes), mj.init_c[k][s](nodes)) < 1e-12


def test_norms_match_jax(res2):
    """l2_error (with a shift, per subdomain and over all) and integral (of
    a callable and of DG1 coefficients) against the JAX package, rel 1e-13."""
    Sj, mj, St, mt, _ = res2
    rng = np.random.default_rng(3)
    mesh_j, mesh_t = Sj.mesh, St.mesh
    u = rng.standard_normal((mesh_t.num_cells, 3))
    for s in (None, 0, 1):
        got = norms.l2_error(mesh_t, u, mt.exact_phi[1], subdomain=s, shift=0.25)
        ref = jnorms.l2_error(mesh_j, u, mj.exact_phi[1], subdomain=s, shift=0.25)
        assert abs(got - ref) <= 1e-13 * abs(ref)
        for vals_t, vals_j in ((u, u), (mt.exact_c[0][1], mj.exact_c[0][1])):
            got = norms.integral(mesh_t, vals_t, subdomain=s)
            ref = jnorms.integral(mesh_j, vals_j, subdomain=s)
            assert abs(got - ref) <= 1e-13 * abs(ref)


def test_solve_direct_matches_jax(res2):
    """The host direct solve on the port's assembled MMS systems at the
    initial state: the EMI system bordered for its constant nullspace and
    one ion's KNP system, against the JAX package's solve of the same
    arrays; the CSR conversion equal."""
    _, _, St, _, _ = res2
    s0 = St._initial_state(0.0)
    St.attach_pc(s0, tcfg.SolverParams(**DIRECT))          # caches the KNP statics
    pM, _, It = St._pads(s0)
    B, r, _ = St._assemble_emi(s0["c"], s0["c_elim"], pM, It, s0["t"])
    BK, rK = St._knp_assemble_mms(s0["c"], s0["phi"], s0["t"])
    nbr = St.g["nbr"]
    A_t, A_j = direct.bell_to_csr(B, nbr), jdirect.bell_to_csr(B.numpy(), nbr.numpy())
    assert (A_t != A_j).nnz == 0
    for blocks, b, null in ((B, r, True), (BK[0], rK[0], False)):
        got = direct.solve_direct(blocks, nbr, b, nullspace_constant=null)
        ref = jdirect.solve_direct(blocks.numpy(), nbr.numpy(), b.numpy(),
                                   nullspace_constant=null)
        assert got.shape == tuple(b.shape)
        assert rel(got, ref) < 1e-13


def test_mms_assembly_matches_jax(res2):
    """The MMS EMI operator, rhs and P_diag (K10 plus the interface, volume
    and Neumann data) and each solved ion's MMS KNP operator and rhs (K11
    with its membrane part zero, the Robin, coupling, volume and Neumann
    data) against the JAX package's assembly at a seeded state, rel
    1e-12."""
    Sj, _, St, _, _ = res2
    emi, knp = jax_assemblers(Sj)
    rng = np.random.default_rng(5)
    sj = Sj._initial_state(0.0)
    c = np.asarray(sj["c"]) * rng.uniform(0.99, 1.01, np.asarray(sj["c"]).shape)
    phi = 0.1 * rng.standard_normal(np.asarray(sj["phi"]).shape)
    t = 0.0
    pad = lambda v: jnp.concatenate([v, jnp.zeros(1, dtype=v.dtype)])
    zeros = jnp.zeros(Sj.n_mem + 1)
    Ip = jnp.zeros((3, Sj.n_mem + 1))
    bj, rj, Pj = emi(jnp.asarray(c), sj["c_elim"], pad(sj["phi_M"]), zeros, jnp.asarray(t))
    st = St._initial_state(0.0)
    St.attach_pc(st, tcfg.SolverParams(**DIRECT))
    pM, _, It = St._pads(st)
    bt, rt, Pt = St._assemble_emi(t64(c), st["c_elim"], pM, It, st["t"])
    for got, ref in ((bt, bj), (rt, rj), (Pt, Pj)):
        assert rel(got, ref) < 1e-12
    BK, rK = St._knp_assemble_mms(t64(c), t64(phi), st["t"])
    for k in range(St.N_ions):
        bkj, rkj = knp[k](jnp.asarray(c), sj["c_elim"], jnp.asarray(phi), pad(sj["phi_M"]),
                          Ip, zeros, jnp.asarray(t), jnp.asarray(c))
        assert rel(BK[k], bkj) < 1e-12
        assert rel(rK[k], rkj) < 1e-12


def _source(kind, scale, L):
    """An ion source of ``kind``: a constant, or a callable of the
    quadrature points and t that both packages evaluate (indexing and
    arithmetic only)."""
    if kind == "constant":
        return 2.5 * scale
    return lambda x, t: scale * (1.0 + x[:, 0, :] * x[:, 1, :] / L ** 2 + 1e3 * t)


@pytest.fixture(scope="module")
def neuron2d():
    """Both packages' solvers on the 2D neuron (the active path)."""
    import test_torch_parity as tp

    return tp._neuron_2d("jax"), tp._neuron_2d("torch")


@pytest.mark.parametrize("kind", ["constant", "callable"])
@pytest.mark.parametrize("path", ["mms", "active"])
def test_ion_sources_match_jax(request, path, kind):
    """Ion.f_source (a constant, a callable) on the first solved ion, the
    second without: the KNP operators and rhs of the MMS path's per-ion
    assembly at res 2 (against the JAX package's _assemble_knp_ion) and of
    the active path's all-ion assembly on the 2D neuron (against its
    _knp_assemble_all, whose src_rows it adds) at a seeded state, rel
    1e-12; the source's size is that of the rhs, and it moves the port's
    rhs.  The pair layout refuses a solver with sources."""
    import dataclasses

    if path == "mms":
        Sj, _, St, _, _ = request.getfixturevalue("res2")
    else:
        Sj, St = request.getfixturevalue("neuron2d")
    rng = np.random.default_rng(11)
    dt = Sj.params.dt
    t = 0.25 * dt
    c = np.asarray(Sj.c_init) * rng.uniform(0.99, 1.01, np.asarray(Sj.c_init).shape)
    c_elim = np.asarray(Sj.c_elim_init)
    phi = 0.1 * rng.standard_normal(np.asarray(Sj.phi_init).shape)
    phi_M = 0.1 * rng.standard_normal(Sj.n_mem)
    I_ch = 1e-2 * rng.standard_normal((len(Sj.ion_list), Sj.n_mem))
    pM = np.concatenate([phi_M, [0.0]])
    Ich = np.concatenate([I_ch, np.zeros((I_ch.shape[0], 1))], axis=1)
    Itot = Ich.sum(axis=0)
    L = float(np.ptp(St.mesh.vertices, axis=0).max())
    scale = float(np.abs(c).max()) / dt
    src = (2.5 * scale if kind == "constant" else
           lambda x, t: scale * (1.0 + x[:, 0, :] * x[:, 1, :] / L ** 2 + t / dt))
    ions = {S: list(S.ion_list) for S in (Sj, St)}
    try:
        for S in (Sj, St):
            S.ion_list[0] = dataclasses.replace(S.ion_list[0], f_source=src)
        St.attach_pc(St._initial_state(0.0), tcfg.SolverParams(**DIRECT))
        jx = [jnp.asarray(a) for a in (c, c_elim, phi, pM, Ich, Itot)]
        if path == "mms":
            ref = [Sj._assemble_knp_ion(k, *jx, t, jnp.asarray(c)) for k in range(Sj.N_ions)]
            BK_j, rK_j = [r[0] for r in ref], [r[1] for r in ref]
            assemble = lambda: St._knp_assemble_mms(t64(c), t64(phi), t)
        else:
            BK_j, rK_j = Sj._knp_assemble_all(*jx, t, jnp.asarray(c))
            assemble = lambda: St._knp_assemble_all(
                *(t64(a) for a in (c, c_elim, phi, pM, Ich, Itot)), t, t64(c))
        BK, rK = assemble()
        for k in range(St.N_ions):
            assert rel(BK[k], BK_j[k]) < 1e-12
            assert rel(rK[k], rK_j[k]) < 1e-12
        if path == "active":
            with pytest.raises(NotImplementedError):
                St.enable_pair_layout()
        St.ion_list[0] = ions[St][0]
        _, rK0 = assemble()
        assert rel(rK[0], rK0[0]) > 1e-3 and rel(rK[1], rK0[1]) == 0.0
    finally:
        for S in (Sj, St):
            S.ion_list[:] = ions[S]


def test_passive_direct_step_matches_jax(res2):
    """One passive direct step at res 2 through the entry points: c and
    c_elim against the JAX package's step, rel 1e-10.  The step's phi is
    the direct solve of the EMI system at the initial state; that system's
    rhs (entries up to 2e9 at C_phi = 1e10) is held to the JAX step's to
    rel 1e-15, and the port's solve of the port's operator on the JAX rhs
    to the JAX step's mean-shifted phi, rel 1e-10.  The port's own phi is
    8.4e-9 off the JAX step's, as the JAX package's eager assembly is: its
    jitted assembly rounds the rhs 1.2e-16 apart from the eager one, and
    the solve amplifies that (ROADMAP.md section 3); held here to 1e-7."""
    Sj, _, _, _, stj = res2
    St, _, stt = run("torch", 2, DIRECT, n_steps=1)
    assert St.stats.emi_niters == [0] and St.stats.knp_niters == [[0, 0]]
    assert stt["c"].shape == (2, 3, 32) and bool(torch.isfinite(stt["phi"]).all())
    assert rel(stt["c"], stj["c"]) < 1e-10
    assert rel(stt["c_elim"], stj["c_elim"]) < 1e-10
    emi, _ = jax_assemblers(Sj)
    sj = Sj._initial_state(0.0)
    pad = lambda v: jnp.concatenate([v, jnp.zeros(1, dtype=v.dtype)])
    _, rj, _ = emi(sj["c"], sj["c_elim"], pad(sj["phi_M"]), jnp.zeros(Sj.n_mem + 1), sj["t"])
    s0 = St._initial_state(0.0)
    pM, _, It = St._pads(s0)
    B, r, _ = St._assemble_emi(s0["c"], s0["c_elim"], pM, It, s0["t"])
    assert rel(r, rj) < 1e-15
    phi_on_jax_rhs = direct.solve_direct(B, St.g["nbr"], np.asarray(rj),
                                         nullspace_constant=True)
    assert rel(mean_shifted(phi_on_jax_rhs), mean_shifted(stj["phi"])) < 1e-10
    assert rel(mean_shifted(stt["phi"]), mean_shifted(stj["phi"])) < 1e-7


def test_iterative_matches_direct_res2():
    """tests/test_mms_iterative.py at res 2 on the port: the iterative
    solution (PCG and per-ion GMRES at the tight tolerances, the
    two-level preconditioners built per solve) against the port's direct
    one (c to atol 1e-8, the mean-shifted phi to 1e-4; the direct one is
    held to the JAX package's in test_passive_direct_step_matches_jax);
    the KNP counts equal the JAX package's, the EMI counts the port's CPU
    reference (PORT_COUNTS_RES2)."""
    Sd, _, std = run("torch", 2, DIRECT)
    Si, _, sti = run("torch", 2, ITERATIVE)
    assert float(np.abs(host(sti["c"]) - host(std["c"])).max()) < 1e-8
    assert float(np.abs(mean_shifted(sti["phi"]) - mean_shifted(std["phi"])).max()) < 1e-4
    assert Si.stats.knp_niters == JAX_COUNTS_RES2[1]
    assert (Si.stats.emi_niters, Si.stats.knp_niters) == PORT_COUNTS_RES2
    assert Sd.stats.emi_niters == [0, 0]


def test_space_convergence_rates():
    """The port alone: L2 rates of a, b, c and phi at res 3, 4, 5 (direct
    solves, two steps of dt 1e-10), the last above 1.7 (the JAX package's
    tests/test_mms_space.py gate)."""
    hs, errs = [], []
    for r in (3, 4, 5):
        S, mms, st = run("torch", r, DIRECT)
        hs.append(S.mesh.hmin())
        errs.append(errors(S, mms, st))
    for key in ("a", "b", "c", "phi"):
        rs = rates(hs, errs, key)
        assert rs[-1] > 1.7, (key, rs)


def test_time_convergence_rates():
    """The port alone: L2 rates of a, b and c at res 4 over dt = 1e-2 / 2^i,
    i = 1..3, to Tstop 2e-2 (direct solves), the last above 0.85 (the JAX
    package's tests/test_mms_time.py gate)."""
    dts = [1e-2 / 2 ** i for i in (1, 2, 3)]
    errs = []
    for dt in dts:
        S, mms, st = run("torch", 4, DIRECT, dt=dt, kind="time", tstop=TSTOP_TIME)
        T = float(st["t"])
        assert abs(T - TSTOP_TIME) < 1e-12
        errs.append(errors(S, mms, st, T))
    for key in ("a", "b", "c"):
        rs = rates(dts, errs, key)
        assert rs[-1] > 0.85, (key, rs)


def _gmres_system(rng, nc=60, K=4, nd=3):
    """A nonsymmetric diagonally dominant block-ELL system (2D shapes)."""
    nbr = rng.integers(0, nc, (K, nc))
    nbr[0] = np.arange(nc)
    B = 0.3 * rng.standard_normal((K, nd, nd, nc))
    B[0] += 4.0 * np.eye(nd)[:, :, None]
    b = rng.standard_normal((nd, nc))
    return B, nbr, b


@pytest.mark.parametrize("case", ["restart", "matvec_hi", "b_ref"])
def test_gmres_matches_jax(case):
    """The port's single-system gmres (the batched loop at mb = 1) against
    the JAX package's krylov.gmres on a block system with a block-Jacobi
    preconditioner: with restarts (restart 5), with a float64 matvec_hi
    for the restart residuals of a float32 solve, and with b_ref: x to
    1e-10 (float32: 1e-5), the same iteration count."""
    rng = np.random.default_rng(13)
    B, nbr, b = _gmres_system(rng)
    Pinv = np.moveaxis(np.linalg.inv(np.moveaxis(B[0], -1, 0)), 0, -1)
    dt_t, dt_j = ((torch.float32, jnp.float32) if case == "matvec_hi"
                  else (torch.float64, jnp.float64))
    Bt, nbt = torch.as_tensor(B, dtype=dt_t), torch.as_tensor(nbr, dtype=torch.int32)
    Bj, nbj = jnp.asarray(B, dtype=dt_j), jnp.asarray(nbr, dtype=jnp.int32)
    Pt, Pj = torch.as_tensor(Pinv, dtype=dt_t), jnp.asarray(Pinv, dtype=dt_j)
    kw = dict(rtol=1e-5 if case == "matvec_hi" else 1e-10, atol=0.0, max_it=200, restart=5)
    bt, bj = torch.as_tensor(b, dtype=dt_t), jnp.asarray(b, dtype=dt_j)
    ref_t = ref_j = None
    if case == "b_ref":
        ref_t, ref_j = 2.0 * bt, 2.0 * bj
    hi_t = hi_j = None
    if case == "matvec_hi":
        B64, nb64 = torch.as_tensor(B), nbt
        hi_t = lambda v: bell_matvec(B64, nb64, v.double())
        hi_j = lambda v: jbm(jnp.asarray(B), nbj, v.astype(jnp.float64))
    got = krylov.gmres(lambda v: bell_matvec(Bt, nbt, v), bt, torch.zeros_like(bt),
                       lambda r: torch.einsum("ijc,jc->ic", Pt, r), matvec_hi=hi_t,
                       b_ref=ref_t, **kw)
    ref = jkry.gmres(lambda v: jbm(Bj, nbj, v), bj, jnp.zeros_like(bj),
                     lambda r: jnp.einsum("ijc,jc->ic", Pj, r), matvec_hi=hi_j,
                     b_ref=ref_j, **kw)
    assert got.converged and bool(ref.converged)
    assert isinstance(got.iters, int) and got.iters == int(ref.iters) and got.iters > 5
    assert rel(got.x, ref.x) < (1e-5 if case == "matvec_hi" else 1e-10)


def test_mms_modules_import_no_jax():
    """The MMS path's modules, and chip_smoke.py, import neither jax nor
    any module of the JAX package."""
    import os
    import subprocess
    import sys

    code = ("import sys; import knpemidg_tpu_torch.mms.problems, "
            "knpemidg_tpu_torch.fem.norms, knpemidg_tpu_torch.solvers.direct, "
            "knpemidg_tpu_torch.solver, chip_smoke, kernel_digest; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'knpemidg_tpu' or m.startswith('knpemidg_tpu.')]; "
            "assert not bad, bad")
    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_mms_rhs_repeats_across_hash_seeds():
    """The port's MMS EMI and KNP operators and rhs at res 2 (the
    sympy-derived terms evaluated on the mesh; chip_smoke.py's MMS setup,
    this file's constants) are bitwise equal when built in two processes
    with different PYTHONHASHSEED values."""
    import hashlib
    import os
    import subprocess
    import sys

    code = ("import hashlib; import chip_smoke as cs; "
            "S, _ = cs.mms_solver(2, cs.MMS_DT_SPACE, 'space', device='cpu'); "
            "S.splitting_scheme = False; "
            "st = S.attach_pc(S._initial_state(0.0), cs.mms_params_direct()); "
            "pM, _, It = S._pads(st); "
            "out = S._assemble_emi(st['c'], st['c_elim'], pM, It, st['t']) "
            "+ S._knp_assemble_mms(st['c'], st['phi'], st['t']); "
            "h = hashlib.sha256(); [h.update(t.contiguous().numpy().tobytes()) for t in out]; "
            "print(h.hexdigest())")
    root = os.path.join(os.path.dirname(__file__), "..")
    digests = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                              text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr
        digests.append(proc.stdout.strip().splitlines()[-1])
    assert digests[0] == digests[1] and len(digests[0]) == 64


def test_exterior_terms_add_in_facet_order(res2):
    """The exterior Neumann term adds a cell's exterior facets one group at
    a time in facet order (a card's index_add would add a corner cell's
    two facets by atomics, in no fixed order): on the CPU, bitwise one
    index_add over all facets; mms_square(2) has cells with two exterior
    facets."""
    from knpemidg_tpu_torch.ops import assembly

    _, _, St, _, _ = res2
    g = St.g
    ne = g["e_c"].shape[0]
    assert ne > len(set(g["e_c"].tolist()))                # a cell repeats
    rng = np.random.default_rng(3)
    rhs = t64(rng.standard_normal((St.nd, St.n_cells)))
    bdry = t64(rng.standard_normal((g["w_f"].shape[0], ne)))
    got = assembly._add_exterior(g, rhs, bdry, -1.0)
    be = -1.0 * g["e_area"] * torch.einsum("q,qf,qif->if", g["w_f"], bdry, g["e_R"])
    assert torch.equal(got, rhs.index_add(1, g["e_c"], be))
    groups = g["e_groups"]
    assert len(groups) == 2
    assert sorted(torch.cat(groups).tolist()) == list(range(ne))
    assert all(len(set(g["e_c"][sel].tolist())) == len(sel) for sel in groups)


def test_mms_refusals():
    """What the MMS path does not carry raises: the pair layout with an
    MMS problem (ValueError), H5 field output of the passive loop
    (NotImplementedError), and stats files without a filename
    (ValueError)."""
    S, _ = build("torch", 2, DT_SPACE)
    with pytest.raises(ValueError):
        S.enable_pair_layout()
    sp = tcfg.SolverParams(**DIRECT)
    with pytest.raises(NotImplementedError):
        S.solve_system_passive(2 * DT_SPACE, 0.0, sp, filename="out/", save_fields=True)
    with pytest.raises(ValueError):
        S.solve_system_passive(2 * DT_SPACE, 0.0, sp, save_solver_stats=True)


def test_direct_solves_on_the_active_path():
    """The direct solves outside MMS: two steps of the 2D neuron
    (solve_system_active) with direct EMI and KNP solves (the per-ion loop
    on the alpha-based membrane rhs) and with a direct EMI solve and the
    batched KNP GMRES, against the iterative run at tight tolerances:
    c and phi_M to rel 1e-8."""
    from test_torch_parity import neuron_2d_torch

    tight = dict(rtol_knp=1e-12, atol_knp=0.0)
    runs = {}
    for name, over in (("iterative", dict(rtol_emi=1e-12, atol_emi=0.0, max_it_emi=5000,
                                          **tight)),
                       ("direct", dict(direct_emi=True, direct_knp=True)),
                       ("direct_emi", dict(direct_emi=True, **tight))):
        S, sp = neuron_2d_torch(**over)
        runs[name] = S.solve_system_active(2 * S.params.dt, 0.0, sp), S
    ref = runs["iterative"][0]
    for name in ("direct", "direct_emi"):
        st, S = runs[name]
        assert S.stats.emi_niters == [0, 0]
        assert rel(st["c"], ref["c"]) < 1e-8 and rel(st["phi_M"], ref["phi_M"]) < 1e-8
    assert runs["direct"][1].stats.knp_niters == [[0, 0], [0, 0]]
    assert min(min(k) for k in runs["direct_emi"][1].stats.knp_niters) > 0
