"""The CUDA kernels of knpemidg_tpu_torch against their plain torch
versions, and the slice on the card against the CPU.  Every test here needs
an NVIDIA GPU and skips elsewhere.  The file imports no jax, so it also
runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import test_torch_parity as tp
from test_torch_parity import cuda_or_skip, rel

from knpemidg_tpu_torch import _cuda
from knpemidg_tpu_torch.fem.tabulation import build_geometry
from knpemidg_tpu_torch.membrane import engine
from knpemidg_tpu_torch.models import calibration, glial, hh, leak
from knpemidg_tpu_torch import probes
from knpemidg_tpu_torch.ops import assembly, coarse, krylov_ops as ko, pairs, spmv
from knpemidg_tpu_torch.parallel.sharding import unpad_state
from knpemidg_tpu_torch.solvers import krylov

pytestmark = pytest.mark.cuda

# float32: sums in another order and fused multiply-adds; float64 round-off
DTYPES = [(torch.float32, 1e-5), (torch.float64, 1e-12)]
# the kernels each layout's step goes through
TWO_LEVEL_KERNELS = tuple(f"two_level_{e}" for e in ("restrict", "solve", "prolong")) + (
    "two_level_coarse_batched",)
ASSEMBLY_KERNELS = ("emi_cell", "emi_facet", "emi_emit_cell", "alpha_sum", "knp_cell",
                    "knp_facet", "knp_membrane_emit", "membrane_trace",
                    "eliminated_concentration")
KRYLOV_KERNELS = tuple(f"pcg_{e}" for e in ("dot", "update", "dot2_direction")) + tuple(
    f"gmres_{e}" for e in ("start", "cgs_dot", "arnoldi", "solve_update"))
# (the cell layout's two-level applies fold kernel B's apply into the
# prolong-add and the one-launch apply: no block_jacobi_apply launch)
CELL_KERNELS = ("bell_matvec", "block_jacobi_inverse",
                "membrane_rk4") + TWO_LEVEL_KERNELS + ASSEMBLY_KERNELS + KRYLOV_KERNELS
PAIR_KERNELS = ("pair_matvec", "to_pair", "from_pair", "gather_blocks_pair",
                "block_jacobi_inverse_nd8", "block_jacobi_apply_nd8",
                "membrane_rk4") + TWO_LEVEL_KERNELS + ASSEMBLY_KERNELS + KRYLOV_KERNELS


@pytest.fixture(scope="module")
def nbr():
    cuda_or_skip()
    return build_geometry(tp.emix_mesh_torch(), 2, 2).to_device(device="cpu")["nbr"]


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_matvec_and_block_jacobi_kernels_match_plain(nbr, dtype, tol):
    dev = cuda_or_skip()
    rng = np.random.default_rng(5)
    K, nc = nbr.shape
    nb = nbr.to(dev)
    B = rng.standard_normal((2, K, 4, 4, nc))
    B[:, 0, range(4), range(4), :] += 4.0             # dominant diagonal
    B = torch.as_tensor(B, dtype=dtype, device=dev)
    x = torch.as_tensor(rng.standard_normal((2, 4, nc)), dtype=dtype, device=dev)
    n0 = dict(_cuda.LAUNCHES)
    assert rel(spmv.bell_matvec_multi(B, nb, x), spmv.bell_matvec_multi_plain(B, nb, x)) < tol
    B0, x0 = B[0].contiguous(), x[0].contiguous()
    assert rel(spmv.bell_matvec(B0, nb, x0), spmv.bell_matvec_plain(B0, nb, x0)) < tol
    P = B[:, 0].contiguous()
    inv = spmv.block_jacobi_inverse(P)
    assert rel(inv, spmv.block_jacobi_inverse_plain(P)) < 10 * tol
    assert rel(spmv.block_jacobi_apply(inv, x), spmv.block_jacobi_apply_plain(inv, x)) < tol
    assert _cuda.LAUNCHES["bell_matvec"] == n0["bell_matvec"] + 2
    assert _cuda.LAUNCHES["block_jacobi_inverse"] == n0["block_jacobi_inverse"] + 1
    with pytest.raises(ValueError):
        spmv.block_jacobi_apply(inv, x.transpose(1, 2).contiguous())
    with pytest.raises(ValueError):
        spmv.bell_matvec(B0, nb, x0.t())


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_bell_matvec_off_the_block_matches_plain(m, dtype, tol):
    """K1 (a thread per (system, row, cell), 64 cells a block) against its
    plain version elementwise, to each value's sum of |terms|, at 1,000
    cells (not a multiple of the block) on a random neighbour table: every
    output written, one launch a call; a table of another slot count than
    the kernel's K = 5 raises."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(19)
    K, nc = spmv.MATVEC_BUILT[4], 1000
    nbr = rng.integers(0, nc, (K, nc))
    nbr[0] = np.arange(nc)
    nb = torch.as_tensor(nbr, dtype=torch.int32, device=dev)
    B = _rand(rng, (m, K, 4, 4, nc), dtype, dev)
    x = _rand(rng, (m, 4, nc), dtype, dev)
    if m == 1:
        B, x = B[0].contiguous(), x[0].contiguous()
        kernel, plain = spmv.bell_matvec, spmv.bell_matvec_plain
    else:
        kernel, plain = spmv.bell_matvec_multi, spmv.bell_matvec_multi_plain
    n0 = _cuda.LAUNCHES["bell_matvec"]
    got = kernel(B, nb, x)
    assert _cuda.LAUNCHES["bell_matvec"] == n0 + 1
    scale = plain(B.abs(), nb, x.abs())
    assert float(((got - plain(B, nb, x)).abs() / scale).max()) < tol
    with pytest.raises(NotImplementedError):
        kernel(B[..., :K - 1, :, :, :].contiguous(), nb[:K - 1].contiguous(), x)


# a model's parameters scaled per point (mV/ms and SI units)
MV_SCALES = {"Cm": 2.0, "K_e": 3.3, "Na_i": 12.8, "E_K": -90.0, "E_Na": 50.0,
             "stim_amplitude": 5.0}
SI_SCALES = {"Cm": 0.02, "K_e": 4.0, "Na_i": 12.8, "E_K": -0.09, "E_Na": 0.05,
             "stim_amplitude": 10.0}
# name -> (model, dt, step time, parameter scales): the SI step crosses the
# HH-SI stimulus's t = 0.125 s cut-off four stimulus periods in
MODELS = {"hh_mv": (hh.HodgkinHuxleyMV, 0.1, 0.3, MV_SCALES),
          "glial_kir": (glial.GlialKir, 0.1, 0.3, MV_SCALES),
          "hh_si": (hh.HodgkinHuxleySI, 1e-4, 0.12495, SI_SCALES),
          "hh_astro": (hh.HodgkinHuxleyAstro, 0.05, 0.3, MV_SCALES),
          "leak_si": (leak.LeakSI, 1e-4, 0.12495, SI_SCALES),
          "glial_astro": (glial.GlialKirAstro, 0.05, 0.3, dict(MV_SCALES, E_Cl=-80.0))}


def _membrane(name, n, dtype, dev, rng):
    """n points of model ``name`` with its parameters scaled per point."""
    model, _, _, scales = MODELS[name]
    mm = engine.make_membrane(model(), np.zeros((n, 3)), dtype=dtype, device=dev)
    for key, val in scales.items():
        mm = engine.set_param(mm, key, val * rng.uniform(0.9, 1.1, n))
    return mm


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_membrane_rk4_kernel_matches_plain(name, dtype, tol):
    dev = cuda_or_skip()
    rng = np.random.default_rng(6)
    n = 4000
    mm = _membrane(name, n, dtype, dev, rng)
    _, dt, t0, _ = MODELS[name]
    t = torch.tensor(t0, dtype=dtype, device=dev)
    for scheme in ("rk4", "rush_larsen"):
        # a model without gating states: Rush-Larsen runs the RK4 kernel
        gated = scheme == "rush_larsen" and mm.model.gating_indices()
        kernel = "membrane_rl" if gated else "membrane_rk4"
        n0 = _cuda.LAUNCHES[kernel]
        got = engine.ode_step(mm, t, dt, 25, scheme=scheme)
        ref = engine.ode_step_plain(mm, t, dt, 25, scheme=scheme)
        assert _cuda.LAUNCHES[kernel] == n0 + 1, scheme
        for s in range(ref.states.shape[0]):
            assert rel(got.states[s], ref.states[s]) < 10 * tol, (scheme, s)
        assert rel(got.params, ref.params) < 10 * tol, scheme


class _NoDeviceModel(hh.HodgkinHuxleySI):
    """A membrane model the ODE kernel has no device function for."""

    cuda_model_id = 0


def test_kernels_raise_outside_the_main_path():
    """The kernels exist for the 3D and 2D DG1 blocks (nd = 4, 3) and the
    models with a device function; anything else (here 1D blocks, nd = 2
    with K = 3 slots, and a model without a device function, in a step and
    in ode_run) raises on a CUDA tensor instead of running plain."""
    dev = cuda_or_skip()
    mm = engine.make_membrane(_NoDeviceModel(), np.zeros((8, 3)), device=dev)
    t = torch.tensor(0.0, dtype=torch.float64, device=dev)
    for scheme in ("rk4", "rush_larsen"):
        with pytest.raises(NotImplementedError):
            engine.ode_step(mm, t, 1e-4, 25, scheme=scheme)
    with pytest.raises(NotImplementedError):
        engine.ode_run(mm, 0.0, 1e-4, 10)
    cal = engine.make_membrane(calibration.CalibrationEMIx(), np.zeros((1, 2)), device=dev)
    with pytest.raises(NotImplementedError):          # no V: not a membrane tag
        engine.ode_step(cal, t, 0.1, 2)
    nc = 16
    nbr = torch.zeros((3, nc), dtype=torch.int32, device=dev)
    B = torch.ones((3, 2, 2, nc), dtype=torch.float64, device=dev)
    x = torch.ones((2, nc), dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError):
        spmv.bell_matvec(B, nbr, x)
    with pytest.raises(NotImplementedError):
        spmv.block_jacobi_inverse(B[0].contiguous())
    with pytest.raises(NotImplementedError):
        spmv.block_jacobi_apply(B[0].contiguous(), x)


def _ode_case(dtype, scheme, dev, seed=8):
    """The EMIx fixture's solver on the card under ``scheme`` and a state
    with perturbed concentrations, potential, time and membrane states."""
    S, _ = tp.emix_torch(device=dev, dtype=dtype)
    S.params = dataclasses.replace(S.params, ode_scheme=scheme)
    rng = np.random.default_rng(seed)
    noise = lambda a, w: a * torch.as_tensor(rng.uniform(1 - w, 1 + w, tuple(a.shape)),
                                             dtype=dtype, device=dev)
    s = S._initial_state(0.0)
    mem = {tag: engine.MembraneState(noise(mm.states, 0.02), mm.params, mm.model)
           for tag, mm in s["mem"].items()}
    return S, dict(s, c=noise(s["c"], 0.01), c_elim=noise(s["c_elim"], 0.01),
                   phi_M=noise(s["phi_M"], 0.1),
                   t=torch.tensor(0.3, dtype=dtype, device=dev), mem=mem)


K13_DTYPES = [(torch.float32, 1e-4), (torch.float64, 1e-12)]   # chip_smoke.py's K13 tolerances


@pytest.mark.parametrize("first_step", [True, False])
@pytest.mark.parametrize("scheme", ["rk4", "rush_larsen"])
@pytest.mark.parametrize("dtype,tol", K13_DTYPES)
def test_ode_step_is_one_launch_equal_to_its_plain_twin(dtype, tol, scheme, first_step):
    """Solver._ode_step on the card makes one K13 launch for both tags (and
    one K14 launch, its traces, and nothing else), equals the tag table's
    plain twin on the same pushes, and leaves the input state's tensors
    bitwise as they were."""
    dev = cuda_or_skip()
    S, state = _ode_case(dtype, scheme, dev)
    inputs = [state["phi_M"], state["c"], state["c_elim"], state["t"]] + [
        v for mm in state["mem"].values() for v in (mm.states, mm.params)]
    before = [v.clone() for v in inputs]
    table, pushes = S._ode_pushes(state, first_step)
    ref_mems, ref_phi, ref_ich = engine.ode_step_tags_plain(
        table, list(state["mem"].values()), pushes, state["t"], S.params.dt,
        S.params.n_steps_ODE)
    S._ode_step(state, first_step=first_step)                 # built and warm
    n0 = dict(_cuda.LAUNCHES)
    new = S._ode_step(state, first_step=first_step)
    torch.cuda.synchronize()
    moved = {k: v - n0[k] for k, v in _cuda.LAUNCHES.items() if v != n0[k]}
    k13 = "membrane_rl" if scheme == "rush_larsen" else "membrane_rk4"
    assert moved == {k13: 1, "membrane_trace": 1}, moved
    for tag, ref in zip(state["mem"], ref_mems):
        got = new["mem"][tag]
        for s in range(ref.states.shape[0]):
            assert rel(got.states[s], ref.states[s]) < tol, (tag, s)
        assert rel(got.params, ref.params) < tol, tag
    assert rel(new["phi_M"], ref_phi) < tol
    for k in range(ref_ich.shape[0]):
        assert rel(new["I_ch"][k], ref_ich[k]) < tol, k
    for v, b in zip(inputs, before):
        assert torch.equal(v, b)


def test_ode_step_tags_take_eight_tags_a_launch():
    """Ten tags of both models (both schemes' blocks in one launch) make
    two launches, of 8 and 2 tags, equal to the plain twin; the 2D neuron's
    HH-SI step is one launch equal to its plain twin."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(9)
    n, tags = 100, 10
    models = [glial.GlialKir() if j % 2 else hh.HodgkinHuxleyMV() for j in range(tags)]
    mems = []
    for m in models:
        mm = engine.make_membrane(m, np.zeros((n, 3)), device=dev)
        for key, val in {"Cm": 2.0, "K_e": 3.3, "Na_i": 12.8, "E_K": -90.0,
                         "E_Na": 50.0, "stim_amplitude": 5.0}.items():
            mm = engine.set_param(mm, key, val * rng.uniform(0.9, 1.1, n))
        mems.append(mm)
    table = engine.tag_table([(m, n * j, n) for j, m in enumerate(models)], n * tags,
                             ["Na", "K", "Cl"], "rush_larsen")
    phi_M = torch.as_tensor(rng.uniform(-80.0, -60.0, n * tags), device=dev)
    pushes = [engine.TagPush(v=(phi_M, n * j)) for j in range(tags)]
    t = torch.tensor(0.3, dtype=torch.float64, device=dev)
    n0 = _cuda.LAUNCHES["membrane_rl"]
    got = engine.ode_step_tags(table, mems, pushes, t, 0.1, 25)
    assert _cuda.LAUNCHES["membrane_rl"] == n0 + 2
    ref = engine.ode_step_tags_plain(table, mems, pushes, t, 0.1, 25)
    for a, b in zip(got[0], ref[0]):
        assert rel(a.states, b.states) < 1e-12 and rel(a.params, b.params) < 1e-12
    assert rel(got[1], ref[1]) < 1e-12 and rel(got[2], ref[2]) < 1e-12
    S2 = tp._neuron_2d("torch", device=dev)                      # HodgkinHuxleySI
    st = S2._initial_state(0.0)
    tab2, pushes2 = S2._ode_pushes(st, first_step=False)
    ref2 = engine.ode_step_tags_plain(tab2, list(st["mem"].values()), pushes2, st["t"],
                                      S2.params.dt, S2.params.n_steps_ODE)
    n0 = _cuda.LAUNCHES["membrane_rk4"]
    new2 = S2._ode_step(st, first_step=False)
    assert _cuda.LAUNCHES["membrane_rk4"] == n0 + 1
    (mm2,) = new2["mem"].values()
    assert rel(mm2.states, ref2[0][0].states) < 1e-12
    assert rel(mm2.params, ref2[0][0].params) < 1e-12
    assert rel(new2["phi_M"], ref2[1]) < 1e-12 and rel(new2["I_ch"], ref2[2]) < 1e-12


@pytest.mark.parametrize("scheme", ["rk4", "rush_larsen"])
@pytest.mark.parametrize("dtype,tol", K13_DTYPES)
def test_mixed_leak_and_hh_si_tags_are_one_launch(dtype, tol, scheme):
    """The rat neuron's tags, LeakSI (a lane a point) beside HH-SI (8 lanes a
    point, Rush-Larsen under that scheme while LeakSI runs RK4), and the
    astrocyte app's, GlialKirAstro beside HH-Astro: one launch each, equal
    to the plain twin, the pulls into phi_M and every ion's I_ch."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(10)
    kernel = "membrane_rl" if scheme == "rush_larsen" else "membrane_rk4"
    for names, ions, t0, dt, v in (
            (("leak_si", "hh_si"), ["K", "Cl", "Na"], 0.12495, 1e-4, (-0.08, -0.06)),
            (("glial_astro", "hh_astro"), ["K", "Na", "Cl"], 0.3, 0.05, (-80.0, -60.0))):
        sizes = (700, 300)
        mems = [_membrane(nm, n, dtype, dev, rng) for nm, n in zip(names, sizes)]
        table = engine.tag_table([(mm.model, sum(sizes[:j]), n)
                                  for j, (mm, n) in enumerate(zip(mems, sizes))],
                                 sum(sizes), ions, scheme)
        phi_M = torch.as_tensor(rng.uniform(*v, sum(sizes)), dtype=dtype, device=dev)
        pushes = [engine.TagPush(v=(phi_M, sum(sizes[:j]))) for j in range(2)]
        t = torch.tensor(t0, dtype=dtype, device=dev)
        n0 = dict(_cuda.LAUNCHES)
        got = engine.ode_step_tags(table, mems, pushes, t, dt, 25)
        moved = {k: c - n0[k] for k, c in _cuda.LAUNCHES.items() if c != n0[k]}
        assert moved == {kernel: 1}, (names, moved)
        ref = engine.ode_step_tags_plain(table, mems, pushes, t, dt, 25)
        for a, b in zip(got[0], ref[0]):
            for s in range(b.states.shape[0]):
                assert rel(a.states[s], b.states[s]) < tol, (names, s)
            assert rel(a.params, b.params) < tol, names
        assert rel(got[1], ref[1]) < tol, names
        for k in range(len(ions)):
            assert rel(got[2][k], ref[2][k]) < tol, (names, k)


@pytest.mark.parametrize("name", ["emix", "astro", "hh_si"])
@pytest.mark.parametrize("dtype,tol", K13_DTYPES)
def test_ode_run_is_one_launch_equal_to_its_plain_loop(name, dtype, tol):
    """ode_run integrates 200 steps (the calibration systems at one point,
    n_sub = 2, as apps.run_calibration calls it; HH-SI at 100 points on 8
    lanes a point) in one membrane_run launch, equal to the plain loop of
    ode_step_plain, and leaves its input state as it was."""
    dev = cuda_or_skip()
    if name == "hh_si":
        mm = _membrane(name, 100, dtype, dev, np.random.default_rng(11))
        t0, dt, n_sub = 0.12, 1e-4, 25
    else:
        model = (calibration.CalibrationEMIx() if name == "emix"
                 else calibration.CalibrationAstro())
        mm = engine.make_membrane(model, np.zeros((1, 2)), dtype=dtype, device=dev)
        t0, dt, n_sub = 0.0, 0.1, 2
    before = mm.states.clone()
    n0 = dict(_cuda.LAUNCHES)
    got = engine.ode_run(mm, t0, dt, 200, n_sub=n_sub)
    moved = {k: c - n0[k] for k, c in _cuda.LAUNCHES.items() if c != n0[k]}
    assert moved == {"membrane_run": 1}, moved
    assert torch.equal(mm.states, before)
    ref = engine.ode_run_plain(engine.MembraneState(mm.states.cpu(), mm.params.cpu(),
                                                    mm.model), t0, dt, 200, n_sub)
    for s in range(ref.states.shape[0]):
        assert rel(got.states[s], ref.states[s]) < tol, s
    assert rel(got.params, ref.params) < tol


def test_emix_slice_on_cuda_matches_cpu():
    """Two float64 steps of the EMIx fixture on the card go through every
    kernel, reproduce the JAX package's Krylov counts and agree with the
    CPU run."""
    dev = cuda_or_skip()
    Sc, sp = tp.emix_torch()
    sc = Sc.solve_system_active(0.2, 0.0, sp)
    Sg, _ = tp.emix_torch(device=dev)
    _cuda.reset_launches()
    sg = Sg.solve_system_active(0.2, 0.0, sp)
    assert all(_cuda.LAUNCHES[k] > 0 for k in CELL_KERNELS), _cuda.LAUNCHES
    assert _cuda.LAUNCHES["block_jacobi_apply"] == 0
    assert Sg.stats.emi_niters == Sc.stats.emi_niters == [7, 4]
    assert Sg.stats.knp_niters == Sc.stats.knp_niters == [[4, 3], [2, 2]]
    for key in ("phi", "c", "c_elim", "phi_M"):
        assert rel(sg[key], sc[key]) < 1e-8, key


@pytest.fixture(scope="module")
def pair_maps():
    """Interleaved host pair maps of the EMIx fixture (the CPU solver's)."""
    cuda_or_skip()
    S, _ = tp.emix_torch(pair=True)
    return S.pairs_host


def _rand(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)


def _device_kernels(fn, sessions=1, want=0, match=""):
    """Names of the device kernels fn() launches, in order, read by the
    profiler in its second cycle: the first (fn() too) is a warm-up whose
    events are dropped, since a profiling session can miss its first
    launches.  A session on the card can also return fewer device events
    than were launched, or none (seen now and then, for calls that another
    session reads in full): with ``sessions`` > 1 a session that returns
    no event, or fewer than ``want`` whose name holds ``match``, is run
    again, up to that many in all (fn() runs twice more each time).  The
    caller's assertions on the list are unchanged; only a short reading is
    taken again."""
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                                     active=1),
                                    acc_events=True) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names and sum(match in k for k in names) >= want:
            return names
    return names


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_pair_kernels_match_plain(pair_maps, dtype, tol):
    """K12 and K4 equal their plain versions exactly (moves, selects and the
    same additions in the same order); K3 and K5 at nd = 8 to round-off."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(8)
    pm = pairs.pair_maps_to_device(pair_maps, dev)
    npair = pair_maps["int_f"].shape[0]
    nf1 = int(pair_maps["nf"]) + 1
    A = _rand(rng, (2, 4, 4, 2 * npair), dtype, dev)
    Ms = []
    for _ in range(4):
        M = _rand(rng, (2, 4, 4, nf1), dtype, dev)
        M[..., -1] = 0.0                              # the dummy facet
        Ms.append(M)
    n0 = dict(_cuda.LAUNCHES)
    pd, pe = pairs.gather_blocks_pair_multi(None, pm, A, *Ms)
    pd_ref, pe_ref = pairs.gather_blocks_pair_multi_plain(None, pm, A, *Ms)
    assert torch.equal(pd, pd_ref) and torch.equal(pe, pe_ref)
    pd1, pe1 = pairs.gather_blocks_pair(None, pm, A[0].contiguous(),
                                        *(M[0].contiguous() for M in Ms))
    assert torch.equal(pd1, pd[0]) and torch.equal(pe1, pe[0])

    x = _rand(rng, (2, 4, 2 * npair), dtype, dev)
    xp = pairs.to_pair(pm, x)
    assert torch.equal(xp, pairs.to_pair_plain(pm, x))
    assert torch.equal(pairs.from_pair(pm, xp), pairs.from_pair_plain(pm, xp))

    y = pairs.pair_matvec_multi(pd, pe, pm, xp)
    assert rel(y, pairs.pair_matvec_multi_plain(pd, pe, pm, xp)) < tol
    y0 = pairs.pair_matvec(pd[0].contiguous(), pe[0].contiguous(), pm,
                           xp[0].contiguous())
    assert rel(y0, pairs.pair_matvec_plain(pd[0], pe[0], pm, xp[0])) < tol

    eye = torch.eye(8, dtype=dtype, device=dev)[None, :, :, None]
    P = (0.1 * pd + 8.0 * eye).contiguous()            # dominant diagonal
    inv = spmv.block_jacobi_inverse(P)
    assert rel(inv, spmv.block_jacobi_inverse_plain(P)) < 10 * tol
    assert rel(spmv.block_jacobi_apply(inv, xp), spmv.block_jacobi_apply_plain(inv, xp)) < tol
    for k, n in {"gather_blocks_pair": 2, "to_pair": 1, "from_pair": 1,
                 "pair_matvec": 2, "block_jacobi_inverse_nd8": 1,
                 "block_jacobi_apply_nd8": 1}.items():
        assert _cuda.LAUNCHES[k] == n0[k] + n, k


# (systems, pairs) of the halves apply: the EMI and KNP solves' sizes and a
# small odd one in three systems
BJ_HALVES_SIZES = [(1, 63558), (2, 63558), (3, 1001)]


def _halves_inverse(rng, m, npair, dtype, dev):
    """A pair-layout inverse as the solver makes it: dominant 8 x 8 blocks
    times the halves mask, a tenth of the pairs self-pairs whose second
    half is an identity block, through kernel B's inverse (its zeros carry
    the elimination's signs); and r, zero on the dead halves, with the live
    entries' mask.  m = 1: the unbatched form."""
    eye = torch.eye(8, dtype=dtype, device=dev)[None, :, :, None]
    halves = torch.as_tensor(np.kron(np.eye(2), np.ones((4, 4)))[:, :, None], dtype=dtype,
                             device=dev)
    P = (0.3 * _rand(rng, (m, 8, 8, npair), dtype, dev) + 4.0 * eye) * halves
    dead = torch.as_tensor(rng.random(npair) < 0.1, device=dev)
    P[:, 4:, 4:, dead] = torch.eye(4, dtype=dtype, device=dev)[None, :, :, None]
    live = torch.ones((m, 8, npair), dtype=torch.bool, device=dev)
    live[:, 4:, dead] = False
    r = _rand(rng, (m, 8, npair), dtype, dev) * live
    if m == 1:
        P, r, live = P[0], r[0], live[0]
    return spmv.block_jacobi_inverse(P.contiguous()), r.contiguous(), live


@pytest.mark.parametrize("m,npair", BJ_HALVES_SIZES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_block_jacobi_halves_equals_the_full_form_bitwise(m, npair, dtype, tol):
    """K5's halves apply (a thread per system, half and pair, reading the
    diagonal sub-blocks only) equals the full-form apply on the same halves
    inverse bit for bit on the live entries and in value everywhere, one
    launch a call, through the operands with and without their buffer; the
    full form against its plain version to round-off."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(22)
    inv, r, live = _halves_inverse(rng, m, npair, dtype, dev)
    n0 = _cuda.LAUNCHES["block_jacobi_apply_nd8"]
    got = spmv.block_jacobi_apply(spmv.block_jacobi_operands(inv, halves=True), r)
    full = spmv.block_jacobi_apply(inv, r)
    assert _cuda.LAUNCHES["block_jacobi_apply_nd8"] == n0 + 2
    assert torch.equal(got, full)
    assert torch.equal(_bits(got)[live], _bits(full)[live])
    assert rel(full, spmv.block_jacobi_apply_plain(inv, r)) < tol
    assert rel(got, spmv.block_jacobi_apply_plain(inv, r, halves=True)) < tol
    for buffer in (False, True):
        op = spmv.block_jacobi_operands(inv, halves=True, buffer=buffer)
        for _ in range(3):
            z = spmv.block_jacobi_apply(op, r)
            assert torch.equal(_bits(z), _bits(got)) and (z is op.buf) == buffer


def test_block_jacobi_apply_is_one_launch_and_allocates_nothing_with_its_buffer():
    """Five applies of the pair KNP solve's halves operands with their
    buffer are five bj_apply_kernel launches, nothing else on the device,
    and no allocation (the caching allocator's count); the cell form
    without a buffer is one launch a call too."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(24)
    inv, r, _ = _halves_inverse(rng, 2, 63558, torch.float64, dev)
    op = spmv.block_jacobi_operands(inv, halves=True, buffer=True)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]

    def applies():
        for _ in range(5):
            spmv.block_jacobi_apply(op, r)

    kernels = _device_kernels(applies, sessions=3, want=5, match="bj_apply_kernel")
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
    assert len(kernels) == 5 and all("bj_apply_kernel" in k for k in kernels), kernels
    P = (_rand(rng, (4, 4, 1000), torch.float64, dev)
         + 8.0 * torch.eye(4, dtype=torch.float64, device=dev)[:, :, None])
    cell = spmv.block_jacobi_operands(spmv.block_jacobi_inverse(P.contiguous()))
    x = _rand(rng, (4, 1000), torch.float64, dev)
    kernels = _device_kernels(lambda: spmv.block_jacobi_apply(cell, x), sessions=3, want=1,
                              match="bj_apply_kernel")
    assert len(kernels) == 1 and "bj_apply_kernel" in kernels[0], kernels


def test_block_jacobi_operands_refuse_what_the_kernel_cannot_take():
    """Halves at nd = 4 (ValueError) and nd = 6 (no kernel), operands of CPU
    tensors on a CUDA r, and an r of another shape, dtype or layout raise."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(25)
    P4 = _rand(rng, (4, 4, 64), torch.float64, dev)
    with pytest.raises(ValueError):
        spmv.block_jacobi_operands(P4, halves=True)
    with pytest.raises(NotImplementedError):
        spmv.block_jacobi_operands(_rand(rng, (6, 6, 64), torch.float64, dev), halves=True)
    inv, r, _ = _halves_inverse(rng, 2, 101, torch.float64, dev)
    op = spmv.block_jacobi_operands(inv, halves=True)
    with pytest.raises(ValueError):
        spmv.block_jacobi_apply(spmv.block_jacobi_operands(inv.cpu(), halves=True), r)
    for bad in (r[:1].contiguous(), r.float(), r.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError):
            spmv.block_jacobi_apply(op, bad)


def _pair_diagonal(rng, m, npair, dtype, dev):
    """An unmasked pair diagonal as the step hands it to the inverse:
    dominant 8 x 8 blocks, a tenth of the pairs self-pairs whose second
    half is an identity block (their cross blocks are zero in the emit);
    m = 1: the unbatched form."""
    eye = torch.eye(8, dtype=dtype, device=dev)[None, :, :, None]
    P = 0.3 * _rand(rng, (m, 8, 8, npair), dtype, dev) + 4.0 * eye
    dead = torch.as_tensor(rng.random(npair) < 0.1, device=dev)
    P[:, 4:, 4:, dead] = torch.eye(4, dtype=dtype, device=dev)[None, :, :, None]
    P[:, :4, 4:, dead] = 0.0
    P[:, 4:, :4, dead] = 0.0
    return (P[0] if m == 1 else P).contiguous()


HALVES = torch.as_tensor(np.kron(np.eye(2), np.ones((4, 4)))[:, :, None])


@pytest.mark.parametrize("m,npair", BJ_HALVES_SIZES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_block_jacobi_halves_inverse_equals_the_full_form_bitwise(m, npair, dtype, tol):
    """K5's halves inverse (a thread per system, half and pair, reading the
    unmasked diagonal's two 4 x 4 sub-blocks) equals the full-form kernel
    on the masked diagonal (the parent's route) bit for bit on every
    nonzero value and in value everywhere, its off-diagonal blocks +0; its
    plain twin to round-off (the kernel's elimination contracts into fused
    multiply-adds, as the full form's does); one launch a call; into a
    zeroed buffer, and from a view whose systems lie apart, the same bits;
    a buffer with values off the halves raises."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(26)
    P = _pair_diagonal(rng, m, npair, dtype, dev)
    n0 = _cuda.LAUNCHES["block_jacobi_inverse_nd8"]
    got = spmv.block_jacobi_inverse(P, halves=True)
    full = spmv.block_jacobi_inverse((P * HALVES.to(dev, dtype)).contiguous())
    assert _cuda.LAUNCHES["block_jacobi_inverse_nd8"] == n0 + 2
    nz = full != 0
    assert torch.equal(got, full) and torch.equal(_bits(got)[nz], _bits(full)[nz])
    for a, b in ((slice(0, 4), slice(4, 8)), (slice(4, 8), slice(0, 4))):
        assert not _bits(got[..., a, b, :]).any()
    assert rel(got, spmv.block_jacobi_inverse_plain(P, halves=True)) < 10 * tol
    out = torch.zeros_like(P)
    for _ in range(3):
        assert spmv.block_jacobi_inverse(P, halves=True, out=out) is out
        assert torch.equal(_bits(out), _bits(got))
    if m > 1:
        big = torch.zeros((m, 3) + tuple(P.shape[1:]), dtype=dtype, device=dev)
        big[:, 1] = P
        assert torch.equal(_bits(spmv.block_jacobi_inverse(big[:, 1], halves=True)), _bits(got))
    out[..., 0, 5, 0] = 1.0
    with pytest.raises(ValueError):
        spmv.block_jacobi_inverse(P, halves=True, out=out)


@pytest.mark.parametrize("nd", [3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_jacobi_inverse_of_a_strided_view_equals_the_contiguous_bitwise(nd, dtype):
    """The inverse of slot 0 of an (m, K, nd, nd, nc) operator read in
    place equals the inverse of its contiguous copy bit for bit, into a
    new tensor or a buffer (no allocation a call with the buffer, one
    kernel a call); a view not cells-last raises."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(27)
    nc = 124416 if nd == 4 else 5001
    B = _rand(rng, (2, 5, nd, nd, nc), dtype, dev) * 0.3
    B[:, 0] += 4.0 * torch.eye(nd, dtype=dtype, device=dev)[:, :, None]
    view = B[:, 0]
    assert not view.is_contiguous()
    ref = spmv.block_jacobi_inverse(view.contiguous())
    assert torch.equal(_bits(spmv.block_jacobi_inverse(view)), _bits(ref))
    out = torch.empty_like(ref)
    spmv.block_jacobi_inverse(view, out=out)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    kernels = _device_kernels(lambda: spmv.block_jacobi_inverse(view, out=out), sessions=3,
                              want=1, match="bj_inverse_kernel")
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
    assert len(kernels) == 1 and "bj_inverse_kernel" in kernels[0], kernels
    assert torch.equal(_bits(out), _bits(ref))
    with pytest.raises(ValueError):
        spmv.block_jacobi_inverse(B.transpose(-2, -3)[:, 0])


def test_pair_kernels_refuse_unported_maps(pair_maps):
    """Sharded maps (live0) and index-map (cell_col) maps raise on the
    card instead of running plain."""
    dev = cuda_or_skip()
    pm = pairs.pair_maps_to_device(pair_maps, dev)
    npair = pair_maps["int_f"].shape[0]
    x = torch.ones((4, 2 * npair), dtype=torch.float64, device=dev)
    sharded = dict(pm, live0=torch.ones(npair, dtype=torch.bool, device=dev))
    with pytest.raises(NotImplementedError):
        pairs.to_pair(sharded, x)
    with pytest.raises(NotImplementedError):
        pairs.to_pair(dict(pm, cell_col=pm["pid"]), x)
    with pytest.raises(ValueError):
        pairs.from_pair(pm, torch.ones((npair, 8), dtype=torch.float64,
                                       device=dev).t())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_to_pair_list_form_equals_the_stack(pair_maps, dtype):
    """to_pair of a list of vectors (the solver's EMI 3 and KNP 2) reads
    them in one launch and equals to_pair of their stack and the plain
    version exactly; out= receives the result; a source that starts at an
    odd element (no pair load) raises."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(9)
    pm = pairs.pair_maps_to_device(pair_maps, dev)
    nc2 = 2 * pair_maps["int_f"].shape[0]
    for shape, k in (((4, nc2), 3), ((2, 4, nc2), 2)):
        xs = [_rand(rng, shape, dtype, dev) for _ in range(k)]
        n0 = _cuda.LAUNCHES["to_pair"]
        got = pairs.to_pair(pm, xs)
        assert _cuda.LAUNCHES["to_pair"] == n0 + 1
        stack = torch.stack(xs)
        assert torch.equal(got, pairs.to_pair(pm, stack))
        assert torch.equal(got, pairs.to_pair_plain(pm, stack))
        out = torch.full_like(got, float("nan"))
        assert pairs.to_pair(pm, tuple(xs), out=out) is out and torch.equal(out, got)
    flat = _rand(rng, (4 * nc2 + 1,), dtype, dev)
    with pytest.raises(ValueError):
        pairs.to_pair(pm, [flat[1:].view(4, nc2)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_from_pair_forms_equal_plain_in_one_launch(pair_maps, dtype):
    """from_pair in its three forms (the relayout, add in pair form, base in
    cell form), one vector and a stack: exactly the plain version, one
    kernel each and no separate add (the profiler), no allocation with out=
    (the allocator's count); operands it cannot take raise before a
    launch."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(10)
    pm = pairs.pair_maps_to_device(pair_maps, dev)
    npair = pair_maps["int_f"].shape[0]
    for lead in ((), (2,)):
        xp, add = (_rand(rng, lead + (8, npair), dtype, dev) for _ in range(2))
        base = _rand(rng, lead + (4, 2 * npair), dtype, dev)
        forms = [{}, {"add": add}, {"base": base}]
        outs = [torch.full_like(base, float("nan")) for _ in forms]
        for kw in forms:
            assert torch.equal(pairs.from_pair(pm, xp, **kw),
                               pairs.from_pair_plain(pm, xp, **kw))
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        n0 = _cuda.LAUNCHES["from_pair"]

        ncalls = [0]

        def calls():
            ncalls[0] += 1
            for kw, out in zip(forms, outs):
                assert pairs.from_pair(pm, xp, out=out, **kw) is out

        kernels = _device_kernels(calls, sessions=3, want=3)
        assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
        assert _cuda.LAUNCHES["from_pair"] == n0 + 3 * ncalls[0]
        assert len(kernels) == 3 and all("from_pair_kernel" in k for k in kernels), kernels
        for kw, out in zip(forms, outs):
            assert torch.equal(out, pairs.from_pair_plain(pm, xp, **kw))
    n0 = _cuda.LAUNCHES["from_pair"]
    with pytest.raises(ValueError, match="not both"):
        pairs.from_pair(pm, xp, add=add, base=base)
    with pytest.raises(ValueError):                      # add that would broadcast
        pairs.from_pair(pm, xp, add=add[:1])
    with pytest.raises(ValueError):                      # base on the CPU
        pairs.from_pair(pm, xp, base=base.cpu())
    flat = _rand(rng, (base.numel() + 1,), dtype, dev)
    with pytest.raises(ValueError, match="even element"):
        pairs.from_pair(pm, xp, base=flat[1:].view(base.shape))
    with pytest.raises(ValueError, match="even element"):
        pairs.from_pair(pm, xp, out=flat[1:].view(base.shape))
    with pytest.raises(TypeError):                       # out of another dtype
        pairs.from_pair(pm, xp, out=torch.empty(base.shape, dtype=torch.float16, device=dev))
    assert _cuda.LAUNCHES["from_pair"] == n0


def test_emix_pair_slice_on_cuda_matches_cpu():
    """Two float64 steps of the EMIx fixture on the pair layout: the card
    goes through every pair-path kernel, reproduces the JAX package's
    Krylov counts and agrees with the CPU run."""
    dev = cuda_or_skip()
    Sc, sp = tp.emix_torch(pair=True)
    sc = unpad_state(Sc, Sc.solve_system_active(0.2, 0.0, sp))
    Sg, _ = tp.emix_torch(device=dev, pair=True)
    _cuda.reset_launches()
    f0 = krylov.PCG_LOOKAHEAD["frozen"]
    sg = unpad_state(Sg, Sg.solve_system_active(0.2, 0.0, sp))
    frozen = krylov.PCG_LOOKAHEAD["frozen"] - f0
    assert all(_cuda.LAUNCHES[k] > 0 for k in PAIR_KERNELS), _cuda.LAUNCHES
    assert _cuda.LAUNCHES["bell_matvec"] == 0
    assert Sg.stats.emi_niters == Sc.stats.emi_niters == [3, 9]
    assert Sg.stats.knp_niters == Sc.stats.knp_niters == [[11, 8], [9, 5]]
    # one launch of each K8 entry per PCG iteration, live or frozen (at
    # most one frozen iteration after each solve's exit); one from_pair
    # (with its add) per solve
    assert frozen <= 2
    assert _cuda.LAUNCHES["pcg_dot2_direction"] == _cuda.LAUNCHES["pcg_dot"] == \
        _cuda.LAUNCHES["pcg_update"] == 3 + 9 + frozen
    assert _cuda.LAUNCHES["from_pair"] == 2 * 2
    for key in ("phi", "c", "c_elim", "phi_M"):
        assert rel(sg[key], sc[key]) < 1e-8, key


# K6 (m = 1, the EMI data with or without its deflation groups) and K7
# (m = 2, the KNP data: no deflation, with or without As)
TWO_LEVEL_CASES = {"k6_full": (None, ("As", "comp", "mom", "ritz")),
                   "k6_coarse": (None, ("As",)), "k6_refined": (None, ("As", "comp")),
                   "k7": (2, ()), "k7_refined": (2, ("As",))}
# the cell layout's main-path coarse size: 1,944 chunks of 64, the last
# one 24 cells short
MAIN_NC = 1944 * 64 - 24


@functools.lru_cache(maxsize=None)
def _coarse_numpy(case, nd, nc, agg):
    rng = np.random.default_rng(41)
    m, groups = TWO_LEVEL_CASES[case]
    d = tp.two_level_data(rng, nd, nc, agg, groups, m)
    return d, rng.standard_normal((2, m or 1, nd, nc))


def _coarse_case(case, nd, dtype, dev, nc=5000, agg=64):
    d, (r, out0) = _coarse_numpy(case, nd, nc, agg)
    data = {k: torch.as_tensor(v, dtype=dtype, device=dev) for k, v in d.items()}
    co = coarse.operands(data, agg, batched=TWO_LEVEL_CASES[case][0] is not None)
    return co, torch.as_tensor(r, dtype=dtype, device=dev), torch.as_tensor(
        out0, dtype=dtype, device=dev)


@pytest.mark.parametrize("case", sorted(TWO_LEVEL_CASES))
@pytest.mark.parametrize("nd", [4, 8])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_two_level_kernels_match_plain(case, nd, dtype, tol):
    """restrict, solve and prolong_add against their plain versions on the
    same CUDA tensors; a second launch repeats the first bit for bit (no
    atomics)."""
    dev = cuda_or_skip()
    co, r, out0 = _coarse_case(case, nd, dtype, dev)
    n0 = dict(_cuda.LAUNCHES)
    rc, proj = (t.clone() for t in coarse.restrict(co, r))     # the workspace's buffers
    rc_p, proj_p = coarse.restrict_plain(co, r)
    assert rel(rc, rc_p) < tol and (proj.numel() == 0 or rel(proj, proj_p) < tol)
    zc, coef = coarse.solve(co, rc_p, proj_p)
    zc_p, coef_p = coarse.solve_plain(co, rc_p, proj_p)
    assert rel(zc, zc_p) < 10 * tol and (coef.numel() == 0 or rel(coef, coef_p) < 10 * tol)
    out = coarse.prolong_add(co, out0.clone(), zc_p, coef_p)
    assert rel(out, coarse.prolong_add_plain(co, out0.clone(), zc_p, coef_p)) < tol
    names = [coarse._name(e, co) for e in ("restrict", "solve", "prolong")]
    for name in names:
        assert _cuda.LAUNCHES[name] == n0[name] + 1, name
    again = coarse.coarse_add(co, out0.clone(), r)
    assert torch.equal(again, coarse.coarse_add(co, out0.clone(), r))
    assert torch.equal(coarse.restrict(co, r)[1], proj)


def test_two_level_wrappers_raise_on_what_they_cannot_take():
    dev = cuda_or_skip()
    co, r, out0 = _coarse_case("k6_full", 4, torch.float64, dev)
    with pytest.raises(ValueError):                      # not contiguous
        coarse.restrict(co, r.transpose(1, 2).contiguous().transpose(1, 2))
    d, _ = _coarse_numpy("k6_full", 4, 5000, 64)
    co_cpu = coarse.operands({k: torch.as_tensor(v) for k, v in d.items()}, 64, False)
    with pytest.raises(ValueError):                      # operands on the CPU
        coarse.restrict(co_cpu, r)
    mixed = {k: torch.as_tensor(v, device=dev) for k, v in d.items()}
    mixed["mom_W"] = mixed["mom_W"].cpu()
    with pytest.raises(ValueError):                      # operands on two devices
        coarse.operands(mixed, 64, False)
    with pytest.raises(TypeError):                       # dtype mismatch
        coarse.prolong_add(co, out0.float(), *coarse.solve(co, *coarse.restrict(co, r)))
    co3, r3, _ = _coarse_case("k7", 4, torch.float64, dev)
    with pytest.raises(NotImplementedError):             # nd = 2
        coarse.restrict(co3, r3[:, :2].contiguous())


@pytest.mark.parametrize("case", sorted(TWO_LEVEL_CASES))
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_two_level_solve_at_the_main_path_size(case, dtype, tol):
    """The one-launch solve at the cell layout's coarse size (n = 1,944)
    through the workspace, as the apply calls it (on restrict's buffers),
    against solve_plain; 200 calls repeat the first bit for bit, and the
    last one writes its outputs (NaN before it)."""
    dev = cuda_or_skip()
    co, r, _ = _coarse_case(case, 4, dtype, dev, nc=MAIN_NC)
    wk = co.work
    assert wk.n == 1944
    rc_p, proj_p = coarse.restrict_plain(co, r)
    wk.rc.copy_(rc_p)
    wk.proj.copy_(proj_p)
    n0 = _cuda.LAUNCHES["two_level_solve"], _cuda.LAUNCHES["two_level_solve_batched"]
    zc, coef = coarse.solve(co, wk.rc, wk.proj)
    assert zc is wk.zc and coef is wk.coef
    zc_p, coef_p = coarse.solve_plain(co, rc_p, proj_p)
    assert rel(zc, zc_p) < 10 * tol and (coef.numel() == 0 or rel(coef, coef_p) < 10 * tol)
    first = zc.clone(), coef.clone()
    for _ in range(198):
        coarse.solve(co, wk.rc, wk.proj)
    zc.fill_(float("nan"))
    coef.fill_(float("nan"))
    coarse.solve(co, wk.rc, wk.proj)
    torch.cuda.synchronize()
    assert torch.equal(zc, first[0]) and torch.equal(coef, first[1])
    n1 = _cuda.LAUNCHES["two_level_solve"], _cuda.LAUNCHES["two_level_solve_batched"]
    assert (n1[0] - n0[0], n1[1] - n0[1]) == ((0, 200) if co.batched else (200, 0))


@pytest.mark.parametrize("case", ["k6_full", "k7"])
def test_two_level_solve_is_one_launch_and_allocates_nothing(case):
    """Five solves through the workspace are five device kernels, all of
    the solve kernel (the profiler, after a warm-up cycle of five), and no
    allocation (the caching allocator's count)."""
    dev = cuda_or_skip()
    co, r, _ = _coarse_case(case, 4, torch.float64, dev)
    rc, proj = coarse.restrict(co, r)
    coarse.solve(co, rc, proj)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]

    def solves():
        for _ in range(5):
            coarse.solve(co, rc, proj)

    kernels = _device_kernels(solves, sessions=3, want=5)
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
    assert len(kernels) == 5 and all("tl_solve_kernel" in k for k in kernels), kernels


# the three-level forms (d1inv; coarse.solve_ordered_plain and
# coarse_apply_ordered_plain are their twins in the kernels' order): K6's
# solve on the EMI apply's operands (As and the three deflation groups, As
# alone, neither) and K7's on a KNP pair of ions (with and without As); the
# one-launch apply (no fields, no As) at nd = 4 and 8.  Sizes: the small
# fixture's 243 chunks in 61 super-chunks of 4 (one padded) and the
# 995,328-tet mesh's 15,552 chunks in 3,888
THREE_CASES = {"k6_full": (None, ("As", "comp", "mom", "ritz")), "k6_coarse": (None, ("As",)),
               "k6_plain": (None, ()), "k7": (2, ()), "k7_refined": (2, ("As",))}
THREE_NC = {"small": 243 * 64 - 5, "scale": 995328}


@functools.lru_cache(maxsize=None)
def _three_numpy(case, nd, size):
    rng = np.random.default_rng(43)
    m, groups = THREE_CASES[case]
    nc = THREE_NC[size]
    d = tp.three_level_data(rng, nd, nc, 64, groups, m, spd=size == "small")
    n_agg = -(-nc // 64)
    return d, rng.standard_normal((m or 1, n_agg)), rng.standard_normal((2, m or 1, nd, nc))


def _three_case(case, nd, size, dtype, dev):
    d, rc, (r, out0) = _three_numpy(case, nd, size)
    data = {k: torch.as_tensor(v, dtype=dtype, device=dev) for k, v in d.items()}
    co = coarse.operands(data, 64, batched=THREE_CASES[case][0] is not None)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return co, t(rc), t(r), t(out0)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("size", ["small", "scale"])
@pytest.mark.parametrize("case", sorted(THREE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_three_level_solve_equals_its_ordered_twin(size, case, dtype):
    """The three-level solve (one launch of tl_solve_kernel<T, true>) on the
    workspace's buffers equals coarse.solve_ordered_plain bit for bit (zc
    and the deflation coefficients), counts one two_level_solve_three
    launch a call, and repeats from call to call; at both sizes, K6's and
    K7's operands, with and without As and the deflation groups."""
    dev = cuda_or_skip()
    co, rc, _, _ = _three_case(case, 4, size, dtype, dev)
    wk = co.work
    n_agg, n2, k2 = co.levels
    assert (n_agg, n2, k2) == ((243, 61, 4) if size == "small" else (15552, 3888, 4))
    proj = torch.randn((wk.m, sum(co.sizes)), dtype=dtype, device=dev,
                       generator=torch.Generator(dev).manual_seed(3))
    wk.rc.copy_(rc)
    wk.proj.copy_(proj)
    name = coarse._name("solve", co)
    assert name == "two_level_solve_three" + ("_batched" if co.batched else "")
    n0 = _cuda.LAUNCHES[name]
    zc, coef = coarse.solve(co, wk.rc, wk.proj)
    zo, co_ = coarse.solve_ordered_plain(co, rc, proj)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == n0 + 1
    assert torch.equal(_bits(zc), _bits(zo))
    assert torch.equal(_bits(coef), _bits(co_))
    zp, cp = coarse.solve_plain(co, rc, proj)
    assert rel(zc, zp) < (1e-4 if dtype == torch.float32 else 1e-11)
    first = zc.clone(), coef.clone()
    zc.fill_(float("nan"))
    coarse.solve(co, wk.rc, wk.proj)
    torch.cuda.synchronize()
    assert torch.equal(_bits(zc), _bits(first[0])) and torch.equal(_bits(coef), _bits(first[1]))


@pytest.mark.parametrize("size", ["small", "scale"])
@pytest.mark.parametrize("nd", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_three_level_coarse_equals_its_ordered_twin(size, nd, dtype):
    """The three-level one-launch apply (tl_coarse_kernel<T, ND, BJ, true>)
    of two ions equals coarse.coarse_apply_ordered_plain bit for bit,
    unmasked and masked, and the three launches (restrict, the three-level
    solve, prolong_add) bit for bit; at nd = 4 also the folded form
    (kernel B's apply in place of out) against kernel B then the twin.
    One two_level_coarse_three_batched launch a call."""
    dev = cuda_or_skip()
    co, _, r, out0 = _three_case("k7", nd, size, dtype, dev)
    assert co.work.fused is not None
    mask = (torch.rand((nd, r.shape[-1]), generator=torch.Generator(dev).manual_seed(4),
                       device=dev) > 0.1).to(dtype)
    name = "two_level_coarse_three_batched"
    for mk in (None, mask):
        n0 = _cuda.LAUNCHES[name]
        got = coarse.coarse_add(co, out0.clone(), r, mk)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[name] == n0 + 1
        twin = coarse.coarse_apply_ordered_plain(co, out0.clone(), r, mk)
        assert torch.equal(_bits(got), _bits(twin))
        three = coarse.prolong_add(co, out0.clone(), *coarse.solve(co, *coarse.restrict(co, r)),
                                   mk)
        assert torch.equal(_bits(got), _bits(three))
        plain = coarse.coarse_apply_plain(co, out0.clone(), r, mk)
        assert rel(got, plain) < (1e-5 if dtype == torch.float32 else 1e-12)
    if nd != 4:
        return
    P = _rand(np.random.default_rng(44), (2, 4, 4, r.shape[-1]), dtype, dev)
    P[:, range(4), range(4), :] += 4.0
    bj = spmv.block_jacobi_operands(spmv.block_jacobi_inverse(P))
    z = spmv.block_jacobi_apply(bj, r)
    for mk in (None, mask):
        got = coarse.coarse_add(co, torch.empty_like(r), r, mk, bj)
        twin = coarse.coarse_apply_ordered_plain(co, z.clone(), r, mk)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(twin))


@pytest.mark.parametrize("form", ["k6t", "k7t"])
def test_three_level_forms_are_one_launch_and_allocate_nothing(form):
    """Five three-level solves (K6's operands) or one-launch applies (K7's)
    at the 995,328-tet shapes are five device kernels of that kernel (the
    profiler, after a warm-up cycle) and allocate nothing (the caching
    allocator's count)."""
    dev = cuda_or_skip()
    case = "k6_full" if form == "k6t" else "k7"
    co, rc, r, out0 = _three_case(case, 4, "scale", torch.float64, dev)
    wk = co.work
    wk.rc.copy_(rc)
    wk.proj.zero_()
    out = out0.clone()
    if form == "k6t":
        fn, kernel = (lambda: coarse.solve(co, wk.rc, wk.proj)), "tl_solve_kernel"
    else:
        fn, kernel = (lambda: coarse.coarse_add(co, out, r)), "tl_coarse_kernel"
    fn()
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]

    def five():
        for _ in range(5):
            fn()

    kernels = _device_kernels(five, sessions=3, want=5)
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
    assert len(kernels) == 5 and all(kernel in k for k in kernels), kernels


def test_three_level_forms_replay_in_a_graph():
    """The three-level solve and one-launch apply allocate nothing and keep
    fixed pointers, so a captured call of each replays: the outputs equal
    the eager calls' to the last bit."""
    dev = cuda_or_skip()
    co6, rc, _, _ = _three_case("k6_full", 4, "small", torch.float64, dev)
    co7, _, r, out0 = _three_case("k7", 4, "small", torch.float64, dev)
    wk = co6.work
    wk.rc.copy_(rc)
    wk.proj.normal_(generator=torch.Generator(dev).manual_seed(5))
    zc, coef = (t.clone() for t in coarse.solve(co6, wk.rc, wk.proj))
    eager = coarse.coarse_add(co7, out0.clone(), r)
    out = out0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        coarse.solve(co6, wk.rc, wk.proj)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        coarse.solve(co6, wk.rc, wk.proj)
        coarse.coarse_add(co7, out, r)
    for _ in range(3):
        wk.zc.zero_()
        wk.coef.zero_()
        out.copy_(out0)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(wk.zc, zc) and torch.equal(wk.coef, coef)
    assert torch.equal(out, eager)


# the MMS path's largest mesh, mms_square(7): 32,768 triangles, 512 chunks
MMS_NC = 32768


def _nd3_system(rng, m, dtype, dev, nc=MMS_NC):
    """A 2D block system at the MMS path's largest size: K = 4 slots of
    3 x 3 blocks (dominant diagonal), a random neighbour table, x."""
    nbr = rng.integers(0, nc, (4, nc))
    nbr[0] = np.arange(nc)
    B = rng.standard_normal((m, 4, 3, 3, nc))
    B[:, 0, range(3), range(3), :] += 4.0
    return (torch.as_tensor(B, dtype=dtype, device=dev),
            torch.as_tensor(nbr, dtype=torch.int32, device=dev),
            _rand(rng, (m, 3, nc), dtype, dev))


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_nd3_kernels_match_plain_at_the_mms_size(dtype, tol):
    """The 2D instantiations at the MMS path's largest shapes (32,768
    cells): K1 at nd = 3, K = 4 (one system and two), K5's inverse and
    apply at nd = 3, and K6's restrict, solve and prolong-add at nd = 3 on
    the EMI apply's operands (As and compartment one-hots) and on a KNP
    ion's (neither), each against its plain version elementwise to each
    value's sum of |terms| (the solve and the inverse: 10 x tol
    relative); each call one launch of its _nd3 counter (the solve's:
    two_level_solve)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(29)
    B, nb, x = _nd3_system(rng, 2, dtype, dev)
    n0 = dict(_cuda.LAUNCHES)
    got = spmv.bell_matvec_multi(B, nb, x)
    scale = spmv.bell_matvec_multi_plain(B.abs(), nb, x.abs())
    assert float(((got - spmv.bell_matvec_multi_plain(B, nb, x)).abs() / scale).max()) < tol
    B0, x0 = B[0].contiguous(), x[0].contiguous()
    got = spmv.bell_matvec(B0, nb, x0)
    scale = spmv.bell_matvec_plain(B0.abs(), nb, x0.abs())
    assert float(((got - spmv.bell_matvec_plain(B0, nb, x0)).abs() / scale).max()) < tol
    assert _cuda.LAUNCHES["bell_matvec_nd3"] == n0["bell_matvec_nd3"] + 2
    assert _cuda.LAUNCHES["bell_matvec"] == n0["bell_matvec"]
    P = B[:, 0].contiguous()
    inv = spmv.block_jacobi_inverse(P)
    assert rel(inv, spmv.block_jacobi_inverse_plain(P)) < 10 * tol
    op = spmv.block_jacobi_operands(inv[0].contiguous())
    z = spmv.block_jacobi_apply(op, x0)
    scale = spmv.block_jacobi_apply_plain(op.Pinv.abs(), x0.abs())
    assert float(((z - spmv.block_jacobi_apply_plain(op.Pinv, x0)).abs() / scale).max()) < tol
    for name in ("block_jacobi_inverse_nd3", "block_jacobi_apply_nd3"):
        assert _cuda.LAUNCHES[name] == n0[name] + 1, name
    for groups in (("As", "comp"), ()):
        d = tp.two_level_data(rng, 3, MMS_NC, 64, groups)
        co = coarse.operands({k: torch.as_tensor(v, dtype=dtype, device=dev)
                              for k, v in d.items()}, 64, batched=False)
        assert co.work.n == 512
        r = x0[None].contiguous()
        n1 = dict(_cuda.LAUNCHES)
        rc, proj = (t.clone() for t in coarse.restrict(co, r))
        rc_p, proj_p = coarse.restrict_plain(co, r)
        rc_s, proj_s = coarse.restrict_plain(co._replace(
            OH=None if co.OH is None else co.OH.abs()), r.abs())
        assert float(((rc - rc_p).abs() / rc_s).max()) < tol
        assert proj.numel() == 0 or float(((proj - proj_p).abs() / proj_s).max()) < tol
        zc, coef = coarse.solve(co, rc_p, proj_p)
        zc_p, coef_p = coarse.solve_plain(co, rc_p, proj_p)
        assert rel(zc, zc_p) < 10 * tol and (coef.numel() == 0 or rel(coef, coef_p) < 10 * tol)
        out = coarse.prolong_add(co, x0[None].clone(), zc_p, coef_p)
        assert rel(out, coarse.prolong_add_plain(co, x0[None].clone(), zc_p, coef_p)) < tol
        # at nd = 3 even the KNP operands (no fields, no As) take the three
        # launches: the one-launch apply is built for nd = 4 and 8
        again = coarse.coarse_add(co, x0[None].clone(), r)
        assert torch.equal(again, coarse.prolong_add(
            co, x0[None].clone(), *coarse.solve(co, *coarse.restrict(co, r))))
        for name in ("two_level_restrict_nd3", "two_level_solve", "two_level_prolong_nd3"):
            assert _cuda.LAUNCHES[name] == n1[name] + 3, name
        for name in ("two_level_restrict", "two_level_prolong", "two_level_coarse"):
            assert _cuda.LAUNCHES[name] == n1[name], name


def test_nd3_kernels_are_one_launch_and_allocate_nothing():
    """At the MMS path's largest size, five K1 matvecs at nd = 3 are five
    bell_matvec_kernel launches; five K5 applies through operands with
    their buffer five bj_apply_kernel launches and no allocation; five K6
    solves through the workspace of nd = 3 operands five tl_solve_kernel
    launches and no allocation (the profiler, the caching allocator's
    count)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(31)
    B, nb, x = _nd3_system(rng, 1, torch.float64, dev)
    B0, x0 = B[0].contiguous(), x[0].contiguous()

    def matvecs():
        for _ in range(5):
            spmv.bell_matvec(B0, nb, x0)

    kernels = _device_kernels(matvecs, sessions=3, want=5, match="bell_matvec_kernel")
    assert len(kernels) == 5 and all("bell_matvec_kernel" in k for k in kernels), kernels
    op = spmv.block_jacobi_operands(spmv.block_jacobi_inverse(B0[0].contiguous()),
                                    buffer=True)
    d = tp.two_level_data(rng, 3, MMS_NC, 64, ("As", "comp"))
    co = coarse.operands({k: torch.as_tensor(v, device=dev) for k, v in d.items()}, 64,
                         batched=False)
    rc, proj = coarse.restrict(co, x0[None].contiguous())
    spmv.block_jacobi_apply(op, x0)
    coarse.solve(co, rc, proj)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]

    def applies():
        for _ in range(5):
            spmv.block_jacobi_apply(op, x0)

    def solves():
        for _ in range(5):
            coarse.solve(co, rc, proj)

    kernels = _device_kernels(applies, sessions=3, want=5, match="bj_apply_kernel")
    assert len(kernels) == 5 and all("bj_apply_kernel" in k for k in kernels), kernels
    kernels = _device_kernels(solves, sessions=3, want=5)
    assert len(kernels) == 5 and all("tl_solve_kernel" in k for k in kernels), kernels
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs


def test_mms_path_on_the_card_matches_the_cpu():
    """The MMS path through the entry points at res 3 (128 triangles), the
    solver on the card by default: the direct run's fields
    equal the CPU's to rel 1e-10 (c, c_elim; the mean-shifted phi to
    1e-6, its solve amplifying round-off at C_phi = 1e10); the iterative
    run (tests/test_mms_iterative.py's parameters) matches the card's
    direct one (c to atol 1e-8, phi to 1e-4) and goes through K1, K5 and
    K6 at nd = 3, K8, K9 at one system, K10, K11 and K14."""
    cuda_or_skip()
    import chip_smoke

    runs = {}
    for dev in ("cuda", "cpu"):
        S, _ = chip_smoke.mms_solver(3, chip_smoke.MMS_DT_SPACE, "space", device=dev)
        runs[dev] = S.solve_system_passive(2 * chip_smoke.MMS_DT_SPACE, 0.0,
                                           chip_smoke.mms_params_direct())
    mean_shifted = lambda p: (p - p.mean()).cpu()
    for key in ("c", "c_elim"):
        assert rel(runs["cuda"][key].cpu(), runs["cpu"][key]) < 1e-10, key
    assert rel(mean_shifted(runs["cuda"]["phi"]), mean_shifted(runs["cpu"]["phi"])) < 1e-6
    S, _ = chip_smoke.mms_solver(3, chip_smoke.MMS_DT_SPACE, "space")
    assert S.device.type == "cuda"
    _cuda.reset_launches()
    it = S.solve_system_passive(2 * chip_smoke.MMS_DT_SPACE, 0.0,
                                chip_smoke.mms_params_iterative())
    torch.cuda.synchronize()
    missing = [k for k in chip_smoke.PATH_KERNELS["mms"] if _cuda.LAUNCHES[k] == 0]
    assert not missing, missing
    assert float((it["c"] - runs["cuda"]["c"]).abs().max()) < 1e-8
    assert float((mean_shifted(it["phi"]) - mean_shifted(runs["cuda"]["phi"])).abs().max()) < 1e-4


def test_two_level_workspaces_coexist():
    """Solves of K6 (with deflation groups: shared memory) and K7 (none)
    workspaces built one after the other and called in turns each equal
    their plain version: one workspace's launch set-up does not limit
    another's."""
    dev = cuda_or_skip()
    cases = [_coarse_case(c, 4, torch.float64, dev) for c in ("k6_full", "k7", "k6_refined")]
    for _ in range(2):
        for co, r, _ in cases:
            rc, proj = coarse.restrict_plain(co, r)
            zc, coef = coarse.solve(co, rc, proj)
            zc_p, coef_p = coarse.solve_plain(co, rc, proj)
            assert rel(zc, zc_p) < 1e-11 and (coef.numel() == 0 or rel(coef, coef_p) < 1e-11)


def test_two_level_wrappers_refuse_operands_without_workspace():
    """Coarse operands without their workspace (built by hand, not by
    coarse.operands) raise on the card instead of allocating."""
    dev = cuda_or_skip()
    co, r, out0 = _coarse_case("k6_full", 4, torch.float64, dev)
    rc, proj = coarse.restrict(co, r)
    bare = co._replace(work=None)
    n0 = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="workspace"):
        coarse.solve(bare, rc, proj)
    with pytest.raises(ValueError, match="workspace"):
        coarse.restrict(bare, r)
    with pytest.raises(ValueError, match="workspace"):
        coarse.prolong_add(bare, out0, co.work.zc, co.work.coef)
    assert _cuda.LAUNCHES == n0


# compartments of the span cases: uneven, the second inside one restrict
# tile, boundaries off the 256-cell tiles
SPAN_BOUNDS = (0, 1234, 1300, 5000)


def _bits(t):
    """t's bytes as integers (torch.equal takes -0 for +0)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _span_case(nd, dtype, dev, agg=64):
    """K6 operands whose one-hots and moment fields are zero outside their
    compartment's cell range (the solver's fields are), dense Ritz fields,
    and an r with negative entries and exact zeros; with the same operands
    carrying whole spans (every field at every cell: the dense passes)."""
    nc = SPAN_BOUNDS[-1]
    rng = np.random.default_rng(44)
    d = tp.two_level_data(rng, nd, nc, agg)
    comp = np.searchsorted(SPAN_BOUNDS, np.arange(nc), side="right") - 1
    d["comp_onehot"] = (comp[None, :] == np.arange(tp.N_COMP)[:, None]).astype(float)
    owner = np.arange(tp.NW) // (tp.NW // tp.N_COMP)
    d["mom_W"] = d["mom_W"] * (comp[None, None, :] == owner[:, None, None])
    r, out0 = rng.standard_normal((2, 1, nd, nc))
    r[..., ::7] = 0.0
    data = {k: torch.as_tensor(v, dtype=dtype, device=dev) for k, v in d.items()}
    co = coarse.operands(data, agg, batched=False)
    wk = co.work
    whole = torch.tensor([[0, nc]] * wk.spans.shape[0], dtype=torch.int32, device=dev)
    co_whole = co._replace(work=wk._replace(spans=whole, fields=wk.fields[:3] + (
        whole.data_ptr(),)))
    return co, co_whole, torch.as_tensor(r, dtype=dtype, device=dev), torch.as_tensor(
        out0, dtype=dtype, device=dev)


@pytest.mark.parametrize("nd", [4, 8])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_two_level_spans_give_the_dense_bits(nd, dtype, tol):
    """restrict and prolong_add reading each field only over its span equal
    the same kernels with whole spans byte for byte (signed zeros
    included), and their plain versions to round-off; the spans are each
    compartment's range, the Ritz fields' whole."""
    dev = cuda_or_skip()
    co, co_whole, r, out0 = _span_case(nd, dtype, dev)
    nc, nw = SPAN_BOUNDS[-1], tp.NW
    per = nw // tp.N_COMP
    comp_spans = [[a, b] for a, b in zip(SPAN_BOUNDS, SPAN_BOUNDS[1:])]
    assert co.work.spans.tolist() == comp_spans + [s for s in comp_spans for _ in range(per)] + [
        [0, nc]] * tp.NR
    got = [t.clone() for t in coarse.restrict(co, r)]
    dense = [t.clone() for t in coarse.restrict(co_whole, r)]
    for a, b in zip(got, dense):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(got, coarse.restrict_plain(co, r)):
        assert rel(a, b) < tol
    zc, coef = (t.clone() for t in coarse.solve(co, *got))
    out = coarse.prolong_add(co, out0.clone(), zc, coef)
    out_dense = coarse.prolong_add(co_whole, out0.clone(), zc, coef)
    assert torch.equal(_bits(out), _bits(out_dense))
    assert rel(out, coarse.prolong_add_plain(co, out0.clone(), zc, coef)) < tol


@pytest.mark.parametrize("nd", [4, 8])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_two_level_spans_keep_nan_and_the_launches(nd, dtype, tol):
    """With the span table an apply is still one launch per entry (restrict,
    its reduce, solve, prolong: four device kernels), and a NaN in r still
    reaches every entry of out (through the chunk sums)."""
    dev = cuda_or_skip()
    co, _, r, out0 = _span_case(nd, dtype, dev)
    out = out0.clone()
    n0 = dict(_cuda.LAUNCHES)
    coarse.coarse_add(co, out, r)
    for name in ("two_level_restrict", "two_level_solve", "two_level_prolong"):
        assert _cuda.LAUNCHES[name] == n0[name] + 1, name
    kernels = _device_kernels(lambda: coarse.coarse_add(co, out, r), sessions=3, want=4)
    assert [k.split("<")[0].split()[-1] for k in kernels] == [
        "tl_restrict_kernel", "tl_reduce_kernel", "tl_solve_kernel", "tl_prolong_kernel"], kernels
    bad = r.clone()
    bad[0, nd - 1, SPAN_BOUNDS[2] + 3] = float("nan")
    out = coarse.coarse_add(co, out0.clone(), bad)
    assert bool(torch.isnan(out).all())


@pytest.mark.parametrize("agg,nd", [(512, 4), (1024, 8)])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_two_level_large_chunks_match_plain(agg, nd, dtype, tol):
    """Chunks above 256 cells: a restrict block covers one chunk, each
    thread several of its cells; at 1,024 cells and nd = 8 in float64 the
    tile of r takes 72 KB of shared memory, above the default 48 KB (raised
    once per workspace).  restrict and prolong_add against their plain
    versions, and bitwise from call to call."""
    dev = cuda_or_skip()
    co, r, out0 = _coarse_case("k6_full", nd, dtype, dev, agg=agg)
    rc, proj = (t.clone() for t in coarse.restrict(co, r))
    rc_p, proj_p = coarse.restrict_plain(co, r)
    assert rel(rc, rc_p) < tol and rel(proj, proj_p) < tol
    zc_p, coef_p = coarse.solve_plain(co, rc_p, proj_p)
    out = coarse.prolong_add(co, out0.clone(), zc_p, coef_p)
    assert rel(out, coarse.prolong_add_plain(co, out0.clone(), zc_p, coef_p)) < tol
    assert torch.equal(coarse.restrict(co, r)[1], proj)


def test_two_level_wrappers_refuse_a_workspace_without_spans():
    """A CUDA workspace whose span table is missing or off the card raises
    in restrict and prolong_add before any launch."""
    dev = cuda_or_skip()
    co, _, r, out0 = _span_case(4, torch.float64, dev)
    n0 = dict(_cuda.LAUNCHES)
    for spans in (None, co.work.spans.cpu()):
        bare = co._replace(work=co.work._replace(spans=spans))
        with pytest.raises(ValueError, match="span"):
            coarse.restrict(bare, r)
        with pytest.raises(ValueError, match="span"):
            coarse.prolong_add(bare, out0, co.work.zc, co.work.coef)
    assert _cuda.LAUNCHES == n0


@pytest.mark.parametrize("host", [False, True])
def test_emix_auto_slice_on_cuda_matches_cpu(host):
    """Two float64 steps of the EMIx fixture at the AUTO default (24 Ritz
    fields, harvested on the card or in host float64) on the card: every
    apply goes through K6/K7, and the counts and fields are the CPU run's."""
    dev = cuda_or_skip()
    Sc, sp = tp.emix_torch_auto(emi_ritz_host=host)
    sc = Sc.solve_system_active(0.2, 0.0, sp)
    Sg, _ = tp.emix_torch_auto(device=dev)
    _cuda.reset_launches()
    sg = Sg.solve_system_active(0.2, 0.0, sp)
    assert all(_cuda.LAUNCHES[k] > 0 for k in CELL_KERNELS), _cuda.LAUNCHES
    assert sg["pc"]["emi"]["ritz_W"].shape[0] == 24
    assert all(v.device.type == "cuda" for v in sg["pc"]["emi"].values())
    assert Sg.stats.emi_niters == Sc.stats.emi_niters == [5, 3]
    assert Sg.stats.knp_niters == Sc.stats.knp_niters == [[1, 1], [2, 1]]
    for key in ("phi", "c", "c_elim", "phi_M"):
        assert rel(sg[key], sc[key]) < 1e-8, key


def test_emix_pair_ritz_on_cuda_matches_cpu():
    """The pair layout's device harvest (emi_ritz=8) on the card: the fields
    move through the host and back, and the counts and fields are the CPU
    run's."""
    dev = cuda_or_skip()
    Sc, sp = tp.emix_torch(pair=True, emi_ritz=8)
    sc = unpad_state(Sc, Sc.solve_system_active(0.2, 0.0, sp))
    Sg, _ = tp.emix_torch(device=dev, pair=True)
    _cuda.reset_launches()
    stg = Sg.solve_system_active(0.2, 0.0, sp)
    assert all(_cuda.LAUNCHES[k] > 0 for k in PAIR_KERNELS), _cuda.LAUNCHES
    assert all(v.device.type == "cuda" for v in stg["pc"]["emi"].values())
    assert stg["pc"]["emi"]["ritz_W"].shape[0] == 8
    sg = unpad_state(Sg, stg)
    assert Sg.stats.emi_niters == Sc.stats.emi_niters
    assert Sg.stats.knp_niters == Sc.stats.knp_niters
    for key in ("phi", "c", "c_elim", "phi_M"):
        assert rel(sg[key], sc[key]) < 1e-8, key


# ---------------------------------------------------------------------------
# the assembly kernels K10, K11, K14
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["cell", "pair"])
def test_assembly_kernels_match_plain(layout):
    """Every assembly kernel entry point against its plain version on the
    EMIx fixture's tables on the card, in float32 and float64, at a seeded
    perturbed state (chip_smoke.assembly_phase: the cell, facet, membrane
    and trace kernels to 1e-5 / 1e-12 of each value's sum of |terms|, the
    two emit kernels exactly), and one launch counted per call."""
    import chip_smoke

    cuda_or_skip()
    S, sp = tp.emix_torch_auto(device="cuda", pair=layout == "pair")
    state = S.attach_pc(S._initial_state(0.0), sp)
    n0 = dict(_cuda.LAUNCHES)
    results = {}
    chip_smoke.assembly_phase(S, state, results, layout)
    sfx = "_pair" if layout == "pair" else ""
    assert sorted(results) == sorted(k + sfx for k in ASSEMBLY_KERNELS)
    for k in ASSEMBLY_KERNELS:
        assert _cuda.LAUNCHES[k] > n0[k], k
        for dtype, _ in DTYPES:
            assert results[k + sfx][dtype]["ms"] > 0.0


def test_pair_emit_optional_parts_match_plain(pair_maps):
    """K12 with the static operator added last (the KNP emit; its pe zero
    outside the owner halves, as every pair operator's) and with the
    regularisation blocks (the EMI emit's third output): exact."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(9)
    pm = pairs.pair_maps_to_device(pair_maps, dev)
    npair = pair_maps["int_f"].shape[0]
    nf1 = int(pair_maps["nf"]) + 1
    for dtype, _ in DTYPES:
        A = _rand(rng, (2, 4, 4, 2 * npair), dtype, dev)
        Ms = []
        for _ in range(4):
            M = _rand(rng, (2, 4, 4, nf1), dtype, dev)
            M[..., -1] = 0.0
            Ms.append(M)
        # a static operator is zero outside each slot's owner half
        own = pairs.owner_half_rows(pm, 4)
        add = (_rand(rng, (2, 8, 8, npair), dtype, dev),
               (_rand(rng, (2, 6, 8, 4, npair), dtype, dev) * own).contiguous())
        got = pairs.gather_blocks_pair_multi(None, pm, A, *Ms, add=add)
        ref = pairs.gather_blocks_pair_multi_plain(None, pm, A, *Ms, add=add)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        reg = _rand(rng, (4, 4, 2 * npair), dtype, dev)
        one = [A[0].contiguous()] + [M[0].contiguous() for M in Ms]
        got = pairs.gather_blocks_pair(None, pm, *one, reg=reg)
        ref = pairs.gather_blocks_pair_plain(None, pm, *one, reg=reg)
        assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.fixture(scope="module")
def main_pair_maps():
    """The interleaved pair maps of chip_smoke.py's mesh (63,558 pairs) on
    the card, and its facet count."""
    dev = cuda_or_skip()
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    mesh = box_3d_axons(1, length_factor=2)
    geom = build_geometry(mesh, 2, 2)
    pmi, _ = pairs.interleave_pair_maps(pairs.build_pair_maps(geom), geom.vol.shape[0])
    return pairs.pair_maps_to_device(pmi, dev), int(pmi["nf"]) + 1


def _emit_inputs(rng, pm, nf1, dtype, dev):
    """Random K12 inputs of both emits (the EMI one with reg, the KNP one
    with a static operator zero outside the owner halves), the dummy facet
    zero."""
    npair = pm["int_f"].shape[0]
    A = _rand(rng, (2, 4, 4, 2 * npair), dtype, dev)
    Ms = []
    for _ in range(4):
        M = _rand(rng, (2, 4, 4, nf1), dtype, dev)
        M[..., -1] = 0.0
        Ms.append(M)
    own = pairs.owner_half_rows(pm, 4)
    add = (_rand(rng, (2, 8, 8, npair), dtype, dev),
           (_rand(rng, (2, 6, 8, 4, npair), dtype, dev) * own).contiguous())
    reg = _rand(rng, (4, 4, 2 * npair), dtype, dev)
    one = [A[0].contiguous()] + [M[0].contiguous() for M in Ms]
    return A, Ms, add, reg, one


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_emit_into_its_buffers_at_the_main_size(main_pair_maps, dtype):
    """K12 at the main path's 63,558 pairs as the step calls it: two emits
    with other inputs into the same buffers (emit_buffers), the EMI one
    with reg and the KNP one with the static operator, each equal to the
    plain version bit for bit; the rows outside the owner halves stay +0;
    one launch an emit."""
    dev = cuda_or_skip()
    pm, nf1 = main_pair_maps
    assert pm["int_f"].shape[0] == 63558
    rng = np.random.default_rng(31)
    bufK = pairs.emit_buffers(pm, 4, dtype, dev, m=2)
    bufE = pairs.emit_buffers(pm, 4, dtype, dev, diag=True)
    own = pairs.owner_half_rows(pm, 4)
    for _ in range(2):
        A, Ms, add, reg, one = _emit_inputs(rng, pm, nf1, dtype, dev)
        n0 = _cuda.LAUNCHES["gather_blocks_pair"]
        got = pairs.gather_blocks_pair_multi(None, pm, A, *Ms, add=add, out=bufK)
        gotE = pairs.gather_blocks_pair(None, pm, *one, reg=reg, out=bufE)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["gather_blocks_pair"] == n0 + 2
        assert got[0].data_ptr() == bufK[0].data_ptr() and gotE[2].data_ptr() == bufE[2].data_ptr()
        ref = pairs.gather_blocks_pair_multi_plain(None, pm, A, *Ms, add=add)
        refE = pairs.gather_blocks_pair_plain(None, pm, *one, reg=reg)
        for a, b in zip(list(got) + list(gotE), list(ref) + list(refE)):
            assert torch.equal(_bits(a), _bits(b))
        for pe in (bufK[1], bufE[1][None]):
            assert not bool(_bits(pe).masked_select(~own).any())


def test_pair_emit_refuses_what_it_cannot_take(main_pair_maps):
    """A static operator with a value outside the owner halves raises
    before any launch (the emit would not read it); so do maps of another
    slot count than the kernel's S = 6 and blocks of another nd."""
    dev = cuda_or_skip()
    pm, nf1 = main_pair_maps
    rng = np.random.default_rng(32)
    A, Ms, add, reg, one = _emit_inputs(rng, pm, nf1, torch.float64, dev)
    own = pairs.owner_half_rows(pm, 4)
    bad = add[1].masked_fill(~own, 1e-300)
    n0 = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="owner halves"):
        pairs.gather_blocks_pair_multi(None, pm, A, *Ms, add=(add[0], bad))
    four = {k: (v[:4].contiguous() if k.startswith("ext_") and k != "ext_hmask" else v)
            for k, v in pm.items()}
    with pytest.raises(NotImplementedError):
        pairs.gather_blocks_pair_multi(None, four, A, *Ms)
    with pytest.raises(NotImplementedError):
        pairs.gather_blocks_pair(None, pm, A[0, :3, :3].contiguous(),
                                 *(M[0, :3, :3].contiguous() for M in Ms))
    assert _cuda.LAUNCHES == n0


def _k7_main(layout, dtype, dev):
    """K7 operands at a layout's main-path coarse size (cell: 124,416
    cells of nd = 4 in chunks of 64; pair: 63,558 pairs of 2nd = 8 in
    chunks of 32), two systems, r, a block-Jacobi output and the live mask
    (a quarter of the cells dead)."""
    nd, nc, agg = (4, 124416, 64) if layout == "cell" else (8, 63558, 32)
    rng = np.random.default_rng(43)
    d = tp.two_level_data(rng, nd, nc, agg, (), 2)
    co = coarse.operands({k: torch.as_tensor(v, dtype=dtype, device=dev)
                          for k, v in d.items()}, agg, batched=True)
    r, out0 = (torch.as_tensor(rng.standard_normal((2, nd, nc)), dtype=dtype, device=dev)
               for _ in range(2))
    mask = torch.as_tensor((rng.uniform(size=(nd, nc)) < 0.75).astype(np.float64),
                           dtype=dtype, device=dev)
    return co, r, out0, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["cell", "pair"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coarse_apply_equals_the_three_launches_bitwise(layout, dtype, masked):
    """K7's one-launch apply (coarse_add on operands without fields or As)
    at the main path's sizes equals restrict, solve and prolong_add (with
    the mask in the prolong kernel) bit for bit, 50 calls in a row; one
    launch of the one-launch counter a call, none of the three."""
    dev = cuda_or_skip()
    co, r, out0, mask = _k7_main(layout, dtype, dev)
    mk = mask if masked else None
    assert co.work.fused is not None
    ref = coarse.prolong_add(co, out0.clone(), *coarse.solve(co, *coarse.restrict(co, r)), mk)
    plain = coarse.coarse_apply_plain(co, out0.clone(), r, mk)
    names = ("two_level_coarse_batched",) + co.work.names
    n0 = {k: _cuda.LAUNCHES[k] for k in names}
    outs = [coarse.coarse_add(co, out0.clone(), r, mk) for _ in range(50)]
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["two_level_coarse_batched"] == n0[names[0]] + 50
    assert all(_cuda.LAUNCHES[k] == n0[k] for k in names[1:])
    for got in outs:
        assert torch.equal(_bits(got), _bits(ref))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert rel(ref, plain) < tol


def test_prolong_mask_is_the_product_bitwise():
    """K6's prolong-add with the live mask (every deflation group) equals
    the unmasked prolong-add times the mask bit for bit, at nd = 8."""
    dev = cuda_or_skip()
    co, r, out0 = _coarse_case("k6_full", 8, torch.float64, dev)
    rng = np.random.default_rng(44)
    mask = torch.as_tensor((rng.uniform(size=tuple(out0.shape[1:])) < 0.75).astype(
        np.float64), device=dev)
    zc, coef = (t.clone() for t in coarse.solve(co, *coarse.restrict(co, r)))
    got = coarse.prolong_add(co, out0.clone(), zc, coef, mask)
    ref = coarse.prolong_add(co, out0.clone(), zc, coef) * mask
    assert torch.equal(_bits(got), _bits(ref))
    got = coarse.coarse_add(co, out0.clone(), r, mask)
    assert torch.equal(_bits(got), _bits(coarse.coarse_add(co, out0.clone(), r) * mask))


@pytest.mark.parametrize("layout", ["cell", "pair"])
def test_coarse_apply_is_one_launch_and_allocates_nothing(layout):
    """Ten K7 applies (masked on pairs) in one profiler session are ten
    wrapper launches and at most ten device kernels, every one of them the
    one-launch apply, at least the last five read (a session on the card
    can miss its first launches; the scheduled sessions of _device_kernels
    read none of this kernel's in some processes), and no allocation (the
    caching allocator's count)."""
    dev = cuda_or_skip()
    co, r, out0, mask = _k7_main(layout, torch.float64, dev)
    mk = mask if layout == "pair" else None
    coarse.coarse_add(co, out0, r, mk)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    n0 = _cuda.LAUNCHES["two_level_coarse_batched"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            for _ in range(5):
                coarse.coarse_add(co, out0, r, mk)
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
    assert _cuda.LAUNCHES["two_level_coarse_batched"] == n0 + 10
    assert 5 <= len(kernels) <= 10, kernels
    assert all("tl_coarse_kernel" in k for k in kernels), kernels


def test_coarse_apply_raises_on_a_refused_launch():
    """A grid of more blocks than can be resident together is refused by
    the cooperative launch: the wrapper raises, counts no launch, and the
    refusal leaves no error behind for the next launch."""
    dev = cuda_or_skip()
    co, r, out0, _ = _k7_main("cell", torch.float64, dev)
    big = co._replace(work=co.work._replace(fused=(co.work.fused[0],) + (10 ** 6,) * 3))
    n0 = _cuda.LAUNCHES["two_level_coarse_batched"]
    with pytest.raises(RuntimeError, match="launch failed"):
        coarse.coarse_add(big, out0.clone(), r)
    assert _cuda.LAUNCHES["two_level_coarse_batched"] == n0
    got = coarse.coarse_add(co, out0.clone(), r)
    assert _cuda.LAUNCHES["two_level_coarse_batched"] == n0 + 1
    assert torch.equal(_bits(got), _bits(coarse.prolong_add(
        co, out0.clone(), *coarse.solve(co, *coarse.restrict(co, r)))))


def _cell_inverse(rng, m, nc, dtype, dev):
    """Kernel B's inverse of dominant nd = 4 cell blocks: (4, 4, nc) for
    m = None, else (m, 4, 4, nc)."""
    lead = () if m is None else (m,)
    P = 0.3 * _rand(rng, lead + (4, 4, nc), dtype, dev) + 4.0 * torch.eye(
        4, dtype=dtype, device=dev)[:, :, None]
    return spmv.block_jacobi_inverse(P.contiguous())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["k6_full", "k6_refined", "k7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_folded_apply_equals_kernel_b_then_coarse_add_bitwise(case, dtype, masked):
    """The cell layout's folded two-level apply at its main size (124,416
    cells, nd = 4): coarse_add with the block-Jacobi operands (K6: the
    prolong-add computing Pinv r in place of loading out; K7: the
    one-launch apply computing it in its phase 3) equals kernel B's apply
    followed by coarse_add (the parent's two launches) bit for bit, with
    and without a mask, 20 calls in a row; no block_jacobi_apply launch;
    prolong_add with the operands and r the same bits as prolong_add on
    kernel B's output."""
    dev = cuda_or_skip()
    co, r, _ = _coarse_case(case, 4, dtype, dev, nc=MAIN_NC)
    m = r.shape[0]
    rng = np.random.default_rng(45)
    bj = spmv.block_jacobi_operands(_cell_inverse(rng, m if co.batched else None, MAIN_NC,
                                                  dtype, dev))
    mask = (torch.as_tensor((rng.uniform(size=(4, MAIN_NC)) < 0.75).astype(np.float64),
                            dtype=dtype, device=dev) if masked else None)
    z = spmv.block_jacobi_apply(bj, r if co.batched else r[0])
    z = z if co.batched else z[None]
    ref = coarse.coarse_add(co, z.clone(), r, mask)
    n0 = dict(_cuda.LAUNCHES)
    outs = [coarse.coarse_add(co, torch.full_like(r, float("nan")), r, mask, bj)
            for _ in range(20)]
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["block_jacobi_apply"] == n0["block_jacobi_apply"]
    if co.work.fused is not None:
        assert _cuda.LAUNCHES["two_level_coarse_batched"] == n0["two_level_coarse_batched"] + 20
    else:
        for name in co.work.names:
            assert _cuda.LAUNCHES[name] == n0[name] + 20, name
    for got in outs:
        assert torch.equal(_bits(got), _bits(ref))
    if co.work.fused is None:
        zc, coef = (t.clone() for t in coarse.solve(co, *coarse.restrict(co, r)))
        ref = coarse.prolong_add(co, z.clone(), zc, coef, mask)
        got = coarse.prolong_add(co, torch.empty_like(r), zc, coef, mask, bj=bj, r=r)
        assert torch.equal(_bits(got), _bits(ref))


def test_cell_two_level_applies_launch_no_kernel_b_and_allocate_nothing():
    """The cell layout's EMI (K6, every deflation group) and KNP (K7)
    two-level applies with their buffer: five applies each launch no
    bj_apply_kernel (K6: restrict, its reduce, the solve and the
    prolong-add; K7: the one-launch apply), no block_jacobi_apply counted,
    and allocate nothing (the caching allocator's count); each returns the
    buffer."""
    from knpemidg_tpu_torch.solvers import twolevel

    dev = cuda_or_skip()
    rng = np.random.default_rng(46)
    for case, per_apply in (("k6_full", 4), ("k7", 1)):
        m, groups = TWO_LEVEL_CASES[case]
        d, (r, _) = _coarse_numpy(case, 4, MAIN_NC, 64)
        data = {k: torch.as_tensor(v, device=dev) for k, v in d.items()}
        P = (0.3 * _rand(rng, ((m,) if m else ()) + (4, 4, MAIN_NC), torch.float64, dev)
             + 4.0 * torch.eye(4, dtype=torch.float64, device=dev)[:, :, None]).contiguous()
        make = twolevel.two_level_apply_batched if m else twolevel.two_level_apply_fn
        apply = make(data, P, 64, buffer=True)
        rv = torch.as_tensor(r if m else r[0], device=dev)
        z = apply(rv)
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        n0 = _cuda.LAUNCHES["block_jacobi_apply"]

        def applies():
            for _ in range(5):
                assert apply(rv) is z

        kernels = _device_kernels(applies, sessions=3, want=5 * per_apply)
        assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
        assert _cuda.LAUNCHES["block_jacobi_apply"] == n0
        assert len(kernels) == 5 * per_apply, (case, kernels)
        assert not any("bj_apply_kernel" in k for k in kernels), kernels


@pytest.mark.parametrize("pair", [False, True])
def test_step_route_forms_no_masked_or_copied_diagonal(pair):
    """One step of the EMIx fixture on the card with every aten call of
    its EMI and KNP solves recorded (profile_step's census, with the
    shapes): no product with the halves mask (the pair layout's inverse
    reads the unmasked diagonal in its halves form) and no copy of slot 0
    of the KNP operator (the cell layout's inverse reads it in place): no
    mul, clone or copy_ touches a tensor of a diagonal's or the mask's
    shape.  The step's inverses go into the step's buffers."""
    from torch.utils._python_dispatch import TorchDispatchMode

    dev = cuda_or_skip()
    S, sp = tp.emix_torch(device=dev, pair=pair)
    state = S.attach_pc(S._initial_state(0.0), sp)
    D, n = (2 * S.nd, S.pairs["int_f"].shape[0]) if pair else (S.nd, S.n_cells)
    shapes = {(D, D, n), (S.N_ions, D, D, n), (D, D, 1)}
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            op = func.__name__.split(".")[0]
            dims = [tuple(a.shape) for a in list(args) + list((kwargs or {}).values())
                    if isinstance(a, torch.Tensor)]
            seen.append((op, dims))
            return func(*args, **(kwargs or {}))

    for name in ("_emi_solve_iterative", "_knp_solve_all"):
        fn = getattr(S, name)

        def wrapped(*args, _fn=fn, **kw):
            with Record():
                return _fn(*args, **kw)

        setattr(S, name, wrapped)
    S.run_block(state, sp, 2)
    bad = [(op, dims) for op, dims in seen
           if op in ("mul", "clone", "copy_", "_to_copy") and shapes & set(dims)]
    assert seen and not bad, bad
    bufs = [k for k in S._emit_bufs if k[0] in ("bj_emi", "bj_knp")]
    assert len(bufs) == 2, bufs


def _facet_case(rng, nd, nf1, nc, membrane, dtype, dev):
    """emi_facet's inputs on nf1 random facets (the last one the dummy) of
    nc cells in dimension nd - 1: SIP facets at random, membrane facets
    none, all (but the dummy) or some."""
    d, nq = nd - 1, {3: 3, 4: 6}[nd]
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    I = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)
    cp, cm = rng.integers(0, nc, nf1), rng.integers(0, nc, nf1)
    sip = rng.random(nf1) < 0.7
    mem = {"none": np.zeros(nf1, bool), "all": np.ones(nf1, bool),
           "some": rng.random(nf1) < 0.2}[membrane]
    sip[-1] = mem[-1] = False
    fidx = np.flatnonzero(mem)
    inv = np.full(nf1, -1)
    inv[fidx] = np.arange(len(fidx))
    Rp, Rm = rng.random((nq, nd, nf1)), rng.random((nq, nd, nf1))
    Rp[..., -1] = Rm[..., -1] = 0.0
    g = {"f_cp": I(cp), "f_cm": I(cm), "f_n": T(rng.standard_normal((d, nf1))),
         "f_area": T(rng.uniform(0.5, 1.5, nf1)), "f_havg": T(rng.uniform(0.5, 1.5, nf1)),
         "f_Rp": T(Rp), "f_Rm": T(Rm), "w_f": T(rng.uniform(0.1, 1.0, nq)),
         "G": T(np.zeros((nd, d, nc))),
         **{k: T(rng.standard_normal((nd, nf1))) for k in ("gnp", "gnm")},
         **{k: T(rng.standard_normal((nd, nd, nf1))) for k in ("E_pp", "E_pm", "E_mp", "E_mm")}}
    masks = {"f_sip": torch.as_tensor(sip, device=dev), "f_mem": torch.as_tensor(mem, device=dev)}
    mem_t = {"fidx": I(fidx), "cp": I(cp[fidx]), "inv": I(inv), "Rp": T(Rp[:, :, fidx]),
             "Rm": T(Rm[:, :, fidx])}
    fields = (T(rng.uniform(0.5, 2.0, (nd, nc))), T(rng.standard_normal((d, nc))),
              T(rng.standard_normal(len(fidx) + 1)))
    return g, masks, mem_t, fields, ~(sip | mem)


@pytest.mark.parametrize("membrane", ["none", "all", "some"])
@pytest.mark.parametrize("nd", [3, 4])
def test_emi_facet_tiles_and_membrane_facets(nd, membrane):
    """emi_facet on a facet count that is not a multiple of its 32-facet
    tile, with no, all or some membrane facets (the jump-jump tables are
    read on those only), at nd = 3 (2D) and 4 (3D), in both dtypes: its
    plain version to round-off, one launch a call, and the facets that are
    neither SIP nor membrane exactly zero."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(12)
    nf1, nc = 32 * 37 + 13, 500
    for dtype, tol in DTYPES:
        g, masks, mem_t, (kappa, flux, gr), off = _facet_case(rng, nd, nf1, nc, membrane,
                                                              dtype, dev)
        n0 = _cuda.LAUNCHES["emi_facet"]
        got = assembly.emi_facet(g, masks, kappa, flux, gr, mem_t, 96.5, 2.0, 60.0)
        assert _cuda.LAUNCHES["emi_facet"] == n0 + 1
        ref = assembly.emi_facet_plain(g, masks, kappa, flux, gr, mem_t, 96.5, 2.0, 60.0)
        for k, (a, b) in enumerate(zip(got, ref)):
            assert rel(a, b) < tol, (dtype, k)
        for M in got[:4]:
            assert not bool(M[..., off].any())


# facet counts of the K11 facet case: one facet, a warp and a 256-thread
# block +- 1, many
KNP_FACET_COUNTS = (1, 31, 33, 255, 257, 1197)


@pytest.mark.parametrize("sip", ["none", "all", "some"])
@pytest.mark.parametrize("nd", [3, 4])
def test_knp_facet_equals_the_ordered_plain_exactly(nd, sip):
    """K11 knp_facet (each facet's scalars once, then the sweep over its
    entries) equals knp_facet_ordered_plain exactly and knp_facet_plain to
    round-off, in both dtypes, at nd = 3 (2D) and 4 (3D), m = 1, 2, 3 ions,
    on facet counts on and off the warp and block sizes, with no, all or
    some SIP facets: one counted launch a call, and the facets that are not
    SIP exactly zero."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(23)
    nc, psi = 500, 1.3
    for dtype, tol in DTYPES:
        for nf1 in KNP_FACET_COUNTS:
            g = _facet_case(rng, nd, nf1, nc, "none", dtype, dev)[0]
            on = {"none": np.zeros(nf1, bool), "all": np.ones(nf1, bool),
                  "some": rng.random(nf1) < 0.5}[sip]
            masks = {"f_sip": torch.as_tensor(on, device=dev)}
            gphi = _rand(rng, (nd - 1, nc), dtype, dev)
            for m in (1, 2, 3):
                z = torch.as_tensor(rng.choice([-1.0, 1.0, 2.0], m), dtype=dtype, device=dev)
                D = torch.as_tensor(rng.uniform(0.5, 2.0, (m, nc)), dtype=dtype, device=dev)
                n0 = _cuda.LAUNCHES["knp_facet"]
                got = assembly.knp_facet(g, masks, z, D, gphi, psi)
                assert _cuda.LAUNCHES["knp_facet"] == n0 + 1
                ref = assembly.knp_facet_ordered_plain(g, masks, z, D, gphi, psi)
                plain = assembly.knp_facet_plain(g, masks, z, D, gphi, psi)
                for k, (a, b, c) in enumerate(zip(got, ref, plain)):
                    assert a.shape == (m, nd, nd, nf1) and torch.equal(a, b), (dtype, nf1, m, k)
                    assert rel(a, c) < tol, (dtype, nf1, m, k)
                    assert not bool(a[..., ~masks["f_sip"]].any())


def _k11_case(S, dtype, seed):
    """The inputs of K11's membrane emit on solver S's tables in ``dtype``
    at a state perturbed with numpy-seeded noise (torch_k11_inputs on
    them): (g, mem, the arguments of knp_membrane_emit, the facet
    blocks)."""
    from torch_k11_inputs import k11_inputs

    rng = np.random.default_rng(seed)
    dev, p = S.device, S.params
    st = S._initial_state(0.0)
    to = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    c = (st["c"] * to(rng.uniform(0.99, 1.01, tuple(st["c"].shape)))).contiguous()
    call = torch.cat([c, st["c_elim"][None]]).contiguous()
    pM, Ich, _ = S._pads(st)
    phi = to(0.1 * float(pM.abs().max()) * rng.standard_normal(tuple(st["phi"].shape)))
    pM = pM * to(rng.uniform(0.9, 1.1, tuple(pM.shape)))
    Ich = to(1e-2 * rng.standard_normal(tuple(Ich.shape)))
    Ich[:, -1] = 0.0
    g, mem, margs, drift, M, b_cell, statics = k11_inputs(S, assembly, dtype, c, call, phi,
                                                          pM, Ich)
    args = (g, mem, *margs, p.F, p.C_M, p.dt, p.psi, drift, None if S.pair_layout else M,
            b_cell, statics)
    return g, mem, args, M


@pytest.fixture(scope="module", params=["cell", "pair"])
def k11_solver(request):
    cuda_or_skip()
    return tp.emix_torch(device="cuda", pair=request.param == "pair")[0]


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_knp_membrane_emit_matches_plain(k11_solver, dtype, tol):
    """K11's one call (knp_membrane_emit) on the EMIx fixture's tables,
    two states emitted into the same buffers with tables built once: the
    blocks and the rhs equal knp_emit_cell_plain's (on the launch's own
    b_p, b_m) bit for bit, b_p and b_m equal knp_membrane_rhs_plain's to
    round-off, and a call that builds its own tables gives the same bits;
    one counted launch a call."""
    S = k11_solver
    pair = S.pair_layout
    out = assembly.knp_emit_buffers(S.g, S.mem_dev, S.N_ions, dtype, S.device, pair)
    for seed in (51, 52):
        g, mem, args, M = _k11_case(S, dtype, seed)
        (_, _, z, D, c, asum, phi, pM, Ich, Itot, F, C_M, dt, psi, drift, _, b_cell,
         statics) = args
        tab = assembly.knp_emit_tables(g, mem)
        n0 = _cuda.LAUNCHES["knp_membrane_emit"]
        got = assembly.knp_membrane_emit(*args, pair=pair, out=out, tables=tab)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["knp_membrane_emit"] == n0 + 1
        assert all(a is b for a, b in zip(got, out))
        plain = assembly.knp_emit_cell_plain(g, mem, z, D, psi, drift, *M, b_cell, got[2],
                                             got[3], statics, pair=pair)
        for a, b in zip(got[:2], plain):
            assert torch.equal(_bits(a), _bits(b))
        ref = assembly.knp_membrane_rhs_plain(g, mem, z, D, c, asum, phi, pM, Ich, Itot, F,
                                              C_M, dt)
        assert rel(got[2], ref[0]) < tol and rel(got[3], ref[1]) < tol
        assert float(got[2].abs().max()) > 0.0
        own = assembly.knp_membrane_emit(*args, pair=pair)
        for a, b in zip(own, got):
            assert torch.equal(_bits(a), _bits(b))


def test_knp_membrane_emit_is_one_call_and_allocates_nothing(k11_solver):
    """Ten K11 membrane emits into the step's buffers with the solver's
    tables in one profiler session are ten wrapper calls (one count each)
    and at most twenty device kernels, each the sweep
    (ion_membrane_emit_kernel) or the membrane cells' rows
    (ion_membrane_emit_rows_kernel), the last five calls' read in full (a
    session can miss its first launches), and no allocation."""
    S = k11_solver
    g, mem, args, _ = _k11_case(S, torch.float64, 53)
    out, tab = S._emit_out("membrane_emit"), S._membrane_emit_tables()
    call = lambda: assembly.knp_membrane_emit(*args, pair=S.pair_layout, out=out, tables=tab)
    call()
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(S.device)["allocation.all.allocated"]
    n0 = _cuda.LAUNCHES["knp_membrane_emit"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            for _ in range(5):
                call()
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert torch.cuda.memory_stats(S.device)["allocation.all.allocated"] == allocs
    assert _cuda.LAUNCHES["knp_membrane_emit"] == n0 + 10
    assert 10 <= len(kernels) <= 20, kernels
    sweeps = sum("ion_membrane_emit_kernel" in k for k in kernels)
    rows = sum("ion_membrane_emit_rows_kernel" in k for k in kernels)
    assert sweeps + rows == len(kernels) and sweeps >= 5 and rows >= 5, kernels


def test_knp_membrane_emit_without_membrane_facets(k11_solver):
    """With no membrane facet (n_mem = 0, every cell-facet slot off the
    membranes) the call (its sweep alone) writes the emit, the rhs b_cell
    plus zero slot terms, bit for bit the plain version's."""
    S = k11_solver
    g, mem, args, M = _k11_case(S, torch.float64, 54)
    dev, m = S.device, S.N_ions
    nd = mem["Rp"].shape[1]
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    mem0 = dict(mem, fidx=none, cp=none, cm=none, inv=torch.full_like(mem["inv"], -1),
                Rp=mem["Rp"][..., :0].contiguous(), Rm=mem["Rm"][..., :0].contiguous())
    tab = assembly.knp_emit_tables(g, mem0)
    assert tab.dims[5] == tab.dims[6] == 0
    f64 = dict(dtype=torch.float64, device=dev)
    args0 = (g, mem0) + args[2:7] + (torch.zeros(1, **f64), torch.zeros((m, 1), **f64),
                                      torch.zeros(1, **f64)) + args[10:]
    got = assembly.knp_membrane_emit(*args0, pair=S.pair_layout, tables=tab)
    ref = assembly.knp_membrane_emit_plain(*args0, pair=S.pair_layout)
    assert got[2].shape == (m, nd, 0)
    for a, b in zip(got[:2], ref[:2]):
        assert torch.equal(_bits(a), _bits(b))


def test_knp_membrane_emit_refuses_what_it_cannot_take(k11_solver):
    """A fifth basis function (nd > 4) raises NotImplementedError, a
    mistyped input TypeError, a wrong shape or a non-contiguous input
    ValueError, all before any launch."""
    S = k11_solver
    g, mem, args, _ = _k11_case(S, torch.float64, 55)
    dev = S.device
    nq, nd, nm = mem["Rp"].shape
    nc = g["cf_idx"].shape[1]
    n0 = dict(_cuda.LAUNCHES)
    g5 = dict(g, phibar=torch.zeros(5, dtype=torch.float64, device=dev))
    mem5 = dict(mem, Rp=torch.zeros((nq, 5, nm), dtype=torch.float64, device=dev),
                Rm=torch.zeros((nq, 5, nm), dtype=torch.float64, device=dev))
    with pytest.raises(NotImplementedError):
        assembly.knp_membrane_emit(g5, mem5, *args[2:], pair=S.pair_layout)
    bad = list(args)
    bad[4] = args[4].float()                                     # c_k in float32
    with pytest.raises(TypeError):
        assembly.knp_membrane_emit(*bad, pair=S.pair_layout)
    bad[4] = args[4][:, :, : nc - 1].contiguous()                # one cell short
    with pytest.raises(ValueError):
        assembly.knp_membrane_emit(*bad, pair=S.pair_layout)
    bad[4] = args[4].transpose(1, 2).contiguous().transpose(1, 2)    # not contiguous
    with pytest.raises(ValueError):
        assembly.knp_membrane_emit(*bad, pair=S.pair_layout)
    assert _cuda.LAUNCHES == n0


@pytest.fixture(scope="module")
def main_solver():
    """chip_smoke.py's cell-layout solver (124,416 cells) on the card."""
    cuda_or_skip()
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2
    return emix.build_solver(mesh, dtype=torch.float64, device="cuda")


def _emi_emit_case(S, dtype, seed):
    """Seeded inputs of K10's emit on solver S's tables in ``dtype``: (g,
    the emit's arguments up to inv_Lp2, the solver's slot tables), the
    dummy facet's blocks and rhs parts zero."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    g, dev = chip_smoke.cast_tables(S.g, dtype), S.device
    nd, (nfac, nc) = S.nd, g["cf_idx"].shape
    nf1 = g["f_area"].shape[0]
    Ms = [_rand(rng, (nd, nd, nf1), dtype, dev) for _ in range(4)]
    bs = [_rand(rng, (nd, k), dtype, dev) for k in (nc, nf1, nf1)]
    for t in Ms + bs[1:]:
        t[..., -1] = 0.0
    kbar = torch.as_tensor(rng.uniform(0.5, 2.0, nc), dtype=dtype, device=dev)
    return g, (kbar, *Ms, *bs, 1.0 / S.Lp ** 2), S._membrane_emit_tables()


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emi_emit_equals_plain_exactly_at_the_main_size(main_solver, dtype, pair):
    """K10's emit at the main path's 124,416 cells as the step calls it: two
    emits with other inputs into the same buffers, the slots from the
    solver's packed slot words, each output (the operator, rhs and P_diag;
    on pairs A_cell, rhs and reg) bit for bit emi_emit_cell_plain's; a call
    that packs its own slot words gives the same bits; one launch an
    emit."""
    S = main_solver
    out = assembly.emi_emit_buffers(S.g, dtype, S.device, pair)
    for seed in (41, 42):
        g, args, tab = _emi_emit_case(S, dtype, seed)
        n0 = _cuda.LAUNCHES["emi_emit_cell"]
        got = assembly.emi_emit_cell(g, *args, pair=pair, out=out, tables=tab)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["emi_emit_cell"] == n0 + 1
        assert all(a is b for a, b in zip(got, out))
        ref = assembly.emi_emit_cell_plain(g, *args, pair=pair)
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b))
        own = assembly.emi_emit_cell(g, *args, pair=pair)
        for a, b in zip(own, ref):
            assert torch.equal(_bits(a), _bits(b))


def test_emi_emit_is_one_launch_and_allocates_nothing(main_solver):
    """Ten EMI emits into the step's buffers with the solver's slot tables
    in one plain profiler session: ten counted calls, ten
    emi_emit_cell_kernel launches and nothing else on the device, and no
    allocation."""
    S = main_solver
    g, args, tab = _emi_emit_case(S, torch.float64, 43)
    out = S._emit_out("emi_emit")
    call = lambda: assembly.emi_emit_cell(g, *args, out=out, tables=tab)
    call()
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(S.device)["allocation.all.allocated"]
    n0 = _cuda.LAUNCHES["emi_emit_cell"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert torch.cuda.memory_stats(S.device)["allocation.all.allocated"] == allocs
    assert _cuda.LAUNCHES["emi_emit_cell"] == n0 + 10
    assert 5 <= len(kernels) <= 10 and all("emi_emit_cell_kernel" in k for k in kernels), kernels


def test_emi_emit_refuses_what_it_cannot_take(main_solver):
    """Slot tables of another geometry, a mistyped or misshapen input or
    output buffer, a non-contiguous input and a non-simplex geometry
    (nd != d + 1) raise before any launch."""
    S = main_solver
    g, args, tab = _emi_emit_case(S, torch.float64, 44)
    dev = S.device
    n0 = dict(_cuda.LAUNCHES)
    small = tp.emix_torch(device="cuda")[0]._membrane_emit_tables()
    with pytest.raises(ValueError, match="tables"):
        assembly.emi_emit_cell(g, *args, tables=small)
    bad = list(args)
    bad[0] = args[0].float()                                     # kbar in float32
    with pytest.raises(TypeError):
        assembly.emi_emit_cell(g, *bad, tables=tab)
    bad[0] = args[0][:-1].contiguous()                           # one cell short
    with pytest.raises(ValueError):
        assembly.emi_emit_cell(g, *bad, tables=tab)
    bad = list(args)
    bad[1] = args[1].transpose(0, 1).contiguous().transpose(0, 1)    # not contiguous
    with pytest.raises(ValueError):
        assembly.emi_emit_cell(g, *bad, tables=tab)
    out = assembly.emi_emit_buffers(S.g, torch.float64, dev, pair=True)
    with pytest.raises(ValueError):                              # the pair buffers
        assembly.emi_emit_cell(g, *args, out=out, tables=tab)
    g3 = dict(g, G=g["G"][:, :2].contiguous())                   # d = 2 with nd = 4
    with pytest.raises(NotImplementedError):
        assembly.emi_emit_cell(g3, *args, tables=tab)
    assert _cuda.LAUNCHES == n0


def _cell_case(S, seed):
    """Seeded inputs of K10's emi_cell and K11's knp_cell on solver S in
    float64 (c perturbed around the initial state, a seeded potential)
    and the two calls as the step makes them: the solver's cell tables,
    the step's buffers (S._emit_out)."""
    rng = np.random.default_rng(seed)
    st, p, dev = S._initial_state(0.0), S.params, S.device
    to = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    c = (st["c"] * to(rng.uniform(0.99, 1.01, tuple(st["c"].shape)))).contiguous()
    call = torch.cat([c, st["c_elim"][None]]).contiguous()
    phi = to(1e-3 * rng.standard_normal(tuple(st["phi"].shape)))
    tab = S._cell_tables()
    emi_out, knp_out = S._emit_out("emi_emit"), S._emit_out("membrane_emit")
    calls = {"emi_cell": lambda: assembly.emi_cell(S.g, S.z, S.D, call, p.F, p.psi,
                                                   out=emi_out, tables=tab),
             "knp_cell": lambda: assembly.knp_cell(S.g, phi, c, p.dt, out=knp_out,
                                                   tables=tab)}
    public = {"emi_cell": lambda: assembly.emi_cell(S.g, S.z, S.D, call, p.F, p.psi),
              "knp_cell": lambda: assembly.knp_cell(S.g, phi, c, p.dt)}
    fields = {"emi_cell": (emi_out.kappa, emi_out.kbar, emi_out.flux, emi_out.b_cell),
              "knp_cell": (knp_out.gphi, knp_out.drift, knp_out.b_cell)}
    return calls, public, fields


@pytest.mark.parametrize("name,kernel", [("emi_cell", "emi_cell_kernel"),
                                         ("knp_cell", "ion_cell_kernel")])
def test_cell_kernel_is_one_launch_and_allocates_nothing(main_solver, name, kernel):
    """K10's emi_cell and K11's knp_cell as the step calls them (the
    solver's cell tables, the step's buffers) at the main path's 124,416
    cells: the outputs are the step's buffers, bit for bit the public
    wrapper's (which checks its tables and allocates); ten calls in one
    plain profiler session are ten counted calls, ten launches of the
    kernel and nothing else on the device, and no allocation."""
    S = main_solver
    calls, public, fields = _cell_case(S, 61)
    call = calls[name]
    got = call()
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(got, fields[name])) and len(got) == len(fields[name])
    for a, b in zip(got, public[name]()):
        assert torch.equal(_bits(a), _bits(b))
    for _ in range(3):
        # a profiler session on the card can return fewer device events
        # than were launched: up to three sessions, until one reads five
        allocs = torch.cuda.memory_stats(S.device)["allocation.all.allocated"]
        n0 = _cuda.LAUNCHES[name]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert torch.cuda.memory_stats(S.device)["allocation.all.allocated"] == allocs
        assert _cuda.LAUNCHES[name] == n0 + 10
        if len(kernels) >= 5:
            break
    assert 5 <= len(kernels) <= 10 and all(kernel in k for k in kernels), kernels


@pytest.mark.parametrize("nd", [3, 4])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cell_kernels_take_every_built_ion_count(nd, dtype, tol):
    """emi_cell at 1-6 ions and knp_cell at 1-6 solved ions, nd = 3 (the 2D
    neuron's tables) and 4 (the EMIx fixture's), against the plain
    versions to each value's sum of |terms|, with tables built in the call
    and built once; at an even cell count (two cells a thread) the inputs
    one element off the two-element alignment (one cell a thread) give the
    same bits, and an odd cell count (one cell a thread) is checked too;
    seven ions raise NotImplementedError before any launch."""
    dev = cuda_or_skip()
    S = tp.emix_torch(device=dev)[0] if nd == 4 else tp._neuron_2d("torch", device=dev)
    rng = np.random.default_rng(62)
    cast = lambda d: {k: (v.to(dtype) if isinstance(v, torch.Tensor)
                          and v.is_floating_point() else v) for k, v in d.items()}
    p = S.params
    for odd in (False, True):
        g = cast(S.g)
        nc = g["G"].shape[-1] - (1 if odd == (g["G"].shape[-1] % 2 == 0) else 0)
        g = dict(g, G=g["G"][..., :nc].contiguous(), vol=g["vol"][:nc].contiguous())
        assert (nc % 2 == 1) == odd
        ga = {k: (v.abs() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
              for k, v in g.items()}
        for n in range(1, assembly.CELL_MAX_IONS + 1):
            z = torch.as_tensor(rng.choice([-2.0, -1.0, 1.0, 2.0], n), dtype=dtype, device=dev)
            D = torch.as_tensor(rng.uniform(1e-9, 2e-9, (n, nc)), dtype=dtype, device=dev)
            c = torch.as_tensor(rng.uniform(1.0, 100.0, (n, nd, nc)), dtype=dtype, device=dev)
            phi = torch.as_tensor(rng.standard_normal((nd, nc)), dtype=dtype, device=dev)
            tab = assembly.cell_tables(g, z)
            sc = assembly.emi_cell_plain(ga, z.abs(), D, c, p.F, p.psi, neg=1.0)
            for got in (assembly.emi_cell(g, z, D, c, p.F, p.psi),
                        assembly.emi_cell(g, z, D, c, p.F, p.psi, tables=tab)):
                for a, b, s_ in zip(got, assembly.emi_cell_plain(g, z, D, c, p.F, p.psi), sc):
                    assert float(((a - b).abs() / (s_ + 1e-300)).max()) < tol, (n, odd)
            sc = assembly.knp_cell_plain(ga, phi.abs(), c, p.dt)
            for got in (assembly.knp_cell(g, phi, c, p.dt),
                        assembly.knp_cell(g, phi, c, p.dt, tables=tab)):
                for a, b, s_ in zip(got, assembly.knp_cell_plain(g, phi, c, p.dt), sc):
                    assert float(((a - b).abs() / (s_ + 1e-300)).max()) < tol, (n, odd)
            if not odd:
                off = lambda t: torch.empty(t.numel() + 1, dtype=dtype, device=dev)[1:].view(
                    t.shape).copy_(t)
                for a, b in zip(assembly.emi_cell(g, z, off(D), off(c), p.F, p.psi, tables=tab),
                                assembly.emi_cell(g, z, D, c, p.F, p.psi, tables=tab)):
                    assert torch.equal(_bits(a), _bits(b)), n
                for a, b in zip(assembly.knp_cell(g, off(phi), off(c), p.dt, tables=tab),
                                assembly.knp_cell(g, phi, c, p.dt, tables=tab)):
                    assert torch.equal(_bits(a), _bits(b)), n
    n0 = dict(_cuda.LAUNCHES)
    seven = torch.ones(7, dtype=dtype, device=dev)
    with pytest.raises(NotImplementedError):
        assembly.emi_cell(g, seven, D[:1].expand(7, nc).contiguous(),
                          c[:1].expand(7, nd, nc).contiguous(), p.F, p.psi)
    with pytest.raises(NotImplementedError):
        assembly.knp_cell(g, phi, c[:1].expand(7, nd, nc).contiguous(), p.dt)
    assert _cuda.LAUNCHES == n0


def test_cell_kernels_refuse_tables_of_other_charges(main_solver):
    """The step's route trusts the tables it is given: tables built for
    other charges z, inputs or buffers of another dtype or shape, and a
    non-contiguous input raise before any launch."""
    S = main_solver
    p = S.params
    st = S._initial_state(0.0)
    call = torch.cat([st["c"], st["c_elim"][None]]).contiguous()
    tab = S._cell_tables()
    n0 = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="charges"):
        assembly.emi_cell(S.g, S.z.clone(), S.D, call, p.F, p.psi, tables=tab)
    with pytest.raises(TypeError):
        assembly.emi_cell(S.g, S.z, S.D, call.float(), p.F, p.psi, tables=tab)
    with pytest.raises(ValueError):
        assembly.knp_cell(S.g, st["phi"], call[:, :, :-1].contiguous(), p.dt, tables=tab)
    with pytest.raises(ValueError):
        assembly.knp_cell(S.g, st["phi"].t().contiguous().t(), st["c"], p.dt, tables=tab)
    out3 = assembly.knp_emit_buffers(S.g, S.mem_dev, S.N_ions + 1, torch.float64, S.device)
    with pytest.raises(ValueError):                              # b_cell of 3 ions
        assembly.knp_cell(S.g, st["phi"], st["c"], p.dt, out=out3, tables=tab)
    assert _cuda.LAUNCHES == n0


def _node_tables(nd, nc, n, dtype, dev, rng):
    """Seeded cell tables of nd = d + 1 basis functions on nc cells with n
    ions' charges, diffusion fields and a background charge (the step's
    route of alpha_sum and eliminated_concentration reads z, D and rho)."""
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    g = {"G": to(rng.standard_normal((nd, nd - 1, nc))), "vol": to(rng.uniform(1, 2, nc)),
         "phibar": to(np.full(nd, 1.0 / nd)), "M0": to(np.eye(nd)),
         "f_Rp": to(np.zeros((1, nd, 1)))}
    z = to(rng.choice([-2.0, -1.0, 1.0, 2.0], n))
    D = to(rng.uniform(1e-9, 2e-9, (n, nc)))
    rho = to(rng.standard_normal(nc))
    return g, z, D, rho


def _off(t):
    """A copy of t one element off the two-element alignment."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(
        t.shape).copy_(t)


@pytest.mark.parametrize("nd", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ion_sum_kernels_equal_their_ordered_twins(nd, dtype):
    """K11's alpha_sum at 1-6 ions and K14's eliminated_concentration at 1-5
    solved ions, nd 2-4, on both routes (the public call, z read to the
    host; the step's, z by value from the cell tables, c and c_elim apart)
    and, for eliminated_concentration, both shapes of a thread (in float32
    two nodes at an even cell count; one at an odd count, on inputs one
    element off the alignment and in float64): each output equals the
    kernel-order plain twin to the last bit (alpha_sum_ordered_plain;
    eliminated_concentration_ordered_plain, the fused multiply-adds
    emulated exactly), and one counted launch a call."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(71)
    for nc in (2000, 1001):
        for n in range(1, assembly.CELL_MAX_IONS + 1):
            g, z, D, rho = _node_tables(nd, nc, n, dtype, dev, rng)
            tab = assembly.cell_tables(g, z, D=D, rho=rho)
            c = torch.as_tensor(rng.uniform(1.0, 100.0, (n, nd, nc)), dtype=dtype, device=dev)
            cs, ce = c[:-1].contiguous(), c[-1].contiguous()
            out = assembly.KnpEmitOut(*[None] * 7, torch.empty((nd, nc), dtype=dtype,
                                                               device=dev))
            want = assembly.alpha_sum_ordered_plain(z, D, cs, ce)
            n0 = _cuda.LAUNCHES["alpha_sum"]
            runs = [assembly.alpha_sum(z, D, c), assembly.alpha_sum(z, D, cs, ce, tables=tab),
                    assembly.alpha_sum(z, D, cs, ce, out=out, tables=tab).clone()]
            assert _cuda.LAUNCHES["alpha_sum"] == n0 + len(runs)
            for i, got in enumerate(runs):
                assert torch.equal(_bits(got), _bits(want)), (n, nc, i)
            if n == 1:
                continue
            m = n - 1
            want = assembly.eliminated_concentration_ordered_plain(cs, z[:m], rho,
                                                                   float(z[m]))
            n0 = _cuda.LAUNCHES["eliminated_concentration"]
            zs = z[:m].contiguous()
            runs = [assembly.eliminated_concentration(cs, zs, rho, float(z[m])),
                    assembly.eliminated_concentration(cs, tables=tab)]
            if nc % 2 == 0:
                runs += [assembly.eliminated_concentration(_off(cs), tables=tab),
                         assembly.eliminated_concentration(cs, zs, _off(rho), float(z[m]))]
            assert _cuda.LAUNCHES["eliminated_concentration"] == n0 + len(runs)
            for i, got in enumerate(runs):
                assert torch.equal(_bits(got), _bits(want)), (m, nc, i)


@pytest.fixture(scope="module")
def main_pair_solver():
    """chip_smoke.py's pair-layout solver (127,116 padded cells) on the card."""
    cuda_or_skip()
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2
    return emix.build_solver(mesh, dtype=torch.float64, device="cuda", pair=True)


@pytest.mark.parametrize("layout", ["cell", "pair"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ion_sums_on_the_step_route_at_the_main_shapes(request, layout, dtype):
    """The step's route at the main path's shapes (124,416 cells; the pair
    layout's 127,116 padded ones): alpha_sum from c and c_elim apart into
    the step's buffer and eliminated_concentration from the cell tables,
    each bit for bit its ordered twin and the public call on the
    concatenation (the route the step took before)."""
    cuda_or_skip()
    S = request.getfixturevalue("main_solver" if layout == "cell" else "main_pair_solver")
    rng = np.random.default_rng(72)
    st = S._initial_state(0.0)
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=S.device)
    c = (st["c"].to(dtype) * to(rng.uniform(0.99, 1.01, tuple(st["c"].shape)))).contiguous()
    ce = (st["c_elim"].to(dtype) * to(rng.uniform(0.99, 1.01, tuple(st["c_elim"].shape))))
    cast = lambda d: {k: (v.to(dtype) if isinstance(v, torch.Tensor)
                          and v.is_floating_point() else v) for k, v in d.items()}
    g, mem = cast(S.g), cast(S.mem_dev)
    z, D, rho = S.z.to(dtype), S.D.to(dtype), S.rho.to(dtype)
    tab = assembly.cell_tables(g, z, D=D, rho=rho)
    out = assembly.knp_emit_buffers(g, mem, S.N_ions, dtype, S.device, layout == "pair")
    got = assembly.alpha_sum(z, D, c, ce, out=out, tables=tab)
    assert got is out.alpha
    call = torch.cat([c, ce[None]])
    for ref in (assembly.alpha_sum_ordered_plain(z, D, c, ce), assembly.alpha_sum(z, D, call)):
        assert torch.equal(_bits(got), _bits(ref))
    el = assembly.eliminated_concentration(c, tables=tab)
    z_elim = float(S.ion_list[-1].z)
    for ref in (assembly.eliminated_concentration_ordered_plain(c, z[:-1], rho, z_elim),
                assembly.eliminated_concentration(c, z[:-1].contiguous(), rho, z_elim)):
        assert torch.equal(_bits(el), _bits(ref))


@pytest.mark.parametrize("name,kernel", [("alpha_sum", "alpha_sum_kernel"),
                                         ("eliminated_concentration", "eliminated_kernel")])
def test_ion_sum_is_one_launch_on_the_step_route(main_solver, name, kernel):
    """alpha_sum and eliminated_concentration as the solver's step calls
    them at the main path's 124,416 cells: ten calls in one profiler
    session are ten counted calls and ten launches of the kernel and
    nothing else on the device; alpha_sum's allocates nothing (the step's
    buffer), eliminated_concentration's one new tensor a call (the state
    keeps c_elim)."""
    S = main_solver
    st = S._initial_state(0.0)
    tab, out = S._cell_tables(), S._emit_out("membrane_emit")
    c, ce = st["c"], st["c_elim"]
    call = ((lambda: assembly.alpha_sum(S.z, S.D, c, ce, out=out, tables=tab))
            if name == "alpha_sum" else (lambda: assembly.eliminated_concentration(
                c, tables=tab)))
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        # a profiler session on the card can return fewer device events
        # than were launched: up to three sessions, until one reads five
        allocs = torch.cuda.memory_stats(S.device)["allocation.all.allocated"]
        n0 = _cuda.LAUNCHES[name]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        made = torch.cuda.memory_stats(S.device)["allocation.all.allocated"] - allocs
        assert made == (0 if name == "alpha_sum" else 10)
        assert _cuda.LAUNCHES[name] == n0 + 10
        if len(kernels) >= 5:
            break
    assert 5 <= len(kernels) <= 10 and all(kernel in k for k in kernels), kernels


def test_ion_sums_refuse_what_they_were_not_built_for(main_solver):
    """Seven ions (alpha_sum), six solved ions (eliminated_concentration)
    and nd = 5 raise NotImplementedError on the card, and tables without D
    or rho, or of other charges or fields, and alpha_sum's c_elim or out
    without tables, ValueError, before any launch."""
    dev = cuda_or_skip()
    S = main_solver
    rng = np.random.default_rng(73)
    n0 = dict(_cuda.LAUNCHES)
    g, z, D, rho = _node_tables(4, 64, 7, torch.float64, dev, rng)
    c = torch.ones((7, 4, 64), dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError):
        assembly.alpha_sum(z, D, c)
    with pytest.raises(NotImplementedError):
        assembly.eliminated_concentration(c[:6].contiguous(), z[:6].contiguous(), rho, 1.0)
    c5 = torch.ones((2, 5, 64), dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError):
        assembly.alpha_sum(z[:2].contiguous(), D[:2].contiguous(), c5)
    with pytest.raises(NotImplementedError):
        assembly.eliminated_concentration(c5, z[:2].contiguous(), rho, 1.0)
    st = S._initial_state(0.0)
    bare = assembly.cell_tables(S.g, S.z)
    with pytest.raises(ValueError):
        assembly.alpha_sum(S.z, S.D, st["c"], st["c_elim"], tables=bare)
    with pytest.raises(ValueError):
        assembly.eliminated_concentration(st["c"], tables=bare)
    tab = S._cell_tables()
    with pytest.raises(ValueError):
        assembly.alpha_sum(S.z, S.D.clone(), st["c"], st["c_elim"], tables=tab)
    with pytest.raises(ValueError):
        assembly.eliminated_concentration(st["c"], S.z[:-1], tables=tab)
    with pytest.raises(ValueError):
        assembly.alpha_sum(S.z, S.D, st["c"], st["c_elim"])
    with pytest.raises(ValueError):
        assembly.alpha_sum(S.z, S.D, st["c"], st["c_elim"], out=S._emit_out("membrane_emit"))
    with pytest.raises(TypeError):
        assembly.alpha_sum(S.z, S.D, st["c"].float(), st["c_elim"], tables=tab)
    with pytest.raises(ValueError):
        assembly.eliminated_concentration(st["c"][:, :, :-1].contiguous(), tables=tab)
    assert _cuda.LAUNCHES == n0


def test_pair_matvec_reads_only_the_owner_halves(pair_maps):
    """pair_matvec at m = 1 and pair_matvec_multi at m = 2, on maps with
    self-pairs, dummy slots and a thread count that is not a multiple of
    the block: the plain version to round-off in both dtypes, and bit for
    bit the same output when pe holds NaN outside the owner halves (the
    kernel never reads those rows)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(13)
    pm = pairs.pair_maps_to_device(pair_maps, dev)
    S, npair = pair_maps["ext_f"].shape
    assert (~pair_maps["live1"]).any() and (pair_maps["ext_f"] == pair_maps["nf"]).any()
    assert npair % 128
    nf1 = int(pair_maps["nf"]) + 1
    rows = pairs.owner_half_rows(pm, 4)
    for dtype, tol in DTYPES:
        A = _rand(rng, (2, 4, 4, 2 * npair), dtype, dev)
        Ms = [_rand(rng, (2, 4, 4, nf1), dtype, dev) for _ in range(4)]
        for M in Ms:
            M[..., -1] = 0.0
        static = pairs.cell_bell_to_pair(pm, _rand(rng, (2, S // 2 + 2, 4, 4, 2 * npair),
                                                    dtype, dev))
        pd, pe = pairs.gather_blocks_pair_multi(None, pm, A, *Ms,
                                                add=tuple(t.contiguous() for t in static))
        xp = _rand(rng, (2, 8, npair), dtype, dev)
        poisoned = torch.where(rows, pe, float("nan"))
        n0 = _cuda.LAUNCHES["pair_matvec"]
        for m in (1, 2):
            D, E, x, P = (t[:m].contiguous() for t in (pd, pe, xp, poisoned))
            if m == 1:
                D, E, x, P = D[0], E[0], x[0], P[0]
                mv, plain = pairs.pair_matvec, pairs.pair_matvec_plain
            else:
                mv, plain = pairs.pair_matvec_multi, pairs.pair_matvec_multi_plain
            y = mv(D, E, pm, x)
            assert rel(y, plain(D, E, pm, x)) < tol, (dtype, m)
            assert torch.equal(mv(D, P, pm, x), y), (dtype, m)
        assert _cuda.LAUNCHES["pair_matvec"] == n0 + 4


@pytest.mark.parametrize("nf", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_membrane_trace_fields_and_quantities_equal_the_one_field_calls(nf, dtype):
    """K14 with nf fields and every set of quantities (the mask) equals the
    one-field entry points (membrane_avg_m, jump_phi_M_m,
    nernst_potential_m) bitwise, in one launch per 4 fields; the solver's
    batched entry membrane_traces_m is its plus | minus | Nernst call and
    agrees with its plain version."""
    dev = cuda_or_skip()
    S, _ = tp.emix_torch(device="cuda")
    cast = lambda d: {k: (v.to(dtype) if isinstance(v, torch.Tensor)
                          and v.is_floating_point() else v) for k, v in d.items()}
    g, mem, p = cast(S.g), cast(S.mem_dev), S.params
    rng = np.random.default_rng(20)
    fields = [torch.as_tensor(rng.uniform(1.0, 100.0, (S.nd, S.n_cells)), dtype=dtype,
                              device=dev) for _ in range(nf)]
    zs = [1.0, -1.0, 2.0, 1.0, -1.0][:nf]
    coefs = [assembly.nernst_coef(z, p.F, p.R, p.temperature) for z in zs]
    one = {assembly.TRACE_PLUS: lambda f: assembly.membrane_avg_m(g, mem, fields[f], "p"),
           assembly.TRACE_MINUS: lambda f: assembly.membrane_avg_m(g, mem, fields[f], "m"),
           assembly.TRACE_JUMP: lambda f: assembly.jump_phi_M_m(g, mem, fields[f]),
           assembly.TRACE_NERNST: lambda f: assembly.nernst_potential_m(
               g, mem, fields[f], zs[f], p.F, p.R, p.temperature)}
    for mask in range(1, 16):
        bits = [b for b in sorted(one) if mask & b]
        n0 = _cuda.LAUNCHES["membrane_trace"]
        out = assembly._membrane_trace_cuda(g, mem, fields, coefs, mask)
        assert _cuda.LAUNCHES["membrane_trace"] == n0 + -(-nf // assembly.MAX_TRACE_FIELDS)
        assert tuple(out.shape) == (len(bits), nf, S.n_mem)
        for o, b in enumerate(bits):
            for f in range(nf):
                assert torch.equal(out[o, f], one[b](f)), (mask, b, f)
    tr = assembly.membrane_traces_m(g, mem, fields, coefs)
    full = assembly.TRACE_PLUS | assembly.TRACE_MINUS | assembly.TRACE_NERNST
    assert torch.equal(tr, assembly._membrane_trace_cuda(g, mem, fields, coefs, full))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert rel(tr, assembly.membrane_traces_m_plain(g, mem, fields, coefs)) < tol


def test_membrane_trace_launches_twice_a_step():
    """A float64 step of the EMIx fixture makes two K14 trace launches:
    every ion's ODE-input traces in one, the finalize jump in the other
    (counted by the wrapper and read in the profiler's second cycle)."""
    cuda_or_skip()
    S, sp = tp.emix_torch(device="cuda")
    state = [S.attach_pc(S._initial_state(0.0), sp)]
    steps = [0]

    def step():
        state[0], _ = S.run_block(state[0], sp, 1)
        steps[0] += 1

    step()
    n0, s0 = _cuda.LAUNCHES["membrane_trace"], steps[0]
    # up to three sessions of two steps each; only a short reading is taken again
    kernels = _device_kernels(step, sessions=3, want=2, match="membrane_trace_kernel")
    assert _cuda.LAUNCHES["membrane_trace"] - n0 == 2 * (steps[0] - s0)
    traces = [k for k in kernels if "membrane_trace_kernel" in k]
    assert len(traces) == 2, kernels


def test_assembly_wrappers_raise_on_what_they_cannot_take():
    """Non-contiguous or mistyped inputs and shapes outside the kernels'
    register arrays (nd <= 4, d <= 3) raise on the card instead of running
    plain."""
    dev = cuda_or_skip()
    S, _ = tp.emix_torch(device="cuda")
    g, mem, p = S.g, S.mem_dev, S.params
    nd, nc = S.nd, S.n_cells
    call = torch.cat([S.c_init, S.c_elim_init[None]])
    with pytest.raises(ValueError):                      # not contiguous
        assembly.emi_cell(g, S.z, S.D, call.transpose(1, 2).contiguous().transpose(1, 2),
                          p.F, p.psi)
    with pytest.raises(TypeError):                       # dtype mismatch
        assembly.alpha_sum(S.z, S.D, call.float())
    with pytest.raises(ValueError):                      # wrong shape
        assembly.knp_cell(g, S.phi_init[:3].contiguous(), S.c_init, p.dt)
    with pytest.raises(ValueError):
        assembly.jump_phi_M_m(g, mem, S.phi_init.t().contiguous().t())
    with pytest.raises(ValueError):
        assembly.eliminated_concentration(S.c_init, S.z[:-1], S.rho[:-1].contiguous(), 1.0)
    # a fifth basis function: outside the kernels' register arrays
    g5 = dict(g, f_Rp=torch.zeros((2, 5, 8), dtype=torch.float64, device=dev),
              G=torch.zeros((5, 3, nc), dtype=torch.float64, device=dev))
    c5 = torch.ones((3, 5, nc), dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError):
        assembly.emi_cell(g5, S.z, S.D, c5, p.F, p.psi)
    with pytest.raises(NotImplementedError):
        assembly.knp_cell(g5, c5[0].contiguous(), c5[:2].contiguous(), p.dt)
    mem5 = dict(mem, Rp=torch.zeros((2, 5, 8), dtype=torch.float64, device=dev))
    with pytest.raises(NotImplementedError):
        assembly.membrane_avg_m(g, mem5, c5[0].contiguous(), "p")


def test_assembly_kernels_take_the_2d_shapes():
    """The 2D neuron (nd = 3, d = 2) goes through the same assembly and trace
    kernels: its EMI and KNP operators and the membrane jump on the card
    agree with the CPU's at a seeded state."""
    dev = cuda_or_skip()
    Sc, Sg = tp._neuron_2d("torch"), tp._neuron_2d("torch", device=dev)
    rng = np.random.default_rng(10)
    noise = rng.uniform(0.99, 1.01, tuple(Sc.c_init.shape))
    phi = 0.01 * rng.standard_normal(tuple(Sc.phi_init.shape))
    outs = []
    for S in (Sc, Sg):
        st = S._initial_state(0.0)
        to = lambda a: torch.as_tensor(a, dtype=torch.float64, device=S.device)
        c, ph = st["c"] * to(noise), to(phi)
        pM, Ich, Itot = S._pads(st)
        n0 = dict(_cuda.LAUNCHES)
        b, r, P = S._assemble_emi(c, st["c_elim"], pM, Itot, st["t"])
        bK, rK = S._knp_assemble_all(c, st["c_elim"], ph, pM, Ich, Itot, st["t"], c)
        outs.append((b, r, P, bK, rK, assembly.jump_phi_M_m(S.g, S.mem_dev, ph),
                     assembly.eliminated_concentration(c, S.z[:-1], S.rho, 1.0)))
    assert all(_cuda.LAUNCHES[k] > n0[k] for k in ASSEMBLY_KERNELS)
    for a_cpu, a_gpu in zip(*outs):
        assert rel(a_gpu, a_cpu) < 1e-12


# ---------------------------------------------------------------------------
# the Krylov kernels K8, K9 and the gather probes P1, P2
# ---------------------------------------------------------------------------

def _gmres_case(rng, dtype, dev, j, mb=2, n=5000, m=8):
    """A GMRES work with rows 0..j of an orthonormal basis written (the rest
    zero, as the plain versions' basis is), a random new vector w, and
    scalars of step j: system 0 live, the others frozen."""
    wk = ko.gmres_work(mb, n, m, dtype, dev)
    wk.V.zero_()
    for s in range(mb):
        wk.V[:j + 1, s] = torch.linalg.qr(_rand(rng, (n, j + 1), dtype, dev))[0].T
    w = _rand(rng, (mb, n), dtype, dev)
    wk.tol.fill_(1e3)
    wk.tol[0] = 1e-3
    wk.g[:, :j + 1] = _rand(rng, (mb, j + 1), dtype, dev)
    wk.g[0, j] = 5.0
    ang = torch.as_tensor(rng.uniform(0, 2 * np.pi, (mb, m)), dtype=dtype, device=dev)
    wk.cs[:, :j], wk.sn[:, :j] = torch.cos(ang[:, :j]), torch.sin(ang[:, :j])
    wk.R.copy_(_rand(rng, (mb, m + 1, m), dtype, dev))
    wk.R[:, range(m), range(m)] += 4.0                   # well conditioned
    wk.h1[:, :j + 1] = _rand(rng, (mb, j + 1), dtype, dev)
    wk.h2[:, :j + 1] = 1e-3 * _rand(rng, (mb, j + 1), dtype, dev)
    wk.hj1.fill_(0.5)
    wk.hj1[0] = 2.0
    wk.ks.fill_(max(j - 1, 0))
    wk.ks[0] = j
    return wk, w


def _clone_work(wk):
    import chip_smoke

    return chip_smoke.work_copy(wk)


def _step_outputs(wk, j):
    return [wk.h1[:, :j + 1], wk.h2[:, :j + 1], wk.hj1, wk.V[j + 1], wk.R, wk.g, wk.cs, wk.sn,
            wk.ks, wk.flag]


@pytest.mark.parametrize("j", [0, 3])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_krylov_gmres_kernels_match_plain(j, dtype, tol):
    """Each K9 entry point against its whole-basis plain version on the
    same CUDA tensors (the kernels read only rows 0..j), one launch each:
    the Arnoldi step's outputs against chip_smoke.arnoldi_scales (each sum's
    |terms| carried through CGS2; the Givens scalars against each output's
    largest value; ks and the flag exactly)."""
    import chip_smoke

    dev = cuda_or_skip()
    rng = np.random.default_rng(11)
    wk, w = _gmres_case(rng, dtype, dev, j)
    rows = j + 1
    n0 = dict(_cuda.LAUNCHES)
    h = ko.gmres_cgs_dot(wk.V, w, rows, torch.zeros_like(wk.h1), wk)
    h_p = ko.gmres_cgs_dot_plain(wk.V, w, rows, torch.zeros_like(wk.h1))
    assert rel(h[:, :rows], h_p[:, :rows]) < tol
    a, b = _clone_work(wk), _clone_work(wk)
    ko.gmres_arnoldi(w.clone(), a, j)
    ko.gmres_arnoldi_plain(w.clone(), b, j)
    got, ref = _step_outputs(a, j), _step_outputs(b, j)
    for k, (x, y, sc) in enumerate(zip(got, ref, chip_smoke.arnoldi_scales(wk, w, j, ref))):
        assert chip_smoke.err(x, y, sc)[1] < tol, k
    assert not bool(a.V[j + 1, 1:].any())                  # the frozen systems
    a, b = _clone_work(b), _clone_work(b)
    x = _rand(rng, (2, w.shape[1]), dtype, dev)
    xa = ko.gmres_solve_update(a, x.clone())
    xb = ko.gmres_solve_update_plain(b, x.clone())
    assert rel(xa, xb) < 10 * tol
    a, b = _clone_work(wk), _clone_work(wk)
    ko.gmres_start(w, a)
    ko.gmres_start_plain(w, b)
    assert rel(a.beta, b.beta) < tol and rel(a.V[0], b.V[0]) < tol
    assert rel(a.g, b.g) < tol and torch.equal(a.flag, b.flag)
    for k in KRYLOV_KERNELS[3:]:
        assert _cuda.LAUNCHES[k] == n0[k] + 1, k


# (entries a system, step j, systems): the main path's sizes at chip_smoke's
# KRYLOV_ROWS (cell layout 4 x 124,416 entries a system, a larger mesh's,
# and 4,000,001, whose chunks of w do not fit in shared memory beside the
# co-resident blocks: the re-read layout), a late step of three systems
# whose blocks span two systems, and one entry each of 32 systems
ARNOLDI_SIZES = [(497664, 3, 2), (1016928, 3, 2), (4000001, 3, 2), (3 * 2048 + 17, 29, 3),
                 (1, 0, 32)]


@pytest.mark.parametrize("n,j,mb", ARNOLDI_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gmres_arnoldi_equals_the_ordered_plain_bitwise(n, j, mb, dtype):
    """gmres_arnoldi writes h1, h2, hj1, V[j+1], R, g, cs, sn, ks and the
    flag to the last bit of gmres_arnoldi_ordered_plain's, in each of 200
    calls on one work (chip_smoke.arnoldi_exact: the outputs NaN before
    every call), staged in shared memory at the main sizes and re-read at
    4,000,001 entries; the grid at most the chunks."""
    import chip_smoke

    dev = cuda_or_skip()
    rng = np.random.default_rng(19)
    wk, w = _gmres_case(rng, dtype, dev, j, mb=mb, n=n, m=30)
    units = mb * -(-n // ko.RED_CHUNK)
    assert 1 <= wk.grid <= units and (wk.grid - 1) * wk.upb < units <= wk.grid * wk.upb
    assert wk.staged == int(n < 4000000), (wk.grid, wk.upb, wk.staged)
    n0 = _cuda.LAUNCHES["gmres_arnoldi"]
    chip_smoke.arnoldi_exact("gmres_arnoldi", dtype, ko, w, wk, j, calls=200)
    assert _cuda.LAUNCHES["gmres_arnoldi"] == n0 + 200


# (entries a system, systems): the cell layout's KNP batch size (4 x
# 124,416) and a larger mesh's, staged in shared memory where the Arnoldi
# step stages, and 4,000,001, read again; with 1, 2 and 32 systems
START_SIZES = [(n, mb) for n in (497664, 1016928, 4000001) for mb in (1, 2, 32)]


@pytest.mark.parametrize("n,mb", START_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gmres_start_equals_the_ordered_plain_bitwise(n, mb, dtype):
    """gmres_start writes V[0], beta, R, g, cs, sn, ks and the flag to the
    last bit of gmres_start_ordered_plain's (the earlier three kernels'
    order), in each of 200 calls on one work (chip_smoke.start_exact: the
    outputs NaN / -1 before every call), one system's residual zero; the
    flag set where some beta exceeds its tolerance."""
    import chip_smoke

    dev = cuda_or_skip()
    rng = np.random.default_rng(25)
    wk = ko.gmres_work(mb, n, 4, dtype, dev)
    r = _rand(rng, (mb, n), dtype, dev)
    if mb > 1:
        r[-1] = 0.0
    wk.tol.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, mb) * n ** 0.5, dtype=dtype))
    n0 = _cuda.LAUNCHES["gmres_start"]
    chip_smoke.start_exact("gmres_start", dtype, ko, r, wk, calls=200)
    assert _cuda.LAUNCHES["gmres_start"] == n0 + 200


def test_gmres_start_is_one_launch_and_allocates_nothing():
    """Five cycle starts of a cell-layout KNP batch (2 x 4 x 124,416) are
    five gm_start_kernel launches, nothing else on the device, and no
    allocation (the caching allocator's count)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(26)
    wk = ko.gmres_work(2, 497664, 30, torch.float64, dev)
    r = _rand(rng, (2, 497664), torch.float64, dev)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]

    def starts():
        for _ in range(5):
            ko.gmres_start(r, wk)

    kernels = _device_kernels(starts, sessions=3, want=5, match="gm_start")
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
    assert len(kernels) == 5 and all("gm_start_kernel" in k for k in kernels), kernels


def test_gmres_start_replays_in_a_cuda_graph():
    """The start allocates nothing, syncs nothing and keeps fixed pointers,
    so a captured start and Arnoldi step replay: every output the eager
    calls' to the last bit."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(27)
    wk, w = _gmres_case(rng, torch.float64, dev, 0, n=20000, m=12)
    r = _rand(rng, w.shape, torch.float64, dev)
    base, eager = _clone_work(wk), _clone_work(wk)
    ko.gmres_start(r, eager)
    ko.gmres_arnoldi(w.clone(), eager, 0)
    wg = w.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ko.gmres_start(r, _clone_work(wk))                   # warm: the library loaded
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ko.gmres_start(r, wk)
        ko.gmres_arnoldi(wg, wk, 0)
    for _ in range(3):
        for name in ko.GmresWork._fields[:13]:
            getattr(wk, name).copy_(getattr(base, name))
        wg.copy_(w)
        graph.replay()
    torch.cuda.synchronize()
    for name in ("h1", "h2", "hj1", "beta", "R", "g", "cs", "sn", "ks", "flag"):
        assert torch.equal(getattr(wk, name), getattr(eager, name)), name
    assert torch.equal(wk.V[:2], eager.V[:2])


def test_gmres_start_raises_on_a_refused_launch():
    """A grid of more blocks than can be resident together (one a chunk at
    4,000,001 entries a system) is refused by the cooperative launch: the
    wrapper raises, counts no launch, the work is untouched, and the
    refusal leaves no error behind for the next launch."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(28)
    wk = ko.gmres_work(2, 4000001, 8, torch.float64, dev)
    r = _rand(rng, (2, 4000001), torch.float64, dev)
    units = 2 * -(-4000001 // ko.RED_CHUNK)
    assert wk.grid < units
    base = _clone_work(wk)
    n0 = _cuda.LAUNCHES["gmres_start"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ko.gmres_start(r, wk._replace(grid=units, upb=1))
    assert _cuda.LAUNCHES["gmres_start"] == n0
    torch.cuda.synchronize()
    for name in ("beta", "R", "g", "cs", "sn", "ks", "flag"):
        assert torch.equal(getattr(wk, name), getattr(base, name)), name
    ko.gmres_start(r, wk)
    assert _cuda.LAUNCHES["gmres_start"] == n0 + 1


def test_gmres_arnoldi_is_one_launch_and_allocates_nothing():
    """Five Arnoldi steps of a pair-layout KNP batch (2 x 8 x 63,558) are
    five gm_arnoldi_kernel launches, nothing else on the device, and no
    allocation (the caching allocator's count)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(21)
    wk, w = _gmres_case(rng, torch.float64, dev, 5, n=8 * 63558, m=30)
    base = _clone_work(wk)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]

    def steps():
        for j in range(5):
            ko.gmres_arnoldi(w, wk, j)

    kernels = _device_kernels(steps, sessions=3, want=5, match="gm_arnoldi_kernel")
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
    assert len(kernels) == 5 and all("gm_arnoldi_kernel" in k for k in kernels), kernels
    assert torch.equal(wk.V[0], base.V[0])               # a row it only reads


def test_gmres_arnoldi_replays_in_a_cuda_graph():
    """The step allocates nothing, syncs nothing and keeps fixed pointers,
    so three captured steps (one cooperative launch each) replay: every
    output the eager steps' to the last bit."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(22)
    wk, w = _gmres_case(rng, torch.float64, dev, 0, n=20000, m=12)
    ws = [_rand(rng, w.shape, torch.float64, dev) for _ in range(3)]
    base, eager = _clone_work(wk), _clone_work(wk)
    for j in range(3):
        ko.gmres_arnoldi(ws[j].clone(), eager, j)
    wg = [v.clone() for v in ws]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ko.gmres_arnoldi(wg[0].clone(), _clone_work(wk), 0)   # warm: the library loaded
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for j in range(3):
            ko.gmres_arnoldi(wg[j], wk, j)
    for _ in range(3):
        for name in ko.GmresWork._fields[:13]:
            getattr(wk, name).copy_(getattr(base, name))
        for a, b in zip(wg, ws):
            a.copy_(b)
        graph.replay()
    torch.cuda.synchronize()
    for name in ("V", "h1", "h2", "hj1", "R", "g", "cs", "sn", "ks", "flag"):
        assert torch.equal(getattr(wk, name), getattr(eager, name)), name


def test_gmres_entries_refuse_a_work_without_workspace():
    """A GmresWork built by hand has no partials and no launch shape: the
    K9 entries raise on CUDA tensors rather than allocate; so do vectors of
    another shape, layout or dtype than the work's, and a step outside the
    restart.  No launch is counted."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(23)
    wk, w = _gmres_case(rng, torch.float64, dev, 2)
    bare = ko.GmresWork(*wk[:13])
    n0 = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="gmres_work"):
        ko.gmres_arnoldi(w, bare, 2)
    with pytest.raises(ValueError, match="gmres_work"):
        ko.gmres_start(w, bare)
    with pytest.raises(ValueError, match="gmres_work"):
        ko.gmres_solve_update(bare, w.clone())
    with pytest.raises(ValueError, match="gmres_work"):
        ko.gmres_cgs_dot(wk.V, w, 3, wk.h1)
    with pytest.raises(ValueError, match="gmres_work"):
        ko.gmres_cgs_dot(wk.V, w, 3, wk.h1, bare)
    with pytest.raises(ValueError):                      # another shape
        ko.gmres_arnoldi(w[:, :-1].contiguous(), wk, 2)
    with pytest.raises(ValueError):                      # not contiguous
        ko.gmres_arnoldi(torch.ones((w.shape[1], 2), dtype=w.dtype, device=dev).t(), wk, 2)
    with pytest.raises(TypeError):                       # another dtype
        ko.gmres_arnoldi(w.float(), wk, 2)
    with pytest.raises(ValueError):                      # beyond the restart
        ko.gmres_arnoldi(w, wk, wk.m)
    for k in KRYLOV_KERNELS[3:]:
        assert _cuda.LAUNCHES[k] == n0[k], k


def test_gmres_arnoldi_raises_on_a_refused_launch():
    """A grid of more blocks than can be resident together (one a chunk at
    4,000,001 entries a system) is refused by the cooperative launch: the
    wrapper raises, counts no launch, the work is untouched, and the
    refusal leaves no error behind for the next launch."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(24)
    wk, w = _gmres_case(rng, torch.float64, dev, 1, n=4000001, m=8)
    units = 2 * -(-4000001 // ko.RED_CHUNK)
    assert wk.grid < units
    base = _clone_work(wk)
    n0 = _cuda.LAUNCHES["gmres_arnoldi"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ko.gmres_arnoldi(w, wk._replace(grid=units, upb=1), 1)
    assert _cuda.LAUNCHES["gmres_arnoldi"] == n0
    torch.cuda.synchronize()
    for name in ("h1", "h2", "hj1", "R", "g", "cs", "sn", "ks", "flag"):
        assert torch.equal(getattr(wk, name), getattr(base, name)), name
    ko.gmres_arnoldi(w, wk, 1)
    assert _cuda.LAUNCHES["gmres_arnoldi"] == n0 + 1


def _bytes(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("n", [497664, 4000001], ids=["staged", "re-read"])
def test_gmres_arnoldi_with_the_flag_0_writes_nothing(n):
    """An Arnoldi step launched with the work's flag 0 (a step the
    look-ahead loop queued after a cycle's exit) leaves w and every tensor
    of the work, partials and tickets included, byte for byte as they were,
    in both launch layouts; with the flag 1 the same step writes."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(29)
    for flag in (0, 1):
        wk, w = _gmres_case(rng, torch.float64, dev, 3, n=n, m=30)
        wk.flag.fill_(flag)
        tensors = [w] + [t for t in wk if isinstance(t, torch.Tensor)]
        before = [t.clone() for t in tensors]
        n0 = _cuda.LAUNCHES["gmres_arnoldi"]
        ko.gmres_arnoldi(w, wk, 3)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["gmres_arnoldi"] == n0 + 1
        same = all(torch.equal(_bytes(a), _bytes(b)) for a, b in zip(tensors, before))
        assert same == (flag == 0), flag


# (entries a system, ks a system): the main path's KNP batches (cell 4 x
# 124,416, pair 8 x 63,558 entries a system: 16-byte accesses) at the
# float64 and float32 windows' rows, an odd length (one entry an access),
# a length of whole 16-byte vectors in float64 but not in float32, a
# multiple of the chunks; ks from {0, 1, 4, 16, 30} with 1, 2, 3 and 32
# systems
SOLVE_KS = (0, 1, 4, 16, 30)
SOLVE_SIZES = [(497664, (4, 4)), (508464, (16, 4)), (6161, (30,)), (6161, (0, 1, 30)),
               (4002, (4, 16)), (4002, (0, 1, 30)), (8192, (16,)),
               (2052, tuple(SOLVE_KS[i % 5] for i in range(32)))]


def _solve_case(rng, dtype, dev, n, ks, m=30):
    """A work at the end of a cycle of ks[s] steps a system: random basis
    rows, a well-conditioned R, random g; and a random x."""
    mb = len(ks)
    wk = ko.gmres_work(mb, n, m, dtype, dev)
    wk.V[:m] = _rand(rng, (m, mb, n), dtype, dev) / n ** 0.5
    R = 0.3 * _rand(rng, (mb, m + 1, m), dtype, dev)
    R[:, range(m), range(m)] += 2.0
    wk.R.copy_(R)
    wk.g.copy_(_rand(rng, (mb, m + 1), dtype, dev))
    wk.ks.copy_(torch.tensor(ks, dtype=torch.int32))
    return wk, _rand(rng, (mb, n), dtype, dev)


@pytest.mark.parametrize("n,ks", SOLVE_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gmres_solve_update_equals_the_ordered_plain_bitwise(n, ks, dtype):
    """gmres_solve_update writes x and y to the last bit of
    gmres_solve_update_ordered_plain's (the earlier back-substitution and
    update kernels' order) in each of 50 calls (chip_smoke.
    solve_update_exact: x restored and y NaN before every call), a system
    with ks = 0 untouched but for its zero y; one launch counted a call."""
    import chip_smoke

    dev = cuda_or_skip()
    rng = np.random.default_rng(30 + len(ks))
    wk, x = _solve_case(rng, dtype, dev, n, ks)
    n0 = _cuda.LAUNCHES["gmres_solve_update"]
    chip_smoke.solve_update_exact("gmres_solve_update", dtype, ko, wk, x, calls=50)
    assert _cuda.LAUNCHES["gmres_solve_update"] == n0 + 50


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gmres_solve_update_takes_an_unaligned_x(dtype):
    """x starting one entry past a 16-byte boundary (a contiguous view) is
    updated one entry an access, to the same bits as an aligned copy."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(31)
    wk, x = _solve_case(rng, dtype, dev, 8192, (16, 4))
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    xu = buf[1:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 and xu.is_contiguous()
    want = ko.gmres_solve_update_ordered_plain(_clone_work(wk), x.clone())
    ko.gmres_solve_update(wk, xu)
    ko.gmres_solve_update(_clone_work(wk), x)
    torch.cuda.synchronize()
    assert torch.equal(_bytes(xu), _bytes(want)) and torch.equal(_bytes(x), _bytes(want))


def test_gmres_solve_update_is_one_launch_and_replays():
    """Five cycle ends of a cell-layout KNP batch (2 x 4 x 124,416 at 4
    rows) are five gm_solve_update_kernel launches, nothing else on the
    device, and no allocation; a captured call replays to the eager call's
    bits."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(32)
    wk, x = _solve_case(rng, torch.float64, dev, 497664, (4, 4))
    eager = ko.gmres_solve_update(_clone_work(wk), x.clone())
    xg = x.clone()
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]

    def ends():
        for _ in range(5):
            ko.gmres_solve_update(wk, xg)

    kernels = _device_kernels(ends, sessions=3, want=5, match="gm_solve_update")
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
    assert len(kernels) == 5 and all("gm_solve_update_kernel" in k for k in kernels), kernels
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ko.gmres_solve_update(_clone_work(wk), x.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ko.gmres_solve_update(wk, xg)
    for _ in range(3):
        xg.copy_(x)
        wk.y.fill_(float("nan"))
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bytes(xg), _bytes(eager))


@pytest.mark.parametrize("lag", [False, True])
@pytest.mark.parametrize("case", ["early", "restarts"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lookahead_gmres_on_the_card_equals_the_stepwise_loop(dtype, case, lag, monkeypatch):
    """krylov.gmres_batched on the card returns the x bits, the counts and
    the residual-norm bits of the stepwise loop (the flag read after every
    step) on the same kernels: one cycle with a system converging early,
    and restarts; with the flag forced late, one frozen step in each cycle
    that ended on the flag; with it home, at most one a cycle."""
    dev = cuda_or_skip()
    if lag:
        monkeypatch.setattr(krylov._FlagLookahead, "done", lambda self, j: False)
    restart, easy = (20, (0,)) if case == "early" else (3, (1,))
    rtol = 1e-10 if dtype == torch.float64 else 1e-5
    rng = np.random.default_rng(33)
    mv, pc = tp.gmres_torch_ops(tp.gmres_operators(rng, 2, 2048, easy), dtype, dev)
    b = torch.as_tensor(rng.normal(size=(2, 4, 512)), dtype=dtype, device=dev)
    x_s, it_s, rn_s, conv_s, early = tp.gmres_stepwise(mv, b, pc, rtol, 0.0, 300, restart)
    before = dict(krylov.GMRES_LOOKAHEAD)
    res = krylov.gmres_batched(mv, b, torch.zeros_like(b), pc, rtol, 0.0, 300, restart)
    count = {k: krylov.GMRES_LOOKAHEAD[k] - before[k] for k in before}
    assert torch.equal(_bytes(res.x), _bytes(x_s))
    assert res.iters == it_s and res.converged == conv_s
    assert torch.equal(_bytes(res.resnorm), _bytes(rn_s))
    assert count["frozen"] == early if lag else count["frozen"] <= count["cycles"]
    if case == "restarts":
        assert count["cycles"] > 1


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_krylov_pcg_kernels_match_plain(mode, dtype, tol):
    """Each K8 entry point against its plain version on a live work (flag
    1): no projection, the mean (cell layout) and the masked mean (pair
    layout); the count and the flag equal."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(12)
    shape = (8, 3001)
    x, r, p, Ap, z = (_rand(rng, shape, dtype, dev) for _ in range(5))
    w = torch.as_tensor(rng.uniform(size=shape) > 0.2, dtype=dtype, device=dev)
    wsum = w.sum() if mode == 2 else torch.tensor(float(x.numel()), dtype=dtype, device=dev)
    sc = torch.as_tensor([1.5, 2.0, 0.0, 0.0, 1e-6, 0.0], dtype=dtype, device=dev)
    sc[ko.WSUM] = wsum

    def work():
        return ko.pcg_work(sc.clone(), torch.ones(1, dtype=torch.int32, device=dev),
                           w if mode == 2 else None, mode, x.numel())

    a, b = work(), work()
    n0 = dict(_cuda.LAUNCHES)
    ko.pcg_dot(p, Ap, a)
    ko.pcg_dot_plain(p, Ap, b)
    assert rel(a.sc, b.sc) < tol
    xa, ra = ko.pcg_update(x.clone(), r.clone(), p, Ap, a)
    xb, rb = ko.pcg_update_plain(x.clone(), r.clone(), p, Ap, a)
    assert rel(xa, xb) < tol and rel(ra, rb) < tol
    pa = p.clone()
    ko.pcg_dot2_direction(r, z, pa, a)
    ko.pcg_dot2_direction_plain(r, z, p.clone(), b)
    assert rel(a.sc[:4], b.sc[:4]) < tol and torch.equal(a.flag, b.flag)
    assert a.iters.tolist() == b.iters.tolist() == [1]
    # the direction with the kernel's beta
    assert rel(pa, ko.pcg_direction_plain(p.clone(), z, a)) < tol
    for k in KRYLOV_KERNELS[:3]:
        assert _cuda.LAUNCHES[k] == n0[k] + 1, k


@pytest.mark.parametrize("n", [1, 2049, 3 * 2048 + 17, 256 * 2048 + 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcg_dots_equal_the_ordered_plain_bitwise(n, dtype):
    """pcg_dot (one launch, the last block finishing) and
    pcg_dot2_direction (one cooperative launch) write the scalars and flag
    that pcg_dots_ordered_plain's sums give, to the last bit, on fewer and
    more than 256 chunks, and the fused entry p = z + beta p with that
    beta; 200 calls on one work repeat the bits, each writes them
    (chip_smoke.dots_exact: the written slots are NaN before every call),
    and the ticket ends at 0."""
    import chip_smoke

    dev = cuda_or_skip()
    rng = np.random.default_rng(15)
    r, z, p, Ap = (_rand(rng, (n,), dtype, dev) for _ in range(4))
    sc0 = torch.as_tensor([1.25, 0.0, 0.0, 0.0, 1e-6, float(n)], dtype=dtype, device=dev)
    for entry, fn, vecs in (("pcg_dot", ko.pcg_dot, (p, Ap)),
                            ("pcg_dot2_direction", ko.pcg_dot2_direction, (r, z, p))):
        wk = ko.pcg_work(sc0.clone(), torch.ones(1, dtype=torch.int32, device=dev), None, 1, n)
        n0 = _cuda.LAUNCHES[entry]
        chip_smoke.dots_exact(entry, dtype, ko, fn, vecs, sc0, wk, calls=200)
        assert _cuda.LAUNCHES[entry] == n0 + 200


# the EMI vector's entries on the cell (4 x 124,416) and pair (8 x 63,558)
# layouts of chip_smoke.py's mesh, and more chunks (1,954) than an H100
# holds resident blocks of the fused kernel (at most 8 an SM, 1,056)
MAIN_SIZES = [497664, 508464, 4000001]


@pytest.mark.parametrize("n", MAIN_SIZES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_pcg_dot2_direction_at_the_main_sizes(n, dtype, tol):
    """The fused entry at the main path's sizes and beyond the resident
    blocks (each block then walks several chunks): the sums, beta and the
    flag bitwise pcg_dots_ordered_plain's and p = z + beta p with that beta
    to the last bit, over 200 repeating calls (chip_smoke.dots_exact); p
    against the plain version (torch.dot's beta) to tol of |z| + (|beta| +
    beta's sum of |terms| / |rz|) |p| elementwise."""
    import chip_smoke

    dev = cuda_or_skip()
    rng = np.random.default_rng(17)
    r, z, p = (_rand(rng, (n,), dtype, dev) for _ in range(3))
    sc0 = torch.as_tensor([1.25, 0.0, 0.0, 0.0, 1e-6, float(n)], dtype=dtype, device=dev)
    wk = ko.pcg_work(sc0.clone(), torch.zeros(1, dtype=torch.int32, device=dev), None, 1, n)
    nchunk = -(-n // ko.RED_CHUNK)
    assert 1 <= wk.grid <= nchunk and (n < 4000000 or wk.grid < nchunk), (wk.grid, nchunk)
    n0 = _cuda.LAUNCHES["pcg_dot2_direction"]
    chip_smoke.dots_exact("pcg_dot2_direction", dtype, ko, ko.pcg_dot2_direction, (r, z, p),
                          sc0, wk, calls=200)
    assert _cuda.LAUNCHES["pcg_dot2_direction"] == n0 + 200
    a = ko.pcg_work(sc0.clone(), torch.ones(1, dtype=torch.int32, device=dev), None, 1, n)
    b = ko.pcg_work(sc0.clone(), torch.ones(1, dtype=torch.int32, device=dev), None, 1, n)
    pa, pb = p.clone(), p.clone()
    ko.pcg_dot2_direction(r, z, pa, a)
    ko.pcg_dot2_direction_plain(r, z, pb, b)
    beta_scale = (r.abs() * z.abs()).sum() / sc0[ko.RZ]
    scale = z.abs() + (b.sc[ko.BETA].abs() + beta_scale) * p.abs()
    assert float(((pa.double() - pb.double()).abs() / scale.double()).max()) <= tol


def test_pcg_dot2_direction_raises_on_a_refused_launch():
    """A grid of more blocks than can be resident together (one per chunk
    at 4,000,001 entries) is refused by the cooperative launch: the wrapper
    raises, counts no launch, the work is untouched, and the refusal leaves
    no error behind for the next launch."""
    dev = cuda_or_skip()
    n = 4000001
    v = torch.ones(n, dtype=torch.float64, device=dev)
    sc0 = torch.as_tensor([1.0, 0.0, 0.0, 0.0, 1e-6, float(n)], dtype=torch.float64,
                          device=dev)
    wk = ko.pcg_work(sc0.clone(), torch.ones(1, dtype=torch.int32, device=dev), None, 1, n)
    nchunk = -(-n // ko.RED_CHUNK)
    assert wk.grid < nchunk
    n0 = _cuda.LAUNCHES["pcg_dot2_direction"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ko.pcg_dot2_direction(v, v, v.clone(), wk._replace(grid=nchunk))
    assert _cuda.LAUNCHES["pcg_dot2_direction"] == n0
    torch.cuda.synchronize()
    assert torch.equal(wk.sc, sc0)
    ko.pcg_dot2_direction(v, v, v.clone(), wk)
    assert _cuda.LAUNCHES["pcg_dot2_direction"] == n0 + 1


def test_pcg_iteration_launches_once_per_entry_and_allocates_nothing():
    """An iteration's K8 entries on a masked (pair-layout) live work:
    pcg_dot, pcg_update (one cooperative kernel: the update, its block sums
    in the work's partials, the projection) and pcg_dot2_direction are 3
    device kernels and no allocation (the caching allocator's count) per
    iteration; pcg_update gives the same bits with partials another entry
    has just written as with a fresh work."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(18)
    shape = (8, 63558)
    x, r, p, Ap, z = (_rand(rng, shape, torch.float64, dev) for _ in range(5))
    w = torch.as_tensor(rng.uniform(size=shape) > 0.1, dtype=torch.float64, device=dev)
    sc = torch.as_tensor([1.5, 2.0, 0.0, 0.0, 1e-6, 0.0], dtype=torch.float64, device=dev)
    sc[ko.WSUM] = w.sum()

    def work():
        return ko.pcg_work(sc.clone(), torch.ones(1, dtype=torch.int32, device=dev), w, 2,
                           x.numel())

    fresh, wk = work(), work()
    ko.pcg_dot(p, Ap, fresh)
    ko.pcg_dot(p, Ap, wk)
    ko.pcg_dot2_direction(r, z, p.clone(), wk)          # wk's partials now dirty
    wk.sc.copy_(fresh.sc)
    xa, ra = ko.pcg_update(x.clone(), r.clone(), p, Ap, fresh)
    xb, rb = ko.pcg_update(x.clone(), r.clone(), p, Ap, wk)
    assert torch.equal(xa, xb) and torch.equal(ra, rb)

    xi, ri, pi = x.clone(), r.clone(), p.clone()
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]

    def iterations():
        for _ in range(5):
            ko.pcg_dot(pi, Ap, wk)
            ko.pcg_update(xi, ri, pi, Ap, wk)
            ko.pcg_dot2_direction(ri, z, pi, wk)

    want = ["pcg_dot_kernel", "pcg_update_kernel", "pcg_dot2_direction_kernel"] * 5
    kernels = _device_kernels(iterations, sessions=3, want=len(want))
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
    assert len(kernels) == len(want) and all(k in e for k, e in zip(want, kernels)), kernels


def test_pcg_dots_replay_in_a_cuda_graph():
    """The K8 entries allocate nothing, sync nothing and keep fixed
    workspace pointers (the update and the fused entry cooperative
    launches), so a captured iteration's pcg_dot, pcg_update and
    pcg_dot2_direction replay: the same bits of the scalars, the count, the
    flag, x, r and the direction as the eager calls, the ticket back at
    0."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(16)
    p, Ap = (_rand(rng, (4, 9000), torch.float64, dev) for _ in range(2))
    sc0 = torch.as_tensor([1.5, 2.0, 0.0, 0.0, 1e-6, float(p.numel())], dtype=torch.float64,
                          device=dev)
    eager = ko.pcg_work(sc0.clone(), torch.ones(1, dtype=torch.int32, device=dev), None, 1,
                        p.numel())
    d0, x0, r0 = (_rand(rng, (4, 9000), torch.float64, dev) for _ in range(3))
    de, dg = d0.clone(), d0.clone()
    xe, re_, xg, rg = x0.clone(), r0.clone(), x0.clone(), r0.clone()
    ko.pcg_update(xe, re_, p, Ap, ko.pcg_dot(p, Ap, eager))
    ko.pcg_dot2_direction(p, Ap, de, eager)
    wk = ko.pcg_work(sc0.clone(), torch.ones(1, dtype=torch.int32, device=dev), None, 1,
                     p.numel())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ko.pcg_dot(p, Ap, wk)                            # warm: the library loaded
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ko.pcg_dot(p, Ap, wk)
        ko.pcg_update(xg, rg, p, Ap, wk)
        ko.pcg_dot2_direction(p, Ap, dg, wk)
    for _ in range(3):
        wk.sc.copy_(sc0)
        wk.iters.zero_()
        wk.flag.fill_(1)
        for t, t0 in ((dg, d0), (xg, x0), (rg, r0)):
            t.copy_(t0)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(wk.sc, eager.sc) and torch.equal(wk.flag, eager.flag)
    assert torch.equal(wk.iters, eager.iters)
    assert torch.equal(dg, de) and torch.equal(xg, xe) and torch.equal(rg, re_)
    assert wk.ticket.tolist() == [0]


def test_pcg_dots_refuse_a_work_without_workspace():
    """A PcgWork built by hand has no partials, ticket or grid: the K8
    entries raise on a CUDA tensor rather than allocate; so do vectors of
    another chunk count, layout or dtype than the work's."""
    dev = cuda_or_skip()
    v = torch.ones(3000, dtype=torch.float64, device=dev)
    bare = ko.PcgWork(sc=torch.ones(6, dtype=torch.float64, device=dev),
                      flag=torch.zeros(1, dtype=torch.int32, device=dev), w=None, mode=1)
    n0 = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="pcg_work"):
        ko.pcg_dot(v, v, bare)
    with pytest.raises(ValueError, match="pcg_work"):
        ko.pcg_dot2_direction(v, v, v.clone(), bare)
    with pytest.raises(ValueError, match="pcg_work"):
        ko.pcg_update(v.clone(), v.clone(), v, v, bare)
    wk = ko.pcg_work(bare.sc, bare.flag, None, 1, 3000)
    long = torch.ones(5000, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):                      # another chunk count
        ko.pcg_dot(long, long, wk)
    with pytest.raises(ValueError):                      # not contiguous
        ko.pcg_dot2_direction(v, torch.ones((3000, 2), dtype=torch.float64,
                                            device=dev)[:, 0], v.clone(), wk)
    with pytest.raises(ValueError):                      # the direction not contiguous
        ko.pcg_dot2_direction(v, v, torch.ones((3000, 2), dtype=torch.float64,
                                               device=dev)[:, 1], wk)
    with pytest.raises(TypeError):                       # another dtype
        ko.pcg_dot(v, v.float(), wk)
    for k in ("pcg_dot", "pcg_update", "pcg_dot2_direction"):
        assert _cuda.LAUNCHES[k] == n0[k], k


@pytest.mark.parametrize("n", MAIN_SIZES)
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcg_update_equals_the_ordered_plain_bitwise(n, mode, dtype):
    """pcg_update (one cooperative launch: the update, a grid barrier, the
    projection from registers) writes x and r to the last bit of
    pcg_update_ordered_plain's (the earlier update and projection kernels'
    order) at the main path's sizes and beyond the resident blocks (chunks
    past each block's first re-read after the barrier), in each of 50
    calls on restored inputs, one launch a call."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(30 + mode)
    x, r, p, Ap = (_rand(rng, (n,), dtype, dev) for _ in range(4))
    w = torch.as_tensor(rng.uniform(size=n) > 0.1, dtype=dtype, device=dev)
    wsum = w.sum() if mode == 2 else torch.tensor(float(n), dtype=dtype, device=dev)
    sc = torch.as_tensor([1.5, 2.0, 0.37, 0.0, 1e-6, 0.0], dtype=dtype, device=dev)
    sc[ko.WSUM] = wsum
    wk = ko.pcg_work(sc, torch.ones(1, dtype=torch.int32, device=dev),
                     w if mode == 2 else None, mode, n)
    nchunk = -(-n // ko.RED_CHUNK)
    assert 1 <= wk.grid <= nchunk and (n < 4000000 or wk.grid < nchunk), (wk.grid, nchunk)
    want = ko.pcg_update_ordered_plain(x.clone(), r.clone(), p, Ap, wk)
    xg, rg = x.clone(), r.clone()
    n0 = _cuda.LAUNCHES["pcg_update"]
    diff = torch.zeros(50, dtype=torch.int64, device=dev)
    for i in range(50):
        xg.copy_(x)
        rg.copy_(r)
        ko.pcg_update(xg, rg, p, Ap, wk)
        diff[i] = sum((_bits(a) != _bits(b)).sum() for a, b in zip((xg, rg), want))
    assert int(diff.max()) == 0
    assert _cuda.LAUNCHES["pcg_update"] == n0 + 50


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frozen_pcg_entries_write_nothing_on_the_card(dtype):
    """With the work's flag 0 (the loop has exited) each K8 entry launches
    (one count) and writes nothing: x, r, p, the scalars, the count, the
    flag, the partials and the ticket keep their bits, on a masked work
    whose partials another entry has just written."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(33)
    shape = (8, 63558)
    x, r, p, Ap, z = (_rand(rng, shape, dtype, dev) for _ in range(5))
    w = torch.as_tensor(rng.uniform(size=shape) > 0.1, dtype=dtype, device=dev)
    sc = torch.as_tensor([1.5, 2.0, 0.37, 0.5, 1e-6, 0.0], dtype=dtype, device=dev)
    sc[ko.WSUM] = w.sum()
    wk = ko.pcg_work(sc, torch.ones(1, dtype=torch.int32, device=dev), w, 2, x.numel())
    ko.pcg_dot2_direction(r, z, p.clone(), wk)            # partials written, count 1
    wk.flag.zero_()
    wk.iters.fill_(7)
    keep = [x, r, p, wk.sc, wk.flag, wk.iters, wk.partial, wk.ticket]
    before = [t.clone() for t in keep]
    n0 = dict(_cuda.LAUNCHES)
    ko.pcg_dot(p, Ap, wk)
    ko.pcg_update(x, r, p, Ap, wk)
    ko.pcg_dot2_direction(r, z, p, wk)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(keep, before)):
        assert torch.equal(a, b) if a.dtype == torch.int32 else torch.equal(_bits(a), _bits(b)), k
    for k in KRYLOV_KERNELS[:3]:
        assert _cuda.LAUNCHES[k] == n0[k] + 1, k


def test_pcg_lookahead_on_the_card_matches_the_cpu():
    """krylov.pcg on the card (the flag read one iteration behind through
    pinned memory) against the CPU's look-ahead loop on a projected SPD
    system: equal counts, x to 1e-10; max_it binding gives max_it live
    launches and no frozen one; a converged solve at most one frozen
    iteration (K8 launches = iterations + frozen)."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(34)
    B, nbr = _dominant_system(rng)
    P = B[1, 0] + np.swapaxes(B[1, 0], 0, 1)
    rhs = rng.normal(size=(4, B.shape[-1]))
    for max_it in (200, 5):
        res = {}
        for d in ("cpu", dev):
            Pt = torch.as_tensor(P, device=d)
            mv = lambda v: torch.einsum("ijc,jc->ic", Pt, v)
            n0 = dict(_cuda.LAUNCHES)
            f0 = krylov.PCG_LOOKAHEAD["frozen"]
            res[str(d)] = krylov.pcg(mv, torch.as_tensor(rhs, device=d),
                                     torch.zeros(4, P.shape[-1], dtype=torch.float64, device=d),
                                     lambda r: r / 6.0, rtol=1e-10, atol=0.0, max_it=max_it,
                                     project_nullspace=True)
            frozen = krylov.PCG_LOOKAHEAD["frozen"] - f0
        rc, rg = res["cpu"], res[str(dev)]
        assert rg.iters == rc.iters and rg.converged == rc.converged == (max_it == 200)
        assert rel(rg.x, rc.x) < 1e-10
        assert frozen <= (1 if rg.converged else 0)
        for k in KRYLOV_KERNELS[:3]:
            assert _cuda.LAUNCHES[k] == n0[k] + rg.iters + frozen, k


# (entries a system, populated rows, systems): the 3D KNP batches of the
# cell and pair layouts at chip_smoke's KRYLOV_ROWS and at one row (the
# solve's tolerance), the MMS path's one system (48 chunks), the 2D app's
# two ions (744 entries: one chunk each), and beyond 1,024 chunks
CGS_DOT_SIZES = [(497664, 4, 2), (508464, 1, 2), (98304, 1, 1), (744, 1, 2),
                 (4000001, 2, 2), (3 * 2048 + 17, 31, 3)]


@pytest.mark.parametrize("n,rows,mb", CGS_DOT_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gmres_cgs_dot_equals_the_ordered_plain_bitwise(n, rows, mb, dtype):
    """gmres_cgs_dot (one launch: the partials, then the last block of each
    row and system sums them) writes out[:, :rows] to the last bit of
    gmres_cgs_dot_ordered_plain's (the earlier partial and finish kernels'
    order) in each of 100 calls on one work (out NaN before every call),
    leaves out beyond the rows alone, and ends with every ticket at 0."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(35)
    wk = ko.gmres_work(mb, n, max(rows, 4), dtype, dev)
    V = _rand(rng, (rows, mb, n), dtype, dev)
    w = _rand(rng, (mb, n), dtype, dev)
    want = ko.gmres_cgs_dot_ordered_plain(V, w, rows, torch.zeros((mb, rows), dtype=dtype,
                                                                  device=dev))
    out = torch.empty((mb, rows + 2), dtype=dtype, device=dev)
    n0 = _cuda.LAUNCHES["gmres_cgs_dot"]
    diff = torch.zeros(100, dtype=torch.int64, device=dev)
    for i in range(100):
        out.fill_(float("nan"))
        ko.gmres_cgs_dot(V, w, rows, out, wk)
        diff[i] = (_bits(out[:, :rows]) != _bits(want)).sum()
    assert int(diff.max()) == 0
    assert bool(out[:, rows:].isnan().all())
    assert _cuda.LAUNCHES["gmres_cgs_dot"] == n0 + 100
    assert not wk.ticket.any()


def test_gmres_cgs_dot_is_one_launch_and_replays():
    """The solver's tolerance dot (one row, the cell layout's KNP batch) is
    one gm_dot_kernel launch a call and no allocation; captured in a CUDA
    graph it replays to the eager bits."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(36)
    wk = ko.gmres_work(2, 497664, 30, torch.float64, dev)
    bz = _rand(rng, (2, 497664), torch.float64, dev)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]

    def dots():
        for _ in range(5):
            ko.gmres_cgs_dot(bz[None], bz, 1, wk.h1, wk)

    kernels = _device_kernels(dots, sessions=3, want=5, match="gm_dot")
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs
    assert len(kernels) == 5 and all("gm_dot_kernel" in k for k in kernels), kernels
    eager = wk.h1.clone()
    wk.h1.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ko.gmres_cgs_dot(bz[None], bz, 1, wk.h1, wk)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(wk.h1, eager) and not wk.ticket.any()


def _dominant_system(rng, nc=3000, K=5, m=2):
    nbr = np.vstack([np.arange(nc), rng.integers(0, nc, size=(K - 1, nc))]).astype(np.int32)
    B = rng.normal(size=(m, K, 4, 4, nc)) * 0.05
    B[:, 0, range(4), range(4), :] += 3.0
    B[0, 0] *= 30.0                                  # system 0 converges first
    return B, nbr


def test_krylov_solvers_on_cuda_match_cpu():
    """The batched GMRES (uneven convergence: one system frozen while the
    other steps) and a nullspace-projected PCG through the kernels on the
    card: the CPU's iteration counts and solutions; the float32 counts
    repeat from call to call."""
    dev = cuda_or_skip()
    rng = np.random.default_rng(13)
    B, nbr = _dominant_system(rng)
    b = rng.normal(size=(2, 4, B.shape[-1]))
    out = {}
    for d in ("cpu", dev):
        Bt = torch.as_tensor(B, device=d)
        nt = torch.as_tensor(nbr, device=d)
        bt = torch.as_tensor(b, device=d)
        out[str(d)] = krylov.gmres_batched(
            lambda V: spmv.bell_matvec_multi(Bt, nt, V.contiguous()), bt,
            torch.zeros_like(bt), lambda r: r, rtol=1e-9, atol=0.0, max_it=300, restart=12)
    rc, rg = out["cpu"], out[str(dev)]
    assert rg.converged and rg.iters == rc.iters and rg.iters[0] < rg.iters[1]
    assert rel(rg.x, rc.x) < 1e-10
    # SPD: the symmetric part of system 1's diagonal blocks, constant projection
    P = B[1, 0] + np.swapaxes(B[1, 0], 0, 1)
    rhs = rng.normal(size=(4, B.shape[-1]))
    res = {}
    for d in ("cpu", dev):
        Pt = torch.as_tensor(P, device=d)
        mv = lambda v: torch.einsum("ijc,jc->ic", Pt, v)
        res[str(d)] = krylov.pcg(mv, torch.as_tensor(rhs, device=d),
                                 torch.zeros(4, P.shape[-1], dtype=torch.float64, device=d),
                                 lambda r: r / 6.0, rtol=1e-10, atol=0.0, max_it=200,
                                 project_nullspace=True)
    assert res[str(dev)].iters == res["cpu"].iters and res[str(dev)].converged
    assert rel(res[str(dev)].x, res["cpu"].x) < 1e-10
    counts = []
    for _ in range(2):
        Bt = torch.as_tensor(B, dtype=torch.float32, device=dev)
        nt = torch.as_tensor(nbr, device=dev)
        bt = torch.as_tensor(b, dtype=torch.float32, device=dev)
        counts.append(krylov.gmres_batched(
            lambda V: spmv.bell_matvec_multi(Bt, nt, V.contiguous()), bt,
            torch.zeros_like(bt), lambda r: r, rtol=1e-6, atol=0.0, max_it=300,
            restart=12).iters)
    assert counts[0] == counts[1]


def test_krylov_wrappers_raise_on_what_they_cannot_take():
    """Mixed devices, non-contiguous or mistyped tensors, a restart beyond
    the kernel's rows, more than 32 systems, and the GMRES variants the
    port does not carry."""
    from knpemidg_tpu_torch.config import SolverParams
    from knpemidg_tpu_torch.solver import _check_supported

    dev = cuda_or_skip()
    rng = np.random.default_rng(14)
    wk, w = _gmres_case(rng, torch.float64, dev, 2)
    with pytest.raises(ValueError):                      # w on the CPU
        ko.gmres_cgs_dot(wk.V, w.cpu(), 3, wk.h1, wk)
    with pytest.raises(ValueError):                      # not contiguous
        ko.gmres_arnoldi(w.t().contiguous().t(), wk, 2)
    with pytest.raises(TypeError):                       # dtype mismatch
        ko.gmres_arnoldi(w.float(), wk, 2)
    with pytest.raises(ValueError):                      # rows beyond the basis
        ko.gmres_cgs_dot(wk.V, w, wk.V.shape[0] + 1, wk.h1, wk)
    with pytest.raises(NotImplementedError):             # restart beyond the kernel's rows
        ko.gmres_work(2, 10, ko.MAX_RESTART + 1, torch.float64, dev)
    with pytest.raises(NotImplementedError):             # more than 32 systems
        ko.gmres_work(ko.MAX_SYSTEMS + 1, 10, 8, torch.float64, dev)
    pw = ko.pcg_work(torch.zeros(6, dtype=torch.float64, device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev), None, 1, w.numel())
    with pytest.raises(TypeError):
        ko.pcg_dot(w, w.float(), pw)
    with pytest.raises(ValueError):
        ko.pcg_dot2_direction(w, w, w.t().contiguous().t(), pw)
    for over in ({"gmres_orth": "cgs1"}, {"gmres_rot": "carry"}, {"knp_solver": "cg"}):
        with pytest.raises(NotImplementedError):
            _check_supported(SolverParams(**tp.solver_params_kw(**over)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_probe_kernels_match_plain(dtype):
    """P1 and P2 at the probe's shapes equal the plain gathers exactly."""
    dev = cuda_or_skip()
    idx1, xsrc, idx2, xs2 = probes.make_inputs(0, dtype, dev)
    n0 = dict(_cuda.LAUNCHES)
    assert torch.equal(probes.pgather(idx1, xsrc), probes.pgather_plain(idx1, xsrc))
    assert torch.equal(probes.pgather2(idx2, xs2), probes.pgather2_plain(idx2, xs2))
    for k in ("pgather", "pgather2"):
        assert _cuda.LAUNCHES[k] == n0[k] + 1
    with pytest.raises(ValueError):
        probes.pgather2(idx2[:, :10].contiguous(), xs2)


def test_rush_larsen_window_on_cuda_matches_cpu():
    """Two float64 steps of the EMIx fixture with ode_scheme="rush_larsen":
    one K13 launch a step, the neuron's points through its Rush-Larsen
    branch and the glial ones through its RK4 branch (counted as
    membrane_rl), and the counts and fields are the CPU run's."""
    import dataclasses

    dev = cuda_or_skip()
    runs = {}
    for d in ("cpu", dev):
        S, sp = tp.emix_torch(device=d)
        S.params = dataclasses.replace(S.params, ode_scheme="rush_larsen")
        _cuda.reset_launches()
        runs[str(d)] = (S, S.solve_system_active(0.2, 0.0, sp))
    assert _cuda.LAUNCHES["membrane_rl"] == 2 and _cuda.LAUNCHES["membrane_rk4"] == 0
    (Sc, sc), (Sg, sg) = runs["cpu"], runs[str(dev)]
    assert Sg.stats.emi_niters == Sc.stats.emi_niters
    assert Sg.stats.knp_niters == Sc.stats.knp_niters
    for key in ("phi", "c", "c_elim", "phi_M"):
        assert rel(sg[key], sc[key]) < 1e-8, key


# ---------------------------------------------------------------------------
# K15: the batched BiCGStab entries
# ---------------------------------------------------------------------------

def _bicg_inputs(dev, dtype, mb, n, seed=7):
    """A start's inputs shaped as a solve makes them (bz correlated with r0;
    systems beyond the first frozen by their tolerance), a v and a t."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rnd = lambda: torch.randn((mb, n), generator=gen, device=dev, dtype=dtype)
    r0 = rnd()
    bz = 3.0 * r0 + 0.1 * rnd()
    bz[1:] *= 1e8
    return r0, bz, r0 + 0.3 * rnd(), rnd(), rnd()


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("mb,n", [(2, 497_664), (2, 508_464), (1, 1_001), (32, 2_049)])
def test_bicgstab_entries_match_plain(dtype, tol, mb, n):
    """bicgstab_start, _alpha and _omega (one launch each), each from the
    same work as its plain versions, equal the kernel-ordered plain versions
    bit for bit and the einsum plain versions to ``tol`` of each vector's
    largest value and of each scalar (chip_smoke.bicg_scales), at the main
    path's KNP batches (cells, pairs), one system and 32 systems of odd
    lengths; the systems beyond the first frozen by their tolerance."""
    import chip_smoke

    dev = cuda_or_skip()
    r0, bz, v, x, noise = _bicg_inputs(dev, dtype, mb, n)
    base = ko.bicgstab_work(mb, n, dtype, dev)
    ko.bicgstab_start_plain(r0, bz, base, 1e-7, 2e-40, ordered=True)
    mid = ko.bicgstab_alpha_plain(v, chip_smoke.bicg_copy(base), ordered=True)
    t = 0.9 * mid.s + 0.2 * noise
    calls = {"bicgstab_start": (base, lambda f, wk, xs, **kw: f(r0, bz, wk, 1e-7, 2e-40, **kw)),
             "bicgstab_alpha": (base, lambda f, wk, xs, **kw: f(v, wk, **kw)),
             "bicgstab_omega": (mid, lambda f, wk, xs, **kw: f(t, xs, wk, **kw))}
    for entry, (wk0, call) in calls.items():
        def run(f, **kw):
            wk, xs = chip_smoke.bicg_copy(wk0), x.clone()
            call(f, wk, xs, **kw)
            return [o.clone() for o in chip_smoke.bicg_out(entry, wk, xs)]

        n0 = _cuda.LAUNCHES[entry]
        got = run(getattr(ko, entry))
        assert _cuda.LAUNCHES[entry] == n0 + 1, entry
        plain = getattr(ko, entry + "_plain")
        for a, b in zip(got, run(plain, ordered=True)):
            assert torch.equal(a, b), entry
        ref = run(plain)
        rhat = r0 if entry == "bicgstab_start" else wk0.rhat
        for a, b, sc in zip(got, ref, chip_smoke.bicg_scales(ref, rhat)):
            assert bool(((a.double() - b.double()).abs() <= tol * sc).all()), entry
    assert int(base.live[0]) == 1 and int(base.live[1:].sum()) == 0


def test_bicgstab_kernels_raise_on_what_they_cannot_take():
    """K15 refuses more than MAX_SYSTEMS systems and other dtypes at
    bicgstab_work, vectors off the card, of another dtype or shape, not
    contiguous, and a work built by hand; it never runs the plain version
    on CUDA tensors."""
    dev = cuda_or_skip()
    with pytest.raises(NotImplementedError):
        ko.bicgstab_work(ko.MAX_SYSTEMS + 1, 100, torch.float64, dev)
    with pytest.raises(NotImplementedError):
        ko.bicgstab_work(2, 100, torch.float16, dev)
    wk = ko.bicgstab_work(2, 100, torch.float64, dev)
    r0, bz, v, _, _ = _bicg_inputs(dev, torch.float64, 2, 100)
    with pytest.raises(ValueError):
        ko.bicgstab_start(r0, bz.cpu(), wk, 1e-7, 0.0)
    with pytest.raises(TypeError):
        ko.bicgstab_alpha(v.float(), wk)
    with pytest.raises(ValueError):
        ko.bicgstab_alpha(v[:, :50].contiguous(), wk)
    with pytest.raises(ValueError):
        ko.bicgstab_alpha(v.t().contiguous().t(), wk)
    with pytest.raises(ValueError):
        ko.bicgstab_alpha(v, wk._replace(grid=0))


@pytest.mark.parametrize("pair", [False, True])
def test_bicgstab_slice_on_cuda_matches_cpu(pair, monkeypatch):
    """Two float64 steps of the EMIx fixture with knp_solver="bicgstab" on
    the card against the CPU: K15 launched (one start a solve, one alpha
    and one omega an iteration) and K9 not; on the cell layout equal
    Krylov counts and fields to rel 1e-8.  The same two steps on the card
    with K15's kernel-ordered plain twins in its place give the K15 run's
    counts and fields bit for bit, so K15 acts on the path as its twin
    does.  On the pair layout the KNP solve converges slowly and rounding
    moves its exit (the card's second step takes [7, 7] iterations, the
    CPU's [7, 8]; on the CPU the summation order of the dots alone moves
    that solve's residuals by more than 10%, see
    test_torch_bicgstab_pair.py): equal EMI counts, KNP counts within one
    iteration a solve, phi and phi_M to rel 1e-7, c and c_elim to 1e-6
    (measured on an H100: 2.4e-8 / 1.7e-8 and 1.5e-7 / 1.6e-7)."""
    dev = cuda_or_skip()
    runs = {}
    for d in ("cpu", "cuda", "twins"):
        if d == "twins":
            for e in ("bicgstab_start", "bicgstab_alpha", "bicgstab_omega"):
                monkeypatch.setattr(ko, e, functools.partial(getattr(ko, e + "_plain"),
                                                             ordered=True))
        S, sp = tp.emix_torch(device="cpu" if d == "cpu" else dev, pair=pair,
                              knp_solver="bicgstab")
        _cuda.reset_launches()
        st = S.solve_system_active(0.2, 0.0, sp)
        runs[d] = (S, unpad_state(S, st), dict(_cuda.LAUNCHES))
    (Sc, sc, _), (Sg, sg, launches), (St, stw, _) = runs["cpu"], runs["cuda"], runs["twins"]
    assert St.stats.knp_niters == Sg.stats.knp_niters
    assert St.stats.emi_niters == Sg.stats.emi_niters
    assert all(torch.equal(stw[key], sg[key]) for key in ("phi", "c", "c_elim", "phi_M"))
    gaps = {key: rel(sg[key].cpu(), sc[key]) for key in ("phi", "c", "c_elim", "phi_M")}
    print(f"pair {pair}: card KNP {Sg.stats.knp_niters}, CPU {Sc.stats.knp_niters}, gaps {gaps}")
    assert Sg.stats.emi_niters == Sc.stats.emi_niters
    if pair:
        assert all(abs(a - b) <= 1 for ga, ca in zip(Sg.stats.knp_niters, Sc.stats.knp_niters)
                   for a, b in zip(ga, ca))
    else:
        assert Sg.stats.knp_niters == Sc.stats.knp_niters
    for key, gap in gaps.items():
        assert gap < ((1e-6 if key.startswith("c") else 1e-7) if pair else 1e-8), key
    assert launches["bicgstab_start"] == 2
    assert launches["bicgstab_alpha"] == launches["bicgstab_omega"] == sum(
        max(k) for k in Sg.stats.knp_niters)
    assert not any(v for k, v in launches.items() if k.startswith("gmres_"))


def test_bicgstab_pair_slice_with_plain_pair_kernels(monkeypatch):
    """The diagnostic of the pair slice's BiCGStab exit (the card takes KNP
    [7, 7] in step 2, the CPU [7, 8]): the same two float64 steps on the
    card with K3 (pair_matvec, pair_matvec_multi), K5's apply and K7 (the
    batched coarse apply) replaced by their plain twins on the card's
    tensors, so that the pair applies round as the CPU's plain path does
    while the rest of the step stays on the kernels.  Prints the KNP counts
    beside the CPU's and the K15 run's and the fields' gaps (run with -s);
    asserts that no K3, K5 apply or K7 kernel ran, that every solve
    converged (solve_system_active raises otherwise) with the CPU's EMI
    counts, and the fields within 1e-5 of the CPU's: the spread of
    converged solutions at rtol_knp 1e-7 (chip_smoke.BICG_GAP, the
    BiCGStab window's allowed gap to the GMRES one)."""
    from knpemidg_tpu_torch import solver as tsolver

    dev = cuda_or_skip()
    Sc, sp = tp.emix_torch(pair=True, knp_solver="bicgstab")
    sc = unpad_state(Sc, Sc.solve_system_active(0.2, 0.0, sp))
    Sk, _ = tp.emix_torch(device=dev, pair=True, knp_solver="bicgstab")
    Sk.solve_system_active(0.2, 0.0, sp)

    def bj_plain(op, r, out=None):
        op = op if isinstance(op, spmv.BjOperands) else spmv.block_jacobi_operands(op)
        z = spmv.block_jacobi_apply_plain(op.Pinv, r, op.halves)
        return z if out is None else out.copy_(z)

    coarse_add = coarse.coarse_add

    def k7_plain(co, out, r, mask=None, bj=None):
        if not co.batched:
            return coarse_add(co, out, r, mask, bj)
        if bj is not None:
            bj_plain(bj, r, out)
        return coarse.coarse_apply_plain(co, out, r, mask)

    monkeypatch.setattr(tsolver, "pair_matvec", pairs.pair_matvec_plain)
    monkeypatch.setattr(tsolver, "pair_matvec_multi", pairs.pair_matvec_multi_plain)
    monkeypatch.setattr(tsolver, "block_jacobi_apply", bj_plain)
    monkeypatch.setattr(coarse, "block_jacobi_apply", bj_plain)
    monkeypatch.setattr(coarse, "coarse_add", k7_plain)
    Sg, _ = tp.emix_torch(device=dev, pair=True, knp_solver="bicgstab")
    _cuda.reset_launches()
    sg = unpad_state(Sg, Sg.solve_system_active(0.2, 0.0, sp))
    launches = dict(_cuda.LAUNCHES)
    gaps = {key: rel(sg[key].cpu(), sc[key]) for key in ("phi", "c", "c_elim", "phi_M")}
    print(f"pair BiCGStab KNP counts: card with plain K3, K5, K7 {Sg.stats.knp_niters}, "
          f"card with the kernels {Sk.stats.knp_niters}, CPU {Sc.stats.knp_niters}; "
          f"gaps to the CPU {gaps}")
    assert not any(launches[k] for k in ("pair_matvec", "block_jacobi_apply_nd8",
                                         "two_level_coarse_batched"))
    assert Sg.stats.emi_niters == Sc.stats.emi_niters
    assert max(gaps.values()) < 1e-5, gaps


def test_bicgstab_pair_step2_solve_on_swapped_inputs(monkeypatch):
    """The split diagnostic of the pair slice's BiCGStab exit (the card
    takes KNP [7, 7] in step 2, the CPU [7, 8]): the same two float64 steps
    on the CPU and on the card with each run's KNP solves recorded (the
    pair operator, rhs and c handed to Solver._knp_solve_all_pair, its
    frozen preconditioner, the counts and the new c).  Then each step's
    card solve runs on the CPU's operator, rhs and c copied to the card,
    and the step-2 CPU solve on the card's copied to the CPU, each with
    its own solver's preconditioner.  Prints the inputs' gaps, the counts
    and the solutions' gaps (run with -s).  Asserts that each run's solve,
    run again on its own recorded inputs, repeats its counts (so the
    recorded inputs are what the solve saw), and that the swapped step-2
    solves stay within one iteration of the CPU's counts and their new c
    within 1e-6 of the CPU's.  Measured on an H100: step 1's inputs agree
    to rounding (rhs 3.1e-15, c equal) and both runs take [7, 10], yet the
    card's solve on the CPU's step-1 inputs takes [7, 7], and the two
    runs' new c differ by 1.4e-7, which step 2's rhs and c carry; in step
    2 the card's solve on the CPU's inputs and the CPU's on the card's
    both take [7, 8].  The exit moves with rounding-level changes of the
    solve's inputs: rounding sets it, not one side's operation."""
    from knpemidg_tpu_torch import solver as tsolver

    dev = cuda_or_skip()
    solve = tsolver.Solver._knp_solve_all_pair
    rec = {}

    def spy(self, blocksK, rhsK, c, sp_, pcK, step=False):
        res = solve(self, blocksK, rhsK, c, sp_, pcK, step)
        rec.setdefault(id(self), []).append(
            (tuple(t.clone() for t in blocksK), rhsK.clone(), c.clone(), sp_, pcK, res[1],
             res[0].clone()))
        return res

    monkeypatch.setattr(tsolver.Solver, "_knp_solve_all_pair", spy)
    runs = {}
    for d in ("cpu", "cuda"):
        S, sp = tp.emix_torch(device="cpu" if d == "cpu" else dev, pair=True,
                              knp_solver="bicgstab")
        S.solve_system_active(0.2, 0.0, sp)
        runs[d] = (S, rec[id(S)])
    (Sc, rc), (Sg, rg) = runs["cpu"], runs["cuda"]
    assert len(rc) == len(rg) == 2
    gap = lambda a, b: rel(a.cpu(), b.cpu())
    report, swapped = [], None
    for step in (0, 1):
        (bc, rhc, cc, spc, pcc, itc, xc), (bg, rhg, cg, spg, pcg_, itg, xg) = rc[step], rg[step]
        assert solve(Sg, bg, rhg, cg, spg, pcg_)[1] == itg
        assert solve(Sc, bc, rhc, cc, spc, pcc)[1] == itc
        card_on_cpu = solve(Sg, tuple(t.to(dev) for t in bc), rhc.to(dev), cc.to(dev), spg,
                            pcg_)
        report.append(
            f"step {step + 1}: counts card {itg}, CPU {itc}, card's solve on the CPU's inputs "
            f"{card_on_cpu[1]}; input gaps card / CPU pd {gap(bg[0], bc[0]):.1e} pe "
            f"{gap(bg[1], bc[1]):.1e} rhs {gap(rhg, rhc):.1e} c {gap(cg, cc):.1e}; new c "
            f"card / CPU {gap(xg, xc):.1e}, card's solve on the CPU's inputs / CPU "
            f"{gap(card_on_cpu[0], xc):.1e}")
        if step == 1:
            cpu_on_card = solve(Sc, tuple(t.cpu() for t in bg), rhg.cpu(), cg.cpu(), spc, pcc)
            report.append(f"step 2: the CPU's solve on the card's inputs {cpu_on_card[1]}, new "
                          f"c / the card's {gap(cpu_on_card[0], xg):.1e}")
            swapped = (card_on_cpu, cpu_on_card, itc, xc)
    print("pair BiCGStab split: " + "; ".join(report))
    card_on_cpu, cpu_on_card, itc, xc = swapped
    for res in (card_on_cpu, cpu_on_card):
        assert all(abs(a - b) <= 1 for a, b in zip(res[1], itc)), res[1]
        assert gap(res[0], xc) < 1e-6


def test_emi_only_slice_on_cuda_matches_cpu():
    """Three float64 steps of the EMI-only solver on the 2D neuron
    (chip_smoke.emi_2d_solver) on the card against the CPU: equal EMI
    counts, phi_M to rel 1e-10, c unchanged, no KNP kernel launched."""
    import chip_smoke
    from knpemidg_tpu_torch.config import SolverParams

    cuda_or_skip()
    sp = SolverParams(direct_emi=False, direct_knp=False, rtol_emi=1e-5, atol_emi=1e-40)
    out = {}
    for d in ("cpu", "cuda"):
        S = chip_smoke.emi_2d_solver(device=d)
        _cuda.reset_launches()
        st = S.solve_system_active(3e-4, 0.0, sp)
        out[d] = (S, st, dict(_cuda.LAUNCHES))
    (Sc, sc, _), (Sg, sg, launches) = out["cpu"], out["cuda"]
    assert Sg.stats.emi_niters == Sc.stats.emi_niters
    assert rel(sg["phi_M"].cpu(), sc["phi_M"]) < 1e-10
    assert torch.equal(sg["c"], Sg.c_init)
    assert not any(launches[k] for k in ("knp_cell", "knp_facet", "knp_membrane_emit",
                                         "alpha_sum", "gmres_start", "bicgstab_start"))
    assert launches["pcg_dot"] > 0
