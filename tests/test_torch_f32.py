"""The port's float32 EMI solve against the JAX package's float32 solve.

Float32 Krylov counts of the two packages differ (the f64 ones are equal),
so these tests hold the port's float32 arithmetic against JAX's on the same
inputs: the EMI operator, rhs and frozen preconditioner of the first EMIx
step, assembled and built by the JAX package in float32 and handed to both
packages as numpy arrays.  The float64 solve of the same float32 data is the
yardstick: a float32-only fault of the port would show as a history or a
solution much further from it than JAX's.

Run as a script, the file prints these readings (assembly, apply and
matvec errors, the residual histories of the first EMI solve) and the
float32 Krylov counts of both packages over the 10-step window, at any
box_3d_axons size (CPU; the 124,416-tet size takes a full-size JAX run):

    JAX_PLATFORMS=cpu python tests/test_torch_f32.py --resolution 0 --length 2
"""
import argparse
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_parity as tp  # noqa: E402
from test_torch_parity import rel  # noqa: E402

F32 = torch.float32
F64 = torch.float64


def _meshes(resolution, length):
    from knpemidg_tpu.mesh.generators import box_3d_axons as jbox
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons as tbox

    mj, mt = jbox(resolution, length_factor=length), tbox(resolution, length_factor=length)
    mj.vertices *= 1e2
    mt.vertices *= 1e2
    return mj, mt


def _solvers(resolution=0, length=1, dtype=F32):
    """(JAX solver, JAX params, port solver, port params) of the EMIx setup;
    unconverged solves are reported, not raised."""
    import jax.numpy as jnp
    from run_EMIx_simulation import build_solver
    from knpemidg_tpu.config import SolverParams
    from knpemidg_tpu_torch import emix

    mj, mt = _meshes(resolution, length)
    Sj = build_solver(mesh=mj, dtype=jnp.float32 if dtype == F32 else jnp.float64)
    spj = SolverParams(**tp.solver_params_kw(), error_if_not_converged=False)
    St = emix.build_solver(mt, dtype=dtype, device="cpu")
    return Sj, spj, St, emix.solver_params(emi_ritz=0, error_if_not_converged=False)


def first_emi_system(Sj, spj):
    """The EMI system of the first step as the JAX package sets it up in
    float32 (after the first ODE step): numpy arrays of the blocks, rhs,
    P_diag, phi and the frozen EMI preconditioner data."""
    sj = Sj._ode_step(Sj.attach_pc(Sj._initial_state(0.0), spj), first_step=True)
    pM, _, It = Sj._pads(sj)
    blocks, rhs, Pd = Sj._assemble_emi(sj["c"], sj["c_elim"], pM, It, sj["t"])
    return {"blocks": np.asarray(blocks), "rhs": np.asarray(rhs), "Pd": np.asarray(Pd),
            "phi": np.asarray(sj["phi"]),
            "pc": {k: np.asarray(v) for k, v in sj["pc"]["emi"].items()}}


def jax_pcg(Sj, spj, data, max_it):
    """The JAX package's increment-form EMI PCG on ``data`` (float32)."""
    import jax.numpy as jnp
    from knpemidg_tpu.solvers import krylov

    blocks, rhs, Pd = (jnp.asarray(data[k]) for k in ("blocks", "rhs", "Pd"))
    pc = {k: jnp.asarray(v) for k, v in data["pc"].items()}
    mv = lambda v: Sj._matvec(blocks, v)
    r0 = rhs - mv(jnp.asarray(data["phi"]))
    res = krylov.pcg(mv, r0, jnp.zeros_like(r0),
                     Sj._make_precond(blocks, Pd, spj, sym=True, pc=pc),
                     rtol=spj.rtol_emi, atol=spj.atol_emi, max_it=max_it,
                     project_nullspace=True, b_ref=rhs)
    return int(res.iters), float(res.resnorm), np.asarray(res.x, dtype=np.float64)


def port_pcg(St, spt, data, dtype, max_it):
    """The port's increment-form EMI PCG on ``data`` cast to ``dtype``."""
    from knpemidg_tpu_torch.solvers import krylov

    dev = lambda v: torch.as_tensor(np.array(v), dtype=dtype)
    blocks, rhs, Pd = (dev(data[k]) for k in ("blocks", "rhs", "Pd"))
    pc = {k: dev(v) for k, v in data["pc"].items()}
    mv = lambda v: St._matvec(blocks, v)
    r0 = rhs - mv(dev(data["phi"]))
    res = krylov.pcg(mv, r0, torch.zeros_like(r0),
                     St._make_precond(blocks, Pd, spt, pc=pc),
                     rtol=spt.rtol_emi, atol=spt.atol_emi, max_it=max_it,
                     project_nullspace=True, b_ref=rhs)
    return res.iters, float(res.resnorm), res.x.double().numpy()


def histories(Sj, spj, St, spt, data):
    """Preconditioned residual norm ||M^-1 r_k|| after k = 0, 1, ...
    iterations (one capped solve per k) until every solve has converged:
    {"jax": [...], "port": [...], "f64": [...]} and the converged
    (iters, x) of each."""
    runs = {"jax": lambda k: jax_pcg(Sj, spj, data, k),
            "port": lambda k: port_pcg(St, spt, data, F32, k),
            "f64": lambda k: port_pcg(St, spt, data, F64, k)}
    hist = {name: [] for name in runs}
    done = {}
    k = 0
    while len(done) < len(runs) and k <= spt.max_it_emi:
        for name, run in runs.items():
            it, rn, x = run(k)
            hist[name].append(rn)
            if it < k and name not in done:
                done[name] = (it, x)
        k += 1
    return hist, done


@pytest.fixture(scope="module")
def f32_solvers():
    return _solvers()


@pytest.fixture(scope="module")
def f32_first_emi(f32_solvers):
    Sj, spj, St, spt = f32_solvers
    data = first_emi_system(Sj, spj)
    return data, histories(Sj, spj, St, spt, data)


def test_f32_emi_pcg_tracks_jax_on_same_inputs(f32_first_emi):
    """Same float32 operator, rhs and preconditioner in both packages: the
    iteration counts agree to within 2, the first preconditioned residual
    (one float32 preconditioner apply) of each is within 1e-4 of the
    float64 one, and the port's history and solution
    are no further from the float64 solve of the same data than JAX's own
    float32 ones.  Both float32 histories leave the float64 one from the
    first iteration on, so float32 counts are compared, never required
    equal."""
    _, (hist, done) = f32_first_emi
    assert set(done) == {"jax", "port", "f64"}
    it = {name: done[name][0] for name in done}
    assert abs(it["port"] - it["jax"]) <= 2, it
    assert abs(it["port"] - it["f64"]) <= 2, it
    for name in ("jax", "port"):
        assert abs(hist[name][0] / hist["f64"][0] - 1.0) < 1e-4, hist
    n = min(it.values()) + 1

    def spread(name):          # largest |log| ratio to the float64 history
        return max(abs(math.log(hist[name][k] / hist["f64"][k])) for k in range(1, n))

    assert spread("jax") > math.log(1.1), hist
    assert spread("port") < 2.0 * spread("jax"), hist
    x64 = done["f64"][1]
    assert rel(done["jax"][1], x64) < 1e-2
    assert rel(done["port"][1], x64) < 1e-2


def _port_f(St, spt, data, dtype):
    """The port's EMI matvec and preconditioner apply on ``data`` in
    ``dtype``, as numpy float64 -> numpy float64 maps."""
    dev = lambda v: torch.as_tensor(np.array(v), dtype=dtype)
    blocks = dev(data["blocks"])
    pc = {k: dev(v) for k, v in data["pc"].items()}
    apply = St._make_precond(blocks, dev(data["Pd"]), spt, pc=pc)
    return (lambda x: St._matvec(blocks, dev(x)).double().numpy(),
            lambda r: apply(dev(r)).double().numpy())


def _jax_f(Sj, spj, data):
    import jax.numpy as jnp

    blocks = jnp.asarray(data["blocks"])
    pc = {k: jnp.asarray(v) for k, v in data["pc"].items()}
    apply = Sj._make_precond(blocks, jnp.asarray(data["Pd"]), spj, sym=True, pc=pc)
    f32 = lambda v: jnp.asarray(v, dtype=jnp.float32)
    return (lambda x: np.asarray(Sj._matvec(blocks, f32(x)), dtype=np.float64),
            lambda r: np.asarray(apply(f32(r)), dtype=np.float64))


def component_errors(Sj, spj, St, spt, data, vector):
    """Relative float32 errors of one preconditioner apply (constant mode
    removed) and of one EMI matvec of the float64 result, against the
    port's float64 apply of the same float32 data: ({"jax", "port"} for the
    apply, the same for the matvec).  ``vector``: "residual" (the first
    step's r0) or "random"."""
    mv64, pc64 = _port_f(St, spt, data, F64)
    mv32, pc32 = _port_f(St, spt, data, F32)
    mvj, pcj = _jax_f(Sj, spj, data)
    r = data["rhs"] - mv64(data["phi"])
    r = r - r.mean()
    if vector == "random":
        r = np.random.default_rng(7).standard_normal(r.shape) * np.abs(r).max()
    r = r.astype(np.float32)
    mean_free = lambda v: v - v.mean()
    z64 = pc64(r)
    err_pc = {name: rel(mean_free(f(r)), mean_free(z64)) for name, f in
              (("jax", pcj), ("port", pc32))}
    z = z64.astype(np.float32)
    Az64 = mv64(z)
    err_mv = {"jax": rel(mvj(z), Az64), "port": rel(mv32(z), Az64)}
    return err_pc, err_mv


def assembly_errors(Sj, spj, St, mesh_torch):
    """Relative errors of the float32 EMI blocks, rhs and P_diag of both
    packages against the port's float64 assembly (itself equal to the JAX
    package's to 1e-12), all from the JAX package's float32 state after the
    first ODE step: {name: {"jax": e, "port": e}}."""
    import knpemidg_tpu_torch as kt
    from knpemidg_tpu_torch import emix

    sj = Sj._ode_step(Sj.attach_pc(Sj._initial_state(0.0), spj), first_step=True)
    pM, _, It = Sj._pads(sj)
    out = {"jax": Sj._assemble_emi(sj["c"], sj["c_elim"], pM, It, sj["t"])}
    st_np = kt.state_to_numpy(sj)
    st_np.pop("pc")
    S64 = emix.build_solver(mesh_torch, dtype=F64, device="cpu")
    for name, S in (("port", St), ("f64", S64)):
        models = {tag: mm.model for tag, mm in S.mem_models.items()}
        st = kt.state_from_numpy(st_np, "cpu", S.dtype, models=models)
        pM, _, It = S._pads(st)
        out[name] = S._assemble_emi(st["c"], st["c_elim"], pM, It, st["t"])
    assert out["port"][0].dtype == F32
    return {part: {pkg: rel(out[pkg][i], out["f64"][i]) for pkg in ("jax", "port")}
            for i, part in enumerate(("blocks", "rhs", "P_diag"))}


@pytest.mark.parametrize("vector", ["residual", "random"])
def test_f32_emi_operator_and_precond_errors_match_jax(f32_solvers, f32_first_emi, vector):
    """Float32 error of one EMI matvec and one preconditioner apply against
    the float64 apply of the same float32 data, port against JAX, on the
    first step's initial residual r0 and on a random vector: the port's
    errors stay within 1.5x (matvec) and 4x (apply, constant mode removed)
    of JAX's.  The matvec of the preconditioned residual z0 = M^-1 r0 loses
    over 1e-2 in float32 in JAX as in the port: 90% of z0's norm is a
    constant mode, which the operator maps to rounding noise, so float32
    PCG histories leave the float64 one from the first step."""
    Sj, spj, St, spt = f32_solvers
    data, _ = f32_first_emi
    err_pc, err_mv = component_errors(Sj, spj, St, spt, data, vector)
    assert err_pc["port"] < 4.0 * err_pc["jax"], err_pc
    assert err_mv["port"] < 1.5 * err_mv["jax"], err_mv
    if vector == "residual":
        assert err_mv["jax"] > 1e-2, err_mv


def test_f32_emi_assembly_matches_f64(f32_solvers):
    """From the same carried state, the port's float32 EMI blocks, rhs and
    P_diag agree with the float64 assembly to 1e-6."""
    Sj, spj, St, _ = f32_solvers
    errs = assembly_errors(Sj, spj, St, _meshes(0, 1)[1])
    for name, e in errs.items():
        assert e["port"] < 1e-6, (name, errs)


def _main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--resolution", type=int, default=0)
    ap.add_argument("--length", type=int, default=1)
    args = ap.parse_args()
    Sj, spj, St, spt = _solvers(args.resolution, args.length)
    print(f"box_3d_axons({args.resolution}, length_factor={args.length}): "
          f"{St.n_cells} cells, float32")
    errs = assembly_errors(Sj, spj, St, _meshes(args.resolution, args.length)[1])
    for name, e in errs.items():
        print(f"float32 EMI {name:7s} rel to f64: jax {e['jax']:.3e}  port {e['port']:.3e}")
    data = first_emi_system(Sj, spj)
    for vector in ("residual", "random"):
        err_pc, err_mv = component_errors(Sj, spj, St, spt, data, vector)
        print(f"float32 on the {vector:8s} vector, rel to f64: pc apply (mean-free) "
              f"jax {err_pc['jax']:.3e} port {err_pc['port']:.3e}; matvec of M^-1 r "
              f"jax {err_mv['jax']:.3e} port {err_mv['port']:.3e}")
    hist, done = histories(Sj, spj, St, spt, data)
    for name in hist:
        it, x = done.get(name, (None, None))
        err = "" if x is None else f", solution rel to f64 {rel(x, done['f64'][1]):.3e}"
        print(f"first EMI solve, {name:4s}: {it} iterations{err}")
        print("  ||M^-1 r_k||:", " ".join(f"{v:.4e}" for v in hist[name]))
    for label, S, sp in (("jax", Sj, spj), ("port", St, spt)):
        S.solve_system_active(1.0, 0.0, sp)           # the 10-step window
        print(f"{label:4s} window EMI {S.stats.emi_niters}")
        print(f"{label:4s} window KNP {[np.asarray(v).tolist() for v in S.stats.knp_niters]}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")      # as tests/conftest.py
    jax.config.update("jax_enable_x64", True)
    _main()
