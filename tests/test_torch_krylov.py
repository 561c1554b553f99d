"""solvers/krylov of the port against the JAX package in float64: the
increment-form EMI PCG and the batched KNP GMRES of the first EMIx step,
run on JAX's preconditioner data carried across, and both Krylov loops on
random block systems."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_parity as tp
from test_torch_parity import rel, t64

from knpemidg_tpu.ops.spmv import bell_matvec_multi as jbmm, bell_matvec as jbm
from knpemidg_tpu.solvers import krylov as jkry
from knpemidg_tpu_torch.ops.spmv import bell_matvec_multi, bell_matvec
from knpemidg_tpu_torch.solvers import krylov

TOL = 1e-10


@pytest.fixture(scope="module")
def step1():
    """The first EMIx step up to each solve, in both packages, with the
    JAX state (pc included) carried into the port."""
    Sj, spj = tp.emix_jax()
    St, spt = tp.emix_torch()
    sj = Sj._ode_step(Sj.attach_pc(Sj._initial_state(0.0), spj), first_step=True)
    st = tp.jax_state_for_torch(sj, St)
    St.attach_pc(st, spt)                     # caches the KNP statics only
    return Sj, spj, sj, St, spt, st


def test_emi_pcg_matches_jax(step1):
    Sj, spj, sj, St, spt, st = step1
    pMj, _, Itj = Sj._pads(sj)
    bj, rj, Pj = Sj._assemble_emi(sj["c"], sj["c_elim"], pMj, Itj, sj["t"])
    phi_j, it_j, conv_j = Sj._emi_solve_iterative(
        bj, Pj, rj, sj["phi"], spj, pc=sj["pc"]["emi"], phi_prev=sj["phi_prev"])
    pMt, _, Itt = St._pads(st)
    bt, rt, Pt = St._assemble_emi(st["c"], st["c_elim"], pMt, Itt, st["t"])
    phi_t, it_t, conv_t = St._emi_solve_iterative(
        bt, Pt, rt, st["phi"], spt, pc=st["pc"]["emi"], phi_prev=st["phi_prev"])
    assert bool(conv_j) and conv_t
    assert it_t == int(it_j) == 7
    assert rel(phi_t, phi_j) < TOL


def test_knp_gmres_matches_jax(step1):
    Sj, spj, sj, St, spt, st = step1
    pMj, Ichj, Itj = Sj._pads(sj)
    bKj, rKj = Sj._knp_assemble_all(sj["c"], sj["c_elim"], sj["phi"], pMj, Ichj,
                                    Itj, sj["t"], sj["c"])
    c_j, it_j, conv_j = Sj._knp_solve_all(bKj, rKj, sj["c"], spj, pcK=sj["pc"]["knp"])
    c_t, it_t, conv_t = St._knp_solve_all(t64(bKj), t64(rKj), st["c"], spt,
                                          pcK=st["pc"]["knp"])
    assert bool(np.all(np.asarray(conv_j))) and conv_t
    assert it_t == np.asarray(it_j).tolist()
    assert rel(c_t - st["c"], np.asarray(c_j) - np.asarray(sj["c"])) < 1e-8
    assert rel(c_t, c_j) < TOL


def _system(rng, nc=300, nd=3, K=4, m=2):
    nbr = np.vstack([np.arange(nc), rng.integers(0, nc, size=(K - 1, nc))]).astype(np.int32)
    B = rng.normal(size=(m, K, nd, nd, nc)) * 0.05
    for s in range(m):
        B[s, 0, range(nd), range(nd), :] += 3.0
    return B, nbr


def test_gmres_batched_uneven_convergence_matches_jax():
    rng = np.random.default_rng(3)
    B, nbr = _system(rng)
    B[0, 0] *= 30.0                         # system 0: very dominant
    B[1, 1:] *= 8.0                         # system 1: weakly dominant
    b = rng.normal(size=(2, 3, 300))
    prec = lambda r: r
    rj = jkry.gmres_batched(lambda V: jbmm(jnp.asarray(B), jnp.asarray(nbr), V),
                            jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)), prec,
                            rtol=1e-9, atol=0.0, max_it=300, restart=12)
    nbr_t = torch.as_tensor(nbr)
    rt = krylov.gmres_batched(lambda V: bell_matvec_multi(t64(B), nbr_t, V),
                              t64(b), torch.zeros(2, 3, 300, dtype=torch.float64),
                              prec, rtol=1e-9, atol=0.0, max_it=300, restart=12)
    assert rt.converged and bool(np.all(np.asarray(rj.converged)))
    assert rt.iters == np.asarray(rj.iters).tolist()
    assert rt.iters[0] < rt.iters[1]
    assert rel(rt.x, rj.x) < TOL


def test_pcg_nullspace_matches_jax():
    """Singular SPD system (graph Laplacian of a cell ring plus an
    intra-cell part with zero row sums) with the constant projection and a
    diagonal preconditioner."""
    rng = np.random.default_rng(4)
    nc, nd = 200, 3
    nbr = np.vstack([np.arange(nc), (np.arange(nc) + 1) % nc,
                     (np.arange(nc) - 1) % nc]).astype(np.int32)
    B = np.zeros((3, nd, nd, nc))
    w = rng.uniform(0.5, 1.5, nc)
    for i in range(nd):
        B[1, i, i] = -w
        B[2, i, i] = -np.roll(w, 1)
        B[0, i, i] = w + np.roll(w, 1)
    # intra-cell coupling with zero row sums: constants stay the only null mode
    B[0] += (np.eye(nd) - 1.0 / nd)[..., None] * rng.uniform(0.5, 1.0, nc)
    b = rng.normal(size=(nd, nc))
    b -= b.mean()
    Pd = B[0] + 0.1 * np.eye(nd)[..., None]
    Pinv = 1.0 / np.diagonal(Pd, axis1=0, axis2=1).T
    rj = jkry.pcg(lambda v: jbm(jnp.asarray(B), jnp.asarray(nbr), v), jnp.asarray(b),
                  jnp.zeros((nd, nc)), lambda r: jnp.asarray(Pinv) * r,
                  rtol=1e-10, atol=0.0, max_it=500, project_nullspace=True)
    rt = krylov.pcg(lambda v: bell_matvec(t64(B), torch.as_tensor(nbr), v), t64(b),
                    torch.zeros(nd, nc, dtype=torch.float64), lambda r: t64(Pinv) * r,
                    rtol=1e-10, atol=0.0, max_it=500, project_nullspace=True)
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    assert rel(rt.x, rj.x) < 1e-8
