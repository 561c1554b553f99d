"""The port's batched BiCGStab (krylov.bicgstab_batched, kernel K15's plain
versions on the CPU) against the JAX package in float64: the random
batched systems of tests/test_krylov_batched.py, the plain twins against a
transcription of the JAX loop body, and two splitting steps with
``knp_solver="bicgstab"`` on the 2D neuron (cell layout); the pair layout's
steps are in test_torch_bicgstab_pair.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_parity as tp
from test_torch_parity import rel

from knpemidg_tpu.solvers import krylov as jkry
from knpemidg_tpu_torch.ops import krylov_ops as ko
from knpemidg_tpu_torch.solvers import krylov

TOL = 1e-8
FIELDS = ("phi", "c", "c_elim", "phi_M")


def _systems(m=3, n=80, seed=11):
    """tests/test_krylov_batched.py's batched nonsymmetric systems with
    their Jacobi preconditioner."""
    rng = np.random.default_rng(seed)
    A = np.stack([np.eye(n) * (2.0 + i) + 0.3 * rng.normal(size=(n, n)) / np.sqrt(n)
                  for i in range(m)])
    b = rng.normal(size=(m, n))
    return A, b, 1.0 / np.einsum("sii->si", A)


@pytest.mark.parametrize("case", ["plain", "b_ref", "frozen", "max_it"])
def test_bicgstab_batched_matches_jax(case):
    """Equal per-system iteration counts and x within 1e-10: as shipped,
    with a b_ref anchoring the tolerance, with a system frozen from the
    start (zero rhs and atol 0: x stays x0), and stopped by max_it."""
    A, b, D = _systems()
    x0 = np.zeros_like(b)
    b_ref = None
    if case == "b_ref":
        b_ref = 3.0 * b
        x0 = 0.1 * b
    if case == "frozen":
        b[1] = 0.0
        x0[1] = 0.0
    max_it = 3 if case == "max_it" else 500
    kw = dict(rtol=1e-10, atol=0.0, max_it=max_it)
    rj = jkry.bicgstab_batched(lambda V: jnp.einsum("sij,sj->si", jnp.asarray(A), V),
                               jnp.asarray(b), jnp.asarray(x0),
                               lambda r: jnp.asarray(D) * r,
                               b_ref=None if b_ref is None else jnp.asarray(b_ref), **kw)
    At, Dt = torch.as_tensor(A), torch.as_tensor(D)
    rt = krylov.bicgstab_batched(lambda V: torch.einsum("sij,sj->si", At, V),
                                 torch.as_tensor(b), torch.as_tensor(x0), lambda r: Dt * r,
                                 b_ref=None if b_ref is None else torch.as_tensor(b_ref), **kw)
    assert rt.iters == np.asarray(rj.iters).tolist()
    assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() < 1e-10
    assert np.allclose(rt.resnorm.numpy(), np.asarray(rj.resnorm), rtol=1e-6, atol=1e-300)
    assert rt.converged == bool(np.all(np.asarray(rj.converged)))
    if case == "frozen":
        assert rt.iters[1] == 0 and torch.equal(rt.x[1], torch.zeros(b.shape[1],
                                                                     dtype=torch.float64))
    if case == "max_it":
        assert max(rt.iters) == 3 and not rt.converged


def _reference_loop(Aop, r0, bz, rtol, atol, iters):
    """The JAX loop body (knpemidg_tpu/solvers/krylov.py:527-552)
    transcribed in torch from x0 = 0: the state after each iteration."""
    norms = lambda v: torch.sqrt(torch.einsum("sn,sn->s", v, v))
    dots = lambda a, c: torch.einsum("sn,sn->s", a, c)
    mb = r0.shape[0]
    tol = torch.clamp(rtol * norms(bz), min=atol)
    x, r, rhat = torch.zeros_like(r0), r0.clone(), r0.clone()
    rho, alpha, omega = (torch.ones(mb, dtype=r0.dtype) for _ in range(3))
    v, p = torch.zeros_like(r0), torch.zeros_like(r0)
    ks = torch.zeros(mb, dtype=torch.int32)
    out = []
    for _ in range(iters):
        live = norms(r) > tol
        ks = ks + live.to(torch.int32)
        rho_new = dots(rhat, r)
        safe = (torch.abs(rho) > 0) & (torch.abs(omega) > 0) & live
        beta = torch.where(safe, (rho_new / rho) * (alpha / omega), torch.zeros_like(rho))
        p = torch.where(live[:, None], r + beta[:, None] * (p - omega[:, None] * v), p)
        v = Aop(p)
        denom = dots(rhat, v)
        alpha_n = torch.where(torch.abs(denom) > 0, rho_new / denom, torch.zeros_like(denom))
        alpha_n = torch.where(live, alpha_n, torch.zeros_like(denom))
        s = r - alpha_n[:, None] * v
        t = Aop(s)
        tt = dots(t, t)
        omega_n = torch.where(tt > 0, dots(t, s) / tt, torch.zeros_like(tt))
        omega_n = torch.where(live, omega_n, omega)
        x = x + alpha_n[:, None] * p + torch.where(live, omega_n, torch.zeros_like(tt))[:, None] * s
        r = torch.where(live[:, None], s - omega_n[:, None] * t, r)
        rho = torch.where(live, rho_new, rho)
        alpha = alpha_n + (~live).to(r0.dtype) * alpha
        omega = omega_n
        out.append(dict(x=x, r=r, v=v, s=s, rho=rho, alpha=alpha, omega=omega, ks=ks))
    return out


@pytest.mark.parametrize("ordered", [False, True])
def test_bicgstab_plain_twins_match_the_loop(ordered):
    """bicgstab_start_plain / _alpha_plain / _omega_plain, composed as
    bicgstab_batched composes them, equal the JAX loop body transcribed in
    torch after every iteration (the einsum twins to the last bit, the
    kernel-ordered twins to 1e-12), the frozen system included."""
    A, b, D = _systems(m=3, n=300, seed=5)
    b[2] = 0.0
    At, Dt = torch.as_tensor(A), torch.as_tensor(D)
    Aop = lambda V: Dt * torch.einsum("sij,sj->si", At, V)
    r0 = Dt * torch.as_tensor(b)
    bz = 2.0 * r0
    ref = _reference_loop(Aop, r0, bz, 1e-9, 0.0, 6)
    wk = ko.bicgstab_work(3, 300, torch.float64, "cpu")
    ko.bicgstab_start_plain(r0, bz, wk, 1e-9, 0.0, ordered=ordered)
    x = torch.zeros_like(r0)
    tol = 1e-12 if ordered else 0.0
    # each quantity's scale over the loop: the residuals shrink by
    # cancellation, so the rounding of the ordered sums is measured against
    # their size at the start
    scale = {key: max(float(torch.max(torch.abs(w[key]))) for w in ref) or 1.0
             for key in ("x", "r", "v", "s", "rho", "alpha", "omega")}
    for it, want in enumerate(ref):
        ko.bicgstab_alpha_plain(Aop(wk.p), wk, ordered=ordered)
        ko.bicgstab_omega_plain(Aop(wk.s), x, wk, ordered=ordered)
        got = dict(x=x, r=wk.r, v=wk.v, s=wk.s, rho=wk.sc[:, ko.BI_RHO],
                   alpha=wk.sc[:, ko.BI_ALPHA], omega=wk.sc[:, ko.BI_OMEGA])
        for key, val in got.items():
            err = float(torch.max(torch.abs(val - want[key])))
            assert err <= tol * scale[key], (it, key, err)
        assert torch.equal(wk.ks, want["ks"]), it
        live = torch.sqrt(torch.einsum("sn,sn->s", want["r"], want["r"])) > wk.sc[:, ko.BI_TOL]
        assert torch.equal(wk.live.bool(), live)
        assert int(wk.flag) == int(bool(live.any()))
    assert int(wk.ks[2]) == 0 and torch.equal(x[2], torch.zeros(300, dtype=torch.float64))


def test_neuron_2d_bicgstab_two_steps_match_jax():
    """Two steps of the 2D neuron with the BiCGStab KNP solve on the cell
    layout: equal Krylov counts, fields to 1e-8."""
    Sj, spj = tp.neuron_2d_jax(knp_solver="bicgstab")
    St, spt = tp.neuron_2d_torch(knp_solver="bicgstab")
    sj = Sj.solve_system_active(2e-4, 0.0, spj)
    st = St.solve_system_active(2e-4, 0.0, spt)
    assert Sj.stats.emi_niters == St.stats.emi_niters
    assert Sj.stats.knp_niters == St.stats.knp_niters
    assert all(k > 0 for ks in St.stats.knp_niters for k in ks)
    for key in FIELDS:
        assert rel(st[key], sj[key]) < TOL, key
