"""The batched GMRES loop's exit test on the device (K9, ops/krylov_ops.py)
and the look-ahead loop around it (solvers/krylov.gmres_batched), on the
CPU in float64.

K9's Arnoldi step reads the work's flag first and writes nothing where it
is 0.  krylov.gmres_batched queues step j of a cycle before it reads the
flag of step j - 1: where that flag is already home before step j's matvec
is queued (always on the CPU) the cycle ends without a wasted step, else
step j runs frozen (the card's case, forced here with ``lag``); both must
leave every output as the stepwise loop (the flag read after every step)
leaves it.  The cycle's end (gmres_solve_update) is held to its
kernel-order twin."""
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_parity import (gmres_operators, gmres_stepwise, gmres_torch_ops, rel,
                               t64)

from knpemidg_tpu.solvers import krylov as jkry
from knpemidg_tpu_torch.ops import krylov_ops as ko
from knpemidg_tpu_torch.solvers import krylov


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t.view(torch.int32)


def _lagging(monkeypatch, lag):
    """With ``lag`` the loop never finds the last flag home before it
    queues the next step (a card whose device work outlasts the host's),
    so each cycle that ends on the flag runs one frozen step."""
    if lag:
        monkeypatch.setattr(krylov._FlagLookahead, "done", lambda self, j: False)


# (systems, restart, rtol, atol, max_it, easy systems): one live system; two
# with one converging early; restarts; stopped by max_it (not converged);
# converged at its start (atol above every residual)
LOOP_CASES = {"mb1": (1, 20, 1e-10, 0.0, 200, ()),
              "early": (2, 20, 1e-10, 0.0, 200, (0,)),
              "restarts": (2, 3, 1e-12, 0.0, 300, (1,)),
              "max_it": (2, 3, 1e-14, 0.0, 5, ()),
              "converged": (2, 10, 1e-10, 1e6, 100, ())}


@pytest.mark.parametrize("lag", [False, True])
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_lookahead_gmres_equals_the_stepwise_loop(case, lag, monkeypatch):
    """krylov.gmres_batched returns the x bits, the per-system counts, the
    residual-norm bits and the convergence of the stepwise loop; with the
    flag late it runs one frozen step in each cycle that ended on the flag
    (none in a cycle that ran to the restart), with the flag home none."""
    _lagging(monkeypatch, lag)
    mb, restart, rtol, atol, max_it, easy = LOOP_CASES[case]
    rng = np.random.default_rng(70 + len(case))
    A = gmres_operators(rng, mb, 96, easy)
    mv, pc = gmres_torch_ops(A)
    b = t64(rng.normal(size=(mb, 2, 48)))
    x_s, it_s, rn_s, conv_s, early = gmres_stepwise(mv, b, pc, rtol, atol, max_it, restart)
    before = dict(krylov.GMRES_LOOKAHEAD)
    res = krylov.gmres_batched(mv, b, torch.zeros_like(b), pc, rtol, atol, max_it, restart)
    count = {k: krylov.GMRES_LOOKAHEAD[k] - before[k] for k in before}
    assert torch.equal(_bits(res.x), _bits(x_s))
    assert res.iters == it_s
    assert torch.equal(_bits(res.resnorm), _bits(rn_s))
    assert res.converged == conv_s
    assert count["solves"] == 1
    assert count["frozen"] == (early if lag else 0) and count["frozen"] <= count["cycles"]
    if case == "converged":
        assert res.iters == [0] * mb and not res.x.any() and count["cycles"] == 0
    if case == "early":
        assert res.iters[0] < res.iters[1]
    if case == "restarts":
        assert count["cycles"] > 1 and max(res.iters) > restart
    if case == "max_it":
        assert not res.converged and count["cycles"] == 2
    if case != "converged":
        assert early >= 1 or case == "max_it"


def _random_work(rng, mb, n, m, j):
    """A work after j steps with random contents in every buffer: rows
    0..j of V, the scalars, the partials; system 0 live."""
    wk = ko.gmres_work(mb, n, m, torch.float64, "cpu")
    for name in ("V", "h1", "h2", "hj1", "beta", "R", "g", "cs", "sn", "y", "partial"):
        t = getattr(wk, name)
        t.copy_(t64(rng.normal(size=tuple(t.shape))))
    wk.tol.copy_(t64(np.full(mb, 1e-3)))
    wk.g[0, j] = 5.0
    wk.ks.fill_(j)
    return wk


@pytest.mark.parametrize("entry", ["plain", "ordered", "wrapper"])
def test_frozen_arnoldi_twins_write_nothing(entry):
    """With the flag 0 the plain Arnoldi twins (and the wrapper's CPU path)
    leave w and every tensor of the work bit for bit as they were; with
    the flag 1 the same call writes (so the check is not vacuous)."""
    fn = {"plain": ko.gmres_arnoldi_plain, "ordered": ko.gmres_arnoldi_ordered_plain,
          "wrapper": ko.gmres_arnoldi}[entry]
    rng = np.random.default_rng(80)
    mb, n, m, j = 2, 300, 6, 2
    for flag in (0, 1):
        wk = _random_work(rng, mb, n, m, j)
        wk.flag.fill_(flag)
        w = t64(rng.normal(size=(mb, n)))
        tensors = [w] + [t for t in wk if isinstance(t, torch.Tensor)]
        before = [t.clone() for t in tensors]
        assert fn(w, wk, j) is wk
        same = all(torch.equal(_bits(a), _bits(b_)) if a.is_floating_point()
                   else torch.equal(a, b_) for a, b_ in zip(tensors, before))
        assert same == (flag == 0), (entry, flag)


@pytest.mark.parametrize("ks", [[0], [1], [4], [16], [30], [0, 7, 30, 1]],
                         ids=["ks0", "ks1", "ks4", "ks16", "ks30", "mixed"])
def test_solve_update_ordered_twin_matches_plain(ks):
    """gmres_solve_update_ordered_plain (what the card's one launch equals
    bit for bit) against gmres_solve_update_plain (the triangular solve and
    the whole-basis einsum, the CPU path) to 1e-14 in y and x, at restart
    30 with ks populated rows a system; a system with ks = 0 keeps x's bits
    and a zero y."""
    rng = np.random.default_rng(90 + sum(ks))
    mb, n, m = len(ks), 257, 30
    wk = ko.gmres_work(mb, n, m, torch.float64, "cpu")
    for s, k in enumerate(ks):
        wk.V[:k, s] = t64(rng.normal(size=(k, n)))
    R = 0.3 * rng.normal(size=(mb, m + 1, m)) + 2.0 * np.eye(m + 1, m)[None]
    wk.R.copy_(t64(R))
    wk.g.copy_(t64(rng.normal(size=(mb, m + 1))))
    wk.ks.copy_(torch.tensor(ks, dtype=torch.int32))
    x = t64(rng.normal(size=(mb, n)))
    a, b_ = wk, wk._replace(y=wk.y.clone())
    xa = ko.gmres_solve_update_ordered_plain(a, x.clone())
    xb = ko.gmres_solve_update_plain(b_, x.clone())
    assert rel(a.y, b_.y) < 1e-14 and rel(xa, xb) < 1e-14
    for s, k in enumerate(ks):
        if k == 0:
            assert torch.equal(_bits(xa[s]), _bits(x[s])) and not a.y[s].any()
        else:
            assert not a.y[s, k:].any() and rel(xa[s], xb[s]) < 1e-14


@functools.lru_cache(maxsize=None)
def _jax_gmres(restart, easy):
    """The JAX gmres_batched on the seeded dense systems of
    test_lookahead_gmres_matches_jax (with a Jacobi preconditioner), once
    per case: (A, b, iters, x, converged)."""
    rng = np.random.default_rng(95 + restart)
    mb, n = 2, 96
    A = gmres_operators(rng, mb, n, easy)
    b = rng.normal(size=(mb, 2, n // 2))
    Aj, dj = jnp.asarray(A), jnp.asarray(1.0 / np.diagonal(A, axis1=1, axis2=2))
    mvj = lambda v: jnp.einsum("sij,sj->si", Aj, v.reshape(mb, -1)).reshape(v.shape)
    pcj = lambda v: (dj * v.reshape(mb, -1)).reshape(v.shape)
    rj = jkry.gmres_batched(mvj, jnp.asarray(b), jnp.zeros(b.shape), pcj, rtol=1e-10, atol=0.0,
                            max_it=400, restart=restart)
    return (A, b, np.asarray(rj.iters).tolist(), np.asarray(rj.x),
            bool(np.all(np.asarray(rj.converged))))


@pytest.mark.parametrize("lag", [False, True])
@pytest.mark.parametrize("restart,easy", [(20, (0,)), (4, ())])
def test_lookahead_gmres_matches_jax(restart, easy, lag, monkeypatch):
    """The look-ahead loop against knpemidg_tpu.solvers.krylov.gmres_batched
    on seeded dense systems with a Jacobi preconditioner applied on each
    side in its own package: equal per-system iterations, x within 1e-10,
    both converged (one cycle with an early system; restarts)."""
    _lagging(monkeypatch, lag)
    A, b, iters_j, x_j, conv_j = _jax_gmres(restart, easy)
    mv, pc = gmres_torch_ops(A)
    rt = krylov.gmres_batched(mv, t64(b), torch.zeros(b.shape, dtype=torch.float64), pc,
                              rtol=1e-10, atol=0.0, max_it=400, restart=restart)
    assert rt.converged and conv_j
    assert rt.iters == iters_j
    assert rel(rt.x, x_j) < 1e-10
    if restart == 4:
        assert max(rt.iters) > restart
