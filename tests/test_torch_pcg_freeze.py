"""The PCG loop's test on the device (K8, ops/krylov_ops.py) and the
look-ahead loop around it (solvers/krylov.pcg), on the CPU in float64.

Every K8 entry reads the work's flag first and writes nothing where it is
0; pcg_dot2_direction counts the live iterations and writes the flag as the
JAX while-loop's cond (knpemidg_tpu/solvers/krylov.py:97-99): zz > tol^2
and count < max_it.  krylov.pcg queues iteration j before it reads the
flag of iteration j - 1: where that flag is already home (always on the
CPU) it stops without a wasted iteration, else one frozen iteration runs
after the exit (the card's case, forced here with ``lag``); both must
leave every output as the stepwise loop leaves it.  The tolerance dot of
K9 (gmres_cgs_dot) is held to the kernel's summation order here too."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_parity import rel, t64
import test_torch_parity as tp

from knpemidg_tpu.solvers import krylov as jkry
from knpemidg_tpu_torch.ops import krylov_ops as ko
from knpemidg_tpu_torch.solvers import krylov


def _vectors(rng, shape=(4, 700)):
    return [t64(rng.normal(size=shape)) for _ in range(5)]


def _work(mode, shape, flag, rng, iters=3, max_it=50):
    w = t64((rng.uniform(size=shape) > 0.3).astype(np.float64))
    wsum = float(w.sum()) if mode == 2 else float(np.prod(shape))
    wk = ko.pcg_work(t64([1.7, 2.0, 0.3, 0.4, 1e-8, wsum]),
                     torch.tensor([flag], dtype=torch.int32), w if mode == 2 else None, mode,
                     int(np.prod(shape)), max_it)
    wk.iters.fill_(iters)
    return wk


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t.view(torch.int32)


ENTRIES = {
    "pcg_dot": lambda wk, x, r, p, Ap, z: ko.pcg_dot_plain(p, Ap, wk),
    "pcg_update": lambda wk, x, r, p, Ap, z: ko.pcg_update_plain(x, r, p, Ap, wk),
    "pcg_dot2_direction": lambda wk, x, r, p, Ap, z: ko.pcg_dot2_direction_plain(r, z, p, wk),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_frozen_plain_entries_write_nothing(entry, mode):
    """With the flag 0 each K8 plain twin leaves x, r, p, z, the scalars,
    the flag and the count bit for bit as they were; with the flag 1 the
    same call writes (so the check above is not vacuous)."""
    rng = np.random.default_rng(40 + mode)
    vecs = _vectors(rng)
    for flag in (0, 1):
        wk = _work(mode, vecs[0].shape, flag, rng)
        before = [t.clone() for t in vecs + [wk.sc, wk.flag, wk.iters]]
        ENTRIES[entry](wk, *vecs)
        after = vecs + [wk.sc, wk.flag, wk.iters]
        same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(after, before))
        assert same == (flag == 0), (entry, flag)


def test_dot2_direction_counts_and_caps():
    """A live pcg_dot2_direction adds one to the count and writes the flag
    zz > tol^2 and count < max_it: the cap alone clears it."""
    rng = np.random.default_rng(44)
    x, r, p, Ap, z = _vectors(rng)
    for iters, max_it, want in ((3, 50, 1), (49, 50, 0), (0, 1, 0)):
        wk = _work(1, x.shape, 1, rng, iters=iters, max_it=max_it)
        ko.pcg_dot2_direction_plain(r, z, p.clone(), wk)
        assert wk.iters.tolist() == [iters + 1]
        assert wk.flag.tolist() == [want]


def _spd_system(rng, nd=4, nc=300, K=4):
    """A symmetric positive definite block operator: diagonal blocks of a
    dominant SPD matrix per cell plus a symmetric coupling of each cell to
    its neighbour, applied densely."""
    n = nd * nc
    A = rng.normal(size=(n, n)) * 0.02
    A = A + A.T
    A[np.abs(np.arange(n)[:, None] - np.arange(n)[None]) > K * nd] = 0.0
    A += np.diag(1.0 + rng.uniform(size=n))
    return A, rng.normal(size=(nd, nc)), n


def _stepwise(matvec, b, precond, rtol, atol, max_it):
    """The loop before the look-ahead: the flag read after every
    iteration, the count on the host; the same K8 entries."""
    x = b.new_zeros(b.shape)
    r = b.clone()
    z = precond(r).contiguous()
    p = z.clone()
    rz, zz = torch.dot(r.reshape(-1), z.reshape(-1)), torch.dot(z.reshape(-1), z.reshape(-1))
    bz = precond(b)
    tol = torch.clamp(rtol * torch.sqrt(torch.dot(bz.reshape(-1), bz.reshape(-1))), min=atol)
    zero = torch.zeros_like(rz)
    wk = ko.pcg_work(torch.stack([rz, zz, zero, zero, tol * tol,
                                  torch.tensor(float(b.numel()), dtype=b.dtype)]),
                     (zz > tol * tol).to(torch.int32).reshape(1), None, 0, b.numel(), max_it)
    k = 0
    while bool(wk.flag):
        Ap = matvec(p).contiguous()
        ko.pcg_dot(p, Ap, wk)
        ko.pcg_update(x, r, p, Ap, wk)
        z = precond(r).contiguous()
        ko.pcg_dot2_direction(r, z, p, wk)
        k += 1
    return x, k, torch.sqrt(wk.sc[ko.ZZ])


def _lagging(monkeypatch, lag):
    """With ``lag`` the loop never finds the last flag home before it
    queues the next iteration (a card whose device work outlasts the
    host's), so it runs the frozen iteration."""
    if lag:
        monkeypatch.setattr(krylov._FlagLookahead, "done", lambda self, j: False)


@pytest.mark.parametrize("lag", [False, True])
@pytest.mark.parametrize("max_it", [500, 7])
def test_lookahead_pcg_equals_the_stepwise_loop(max_it, lag, monkeypatch):
    """krylov.pcg (no projection) returns the x bits, the count and the
    residual norm of the stepwise loop, converged or stopped by the cap;
    with the flag late it runs one frozen iteration after a converged exit
    (none after the cap), with the flag home none."""
    _lagging(monkeypatch, lag)
    rng = np.random.default_rng(45)
    A, b, n = _spd_system(rng)
    At, bt = t64(A), t64(b)
    mv = lambda v: (At @ v.reshape(-1)).reshape(v.shape)
    pc = lambda v: v / 1.5
    x_s, k_s, rn_s = _stepwise(mv, bt, pc, 1e-10, 0.0, max_it)
    f0 = krylov.PCG_LOOKAHEAD["frozen"]
    res = krylov.pcg(mv, bt, torch.zeros_like(bt), pc, 1e-10, 0.0, max_it)
    assert torch.equal(_bits(res.x), _bits(x_s))
    assert res.iters == k_s and isinstance(res.iters, int)
    assert torch.equal(_bits(res.resnorm), _bits(rn_s))
    assert res.converged == (max_it == 500)
    assert krylov.PCG_LOOKAHEAD["frozen"] - f0 == (1 if res.converged and lag else 0)


@pytest.mark.parametrize("lag", [False, True])
def test_lookahead_pcg_already_converged(lag, monkeypatch):
    """A solve whose initial residual meets the tolerance returns x0
    unchanged with 0 iterations (with the flag late, after one frozen
    iteration)."""
    _lagging(monkeypatch, lag)
    f0 = krylov.PCG_LOOKAHEAD["frozen"]
    rng = np.random.default_rng(46)
    A, b, n = _spd_system(rng)
    At, bt = t64(A), t64(b)
    mv = lambda v: (At @ v.reshape(-1)).reshape(v.shape)
    res = krylov.pcg(mv, bt, torch.zeros_like(bt), lambda v: v, 1e-10, 1e3, 50)
    assert res.iters == 0 and res.converged and not res.x.any()
    assert krylov.PCG_LOOKAHEAD["frozen"] - f0 == int(lag)


@pytest.mark.parametrize("max_it,project", [(400, False), (400, True), (9, False)])
def test_pcg_iterations_equal_jax(max_it, project):
    """The look-ahead loop against knpemidg_tpu.solvers.krylov.pcg on a
    seeded SPD block system (with and without the constant-mode
    projection): equal iteration counts, x within 1e-12; with the cap
    binding, iters = max_it and not converged in both."""
    rng = np.random.default_rng(47)
    A, b, n = _spd_system(rng)
    if project:
        # a weighted graph Laplacian of A's pattern: symmetric positive
        # semidefinite, the constant vector its nullspace
        W = np.abs(A - np.diag(np.diag(A)))
        A = np.diag(W.sum(1)) - W
    Aj, At = jnp.asarray(A), t64(A)
    pcj = lambda v: v / 1.5
    rj = jkry.pcg(lambda v: (Aj @ v.reshape(-1)).reshape(v.shape), jnp.asarray(b),
                  jnp.zeros(b.shape), pcj, 1e-10, 0.0, max_it, project_nullspace=project)
    rt = krylov.pcg(lambda v: (At @ v.reshape(-1)).reshape(v.shape), t64(b),
                    torch.zeros(b.shape, dtype=torch.float64), lambda v: v / 1.5, 1e-10, 0.0,
                    max_it, project_nullspace=project)
    assert rt.iters == int(rj.iters)
    assert rt.converged == bool(rj.converged)
    assert rel(rt.x, np.asarray(rj.x)) < 1e-12
    if max_it == 9:
        assert rt.iters == 9 and not rt.converged


def test_cell_fixture_emi_counts_stay():
    """Two steps of the EMIx cell fixture at emix.solver_params() through
    the look-ahead loop: EMI [5, 3] as the JAX package's; on the CPU each
    flag is home at once, so no iteration runs frozen."""
    S, sp = tp.emix_torch_auto()
    s0, f0 = krylov.PCG_LOOKAHEAD["solves"], krylov.PCG_LOOKAHEAD["frozen"]
    S.solve_system_active(0.2, 0.0, sp)
    assert S.stats.emi_niters == [5, 3]
    assert S.stats.knp_niters == [[1, 1], [2, 1]]
    solves = krylov.PCG_LOOKAHEAD["solves"] - s0
    assert solves >= 2 and krylov.PCG_LOOKAHEAD["frozen"] == f0


def _kernel_order_dot(V, w, rows, dtype):
    """out[s, k] = V[k, s] . w[s] summed as the dot kernel sums it, written
    out in numpy: 2,048-entry chunks; thread t of a chunk adds its products
    t + 256 e in order from zero; each warp's xor-shuffle tree (16, 8, 4,
    2, 1), then the eight warps in index order; the chunk sums the same way
    in one block."""
    def block(vals):                      # 256 values -> the block tree's sum
        v = vals.reshape(8, 32).copy()
        lane = np.arange(32)
        for o in (16, 8, 4, 2, 1):
            v = (v + v[:, lane ^ o]).astype(dtype)
        acc = v[0, 0]
        for k in range(1, 8):
            acc = dtype(acc + v[k, 0])
        return acc

    def thread_sums(vals, per):           # thread t adds vals t + 256 e
        acc = np.zeros(256, dtype=dtype)
        for e in range(per):
            acc = (acc + vals[256 * e:256 * (e + 1)]).astype(dtype)
        return acc

    mb, n = w.shape
    nblk = -(-n // 2048)
    out = np.zeros((mb, rows), dtype=dtype)
    for s in range(mb):
        for k in range(rows):
            prod = np.zeros(nblk * 2048, dtype=dtype)
            prod[:n] = (V[k, s] * w[s]).astype(dtype)
            parts = np.zeros(-(-nblk // 256) * 256, dtype=dtype)
            for q in range(nblk):
                parts[q] = block(thread_sums(prod[2048 * q:2048 * (q + 1)], 8))
            out[s, k] = block(thread_sums(parts, len(parts) // 256))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gmres_cgs_dot_twins_equal_the_ordered_partial_sum(dtype):
    """gmres_cgs_dot_ordered_plain (what the card's one-launch dot equals
    bit for bit) against the kernel's order written out in numpy, exactly,
    over several chunks and a ragged tail; the einsum twin (the CPU path)
    against it within the recursive-summation bound of that order, (8 + 5
    + 7 + 1 + 5 + 7 + 1) eps sum |terms|; out beyond the populated rows
    untouched by the ordered twin."""
    rng = np.random.default_rng(48)
    mb, n, rows, m = 2, 3 * 2048 + 101, 3, 5
    V = np.zeros((m + 1, mb, n), dtype=dtype)
    V[:rows] = rng.normal(size=(rows, mb, n))
    w = rng.normal(size=(mb, n)).astype(dtype)
    want = _kernel_order_dot(V, w, rows, dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    Vt, wt = torch.as_tensor(V), torch.as_tensor(w)
    out = torch.full((mb, m + 1), 7.0, dtype=tdt)
    ko.gmres_cgs_dot_ordered_plain(Vt, wt, rows, out)
    assert np.array_equal(out[:, :rows].numpy(), want)
    assert bool((out[:, rows:] == 7.0).all())
    plain = ko.gmres_cgs_dot(Vt, wt, rows, torch.zeros((mb, m + 1), dtype=tdt))
    bound = 34 * np.finfo(dtype).eps * np.einsum("ksn,sn->sk", np.abs(V[:rows]).astype(
        np.float64), np.abs(w).astype(np.float64))
    assert np.all(np.abs(plain[:, :rows].numpy().astype(np.float64) - want) <= bound)
    assert not plain[:, rows:].any()
