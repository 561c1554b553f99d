"""The plain versions of the Krylov kernels (ops/krylov_ops.py: K8 the PCG
iteration, K9 the batched GMRES cycle) against the JAX package's formulas
in float64, and the restructured loops (solvers/krylov.py, which run every
entry point through its wrapper) against jkry.pcg / jkry.gmres_batched.

The K9 kernels read only the populated basis rows 0..j; their plain
versions keep the whole-basis einsums of knpemidg_tpu/solvers/krylov.py:
385-389 on a basis that is zero beyond row j.  The first test holds the
two readings equal: the rows beyond j add exact zeros."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from test_torch_parity import rel, t64, to_np

from knpemidg_tpu.ops.spmv import bell_matvec as jbm, bell_matvec_multi as jbmm
from knpemidg_tpu.solvers import krylov as jkry
from knpemidg_tpu_torch.ops import krylov_ops as ko
from knpemidg_tpu_torch.ops.spmv import bell_matvec, bell_matvec_multi
from knpemidg_tpu_torch.solvers import krylov

MB, N, M = 2, 600, 8           # systems, entries, restart


def _basis(rng, j):
    """A (mb, m+1, n) basis (the JAX layout) with rows 0..j populated."""
    V = np.zeros((MB, M + 1, N))
    V[:, :j + 1] = rng.normal(size=(MB, j + 1, N))
    return V


def _work(V):
    wk = ko.gmres_work(MB, N, M, torch.float64, "cpu")
    wk.V.copy_(t64(np.swapaxes(V, 0, 1)))
    return wk


@pytest.mark.parametrize("j", [0, 3, 7])
def test_cgs2_pass_matches_jax_whole_basis(j):
    """Both CGS passes (dot, update, dot, update) against the whole-basis
    einsums of the JAX package, and against the populated-rows sums the
    kernels compute, to 1e-14."""
    rng = np.random.default_rng(20 + j)
    V = _basis(rng, j)
    w = rng.normal(size=(MB, N))
    Vj, wj = jnp.asarray(V), jnp.asarray(w)
    h1j = jnp.einsum("skn,sn->sk", Vj, wj)
    w1j = wj - jnp.einsum("sk,skn->sn", h1j, Vj)
    h2j = jnp.einsum("skn,sn->sk", Vj, w1j)
    w2j = w1j - jnp.einsum("sk,skn->sn", h2j, Vj)

    wk = _work(V)
    wt = t64(w)
    ko.gmres_cgs_dot(wk.V, wt, j + 1, wk.h1)
    ko.gmres_cgs_update_plain(wk.V, wt, wk.h1, j + 1)
    ko.gmres_cgs_dot(wk.V, wt, j + 1, wk.h2)
    ko.gmres_cgs_update_plain(wk.V, wt, wk.h2, j + 1)
    assert rel(wk.h1, h1j) < 1e-14 and rel(wk.h2, h2j) < 1e-14
    assert rel(wt, w2j) < 1e-14
    # the populated rows alone (what the kernels read)
    Vp = V[:, :j + 1]
    h1p = np.einsum("skn,sn->sk", Vp, w)
    assert rel(wk.h1[:, :j + 1], h1p) < 1e-14
    assert not wk.h1[:, j + 1:].any()
    w1p = w - np.einsum("sk,skn->sn", h1p, Vp)
    assert rel(wt, w1p - np.einsum("sk,skn->sn", np.einsum("skn,sn->sk", Vp, w1p), Vp)) < 1e-14


def test_gmres_start_and_next_match_the_formulas():
    """beta, V[0] and g = beta e1 (the cycle's start, krylov.py:319-325);
    hj1 and V[j+1] with a frozen system's row zero (:392-396)."""
    rng = np.random.default_rng(21)
    wk = _work(_basis(rng, 2))
    wk.tol.copy_(t64([1e-3, 1e3]))
    r = rng.normal(size=(MB, N))
    ko.gmres_start(t64(r), wk)
    beta = np.sqrt(np.einsum("sn,sn->s", r, r))
    assert rel(wk.beta, beta) < 1e-15
    assert rel(wk.V[0], r / beta[:, None]) < 1e-15
    assert not wk.V[1:].any()                         # zeroed for the whole-basis sums
    assert rel(wk.g[:, 0], beta) < 1e-15 and not wk.g[:, 1:].any()
    assert int(wk.flag) == 1 and not wk.ks.any() and not wk.R.any()
    wk.g[:, 2] = t64([5.0, 5.0])                      # system 0 live, system 1 frozen
    w = rng.normal(size=(MB, N))
    ko.gmres_next_plain(t64(w), wk, 2)
    hj1 = np.sqrt(np.einsum("sn,sn->s", w, w))
    assert rel(wk.hj1, hj1) < 1e-15
    assert rel(wk.V[3, 0], w[0] / hj1[0]) < 1e-15 and not wk.V[3, 1].any()


def _reference_step(h1, h2, hj1, R, g, cs, sn, ks, tol, j):
    """knpemidg_tpu/solvers/krylov.py:397-439 (rot="replay") in numpy."""
    R, g, cs, sn, ks = R.copy(), g.copy(), cs.copy(), sn.copy(), ks.copy()
    gj = g[:, j].copy()
    live = np.abs(gj) > tol
    ks += live
    h = h1 + h2
    h[:, j + 1] = hj1
    for i in range(j):
        hi = cs[:, i] * h[:, i] + sn[:, i] * h[:, i + 1]
        hi1 = -sn[:, i] * h[:, i] + cs[:, i] * h[:, i + 1]
        h[:, i], h[:, i + 1] = hi, hi1
    hj, hjp = h[:, j].copy(), h[:, j + 1].copy()
    denom = np.sqrt(hj ** 2 + hjp ** 2)
    dsafe = np.where(denom > 0, denom, 1.0)
    c_new = np.where(live, np.where(denom > 0, hj / dsafe, 1.0), 1.0)
    s_new = np.where(live, np.where(denom > 0, hjp / dsafe, 0.0), 0.0)
    cs[:, j], sn[:, j] = c_new, s_new
    h[:, j] = np.where(live, denom, hj)
    h[:, j + 1] = 0.0
    g[:, j + 1] = np.where(live, -s_new * gj, 0.0)
    g[:, j] = np.where(live, c_new * gj, gj)
    R[:, :, j] = np.where(live[:, None], h, R[:, :, j])
    return R, g, cs, sn, ks, bool(np.any(np.abs(g[:, j + 1]) > tol))


@pytest.mark.parametrize("j", [0, 4])
def test_gmres_givens_matches_the_reference_step(j):
    """The scalar work of step j (replay, new rotation, freeze of a system
    that already met its tolerance, ks, the flag) equals the reference's."""
    rng = np.random.default_rng(22 + j)
    h1 = np.zeros((MB, M + 1))
    h1[:, :j + 1] = rng.normal(size=(MB, j + 1))
    h2 = np.zeros((MB, M + 1))
    h2[:, :j + 1] = 1e-3 * rng.normal(size=(MB, j + 1))
    hj1 = np.array([0.7, 1.3])
    ang = rng.uniform(0, 2 * np.pi, (MB, M))
    cs, sn = np.cos(ang), np.sin(ang)
    cs[:, j:], sn[:, j:] = 0.0, 0.0
    R = rng.normal(size=(MB, M + 1, M))
    g = np.zeros((MB, M + 1))
    g[:, :j + 1] = rng.normal(size=(MB, j + 1))
    g[0, j] = 4.0
    tol = np.array([1e-2, 1e2])
    ks = np.array([j, max(j - 1, 0)])
    ref = _reference_step(h1, h2, hj1, R, g, cs, sn, ks, tol, j)

    wk = ko.gmres_work(MB, 4, M, torch.float64, "cpu")
    for name, v in (("h1", h1), ("h2", h2), ("hj1", hj1), ("R", R), ("g", g), ("cs", cs),
                    ("sn", sn), ("tol", tol)):
        getattr(wk, name).copy_(t64(v))
    wk.ks.copy_(torch.as_tensor(ks, dtype=torch.int32))
    ko.gmres_givens_plain(wk, j)
    for got, want in zip((wk.R, wk.g, wk.cs, wk.sn), ref[:4]):
        assert np.array_equal(got.numpy(), want)
    assert wk.ks.tolist() == ref[4].tolist() == [j + 1, max(j - 1, 0)]
    assert bool(wk.flag) == ref[5]


def test_gmres_solve_update_matches_jax():
    """y from R[:ks, :ks] y = g[:ks] per system (the JAX masked solve of
    :445-450) and x += y^T V[:m] (:451)."""
    rng = np.random.default_rng(23)
    V = _basis(rng, M)
    wk = _work(V)
    R = rng.normal(size=(MB, M + 1, M)) + 4.0 * np.eye(M + 1, M)[None]
    g = rng.normal(size=(MB, M + 1))
    ks = np.array([5, 2])
    wk.R.copy_(t64(R))
    wk.g.copy_(t64(g))
    wk.ks.copy_(torch.as_tensor(ks, dtype=torch.int32))
    x = rng.normal(size=(MB, N))
    got = ko.gmres_solve_update(wk, t64(x))
    used = np.arange(M)[None, :] < ks[:, None]
    Rm = np.where(used[:, None, :] & used[:, :, None], R[:, :M, :M], np.eye(M)[None])
    gm = np.where(used, g[:, :M], 0.0)
    y = np.stack([np.asarray(jsl.solve_triangular(jnp.asarray(a), jnp.asarray(b), lower=False))
                  for a, b in zip(Rm, gm)])
    assert rel(wk.y, y) < 1e-14
    assert rel(got, x + np.einsum("sk,skn->sn", y, V[:, :M])) < 1e-14


def _step_case(rng, mb, n, j, frozen):
    """Arnoldi step j's inputs in the JAX layout: a (mb, m+1, n) basis with
    rows 0..j populated, the matvec's w, and the cycle's scalars after j
    steps (system 1, or system 0 when mb = 1, frozen: |g[:, j]| below its
    tolerance)."""
    V = np.zeros((mb, M + 1, n))
    V[:, :j + 1] = rng.normal(size=(mb, j + 1, n))
    w = rng.normal(size=(mb, n))
    ang = rng.uniform(0, 2 * np.pi, (mb, M))
    cs, sn = np.cos(ang), np.sin(ang)
    cs[:, j:], sn[:, j:] = 0.0, 0.0
    R = rng.normal(size=(mb, M + 1, M))
    g = np.zeros((mb, M + 1))
    g[:, :j + 1] = rng.normal(size=(mb, j + 1))
    g[:, j] = 4.0
    tol = np.full(mb, 1e-2)
    if frozen:
        tol[min(1, mb - 1)] = 1e2
    ks = np.full(mb, j)
    return V, w, R, g, cs, sn, tol, ks


def _step_work(V, R, g, cs, sn, tol, ks):
    mb, _, n = V.shape
    wk = ko.gmres_work(mb, n, M, torch.float64, "cpu")
    wk.V.copy_(t64(np.swapaxes(V, 0, 1)))
    for name, v in (("R", R), ("g", g), ("cs", cs), ("sn", sn), ("tol", tol)):
        getattr(wk, name).copy_(t64(v))
    wk.ks.copy_(torch.as_tensor(ks, dtype=torch.int32))
    return wk


# (mb, a frozen system): one live system, one frozen, three with one frozen
STEP_CASES = {"mb1": (1, False), "mb1_frozen": (1, True), "mb3_frozen": (3, True)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
@pytest.mark.parametrize("j", [0, 3, M - 1])
def test_gmres_arnoldi_plain_matches_jax(case, j):
    """One Arnoldi step's plain version against the JAX body
    (knpemidg_tpu/solvers/krylov.py:385-439): CGS2 over the whole basis,
    hj1, V[j+1] (zero for a frozen system), the replayed and new rotations,
    g, R and ks with the freeze, and the flag; float64 to rel 1e-13."""
    mb, frozen = STEP_CASES[case]
    rng = np.random.default_rng(40 + j + 10 * mb + frozen)
    V, w, R, g, cs, sn, tol, ks = _step_case(rng, mb, N, j, frozen)
    Vj, wj = jnp.asarray(V), jnp.asarray(w)
    h1j = jnp.einsum("skn,sn->sk", Vj, wj)
    wj = wj - jnp.einsum("sk,skn->sn", h1j, Vj)
    h2j = jnp.einsum("skn,sn->sk", Vj, wj)
    wj = wj - jnp.einsum("sk,skn->sn", h2j, Vj)
    hj1 = jnp.sqrt(jnp.einsum("sn,sn->s", wj, wj))
    vnext = jnp.where((hj1 > 1e-300)[:, None], wj / jnp.where(hj1 > 0, hj1, 1.0)[:, None], 0.0)
    live = np.abs(g[:, j]) > tol
    vnext = np.where(live[:, None], np.asarray(vnext), 0.0)
    ref = _reference_step(np.asarray(h1j), np.asarray(h2j), np.asarray(hj1), R, g, cs, sn, ks,
                          tol, j)

    wk = _step_work(V, R, g, cs, sn, tol, ks)
    assert ko.gmres_arnoldi_plain(t64(w), wk, j) is wk
    assert rel(wk.h1, h1j) < 1e-13 and rel(wk.h2, h2j) < 1e-13
    assert rel(wk.hj1, hj1) < 1e-13 and rel(wk.V[j + 1], vnext) < 1e-13
    assert bool(live.all()) == bool(wk.V[j + 1].any(dim=1).all())
    for got, want in zip((wk.R, wk.g, wk.cs, wk.sn), ref[:4]):
        assert rel(got, want) < 1e-13
    assert wk.ks.tolist() == ref[4].tolist() and bool(wk.flag) == ref[5]


@pytest.mark.parametrize("n,j", [(N, 0), (2049, 3), (3 * 2048 + 17, M - 1)])
def test_gmres_arnoldi_ordered_plain_matches_plain(n, j):
    """The kernel's summation order (the projections and the norm as the
    dot kernels sum, the updates left to right over the populated rows)
    against the whole-basis plain step, float64, to 1e-14, on one and on
    several chunks; the wrapper's CPU path is the plain step, bit for
    bit."""
    rng = np.random.default_rng(50 + j)
    V, w, R, g, cs, sn, tol, ks = _step_case(rng, 3, n, j, True)
    a, b, c = (_step_work(V, R, g, cs, sn, tol, ks) for _ in range(3))
    wa, wb, wc = t64(w), t64(w), t64(w)
    ko.gmres_arnoldi_ordered_plain(wa, a, j)
    ko.gmres_arnoldi_plain(wb, b, j)
    ko.gmres_arnoldi(wc, c, j)
    rows = j + 1
    assert rel(a.h1[:, :rows], b.h1[:, :rows]) < 1e-14
    assert rel(a.h2[:, :rows], b.h2[:, :rows]) < 1e-14
    assert rel(a.hj1, b.hj1) < 1e-14 and rel(a.V[j + 1], b.V[j + 1]) < 1e-14
    assert rel(wa, wb) < 1e-14
    for name in ("R", "g", "cs", "sn"):
        assert rel(getattr(a, name), getattr(b, name)) < 1e-14, name
    assert torch.equal(a.ks, b.ks) and torch.equal(a.flag, b.flag)
    for name in ko.GmresWork._fields[:13]:                 # the buffers, not the partials
        assert torch.equal(getattr(b, name), getattr(c, name)), name
    assert torch.equal(wb, wc)


@pytest.mark.parametrize("n,mb", [(1, 32), (N, 2), (2049, 3), (3 * 2048 + 17, 2)])
def test_gmres_start_ordered_plain_matches_plain(n, mb):
    """The start kernel's summation order (beta as the dot kernels sum)
    against gmres_start_plain, float64, to 1e-14, on one and on several
    chunks, with a system at zero (beta 0, V[0] zero): beta, V[0], g = beta
    e1 and the flag; the scalars zeroed; the rows of V after the first
    left as they were (the kernel writes only row 0).  The wrapper's CPU
    path is the plain start, bit for bit."""
    rng = np.random.default_rng(60 + mb)
    r = t64(rng.normal(size=(mb, n)))
    r[-1] = 0.0
    a, b, c = (ko.gmres_work(mb, n, M, torch.float64, "cpu") for _ in range(3))
    tol = t64(rng.uniform(0.0, 2.0, mb) * np.sqrt(n))
    for wk in (a, b, c):
        wk.tol.copy_(tol)
        for name in ("R", "g", "cs", "sn", "ks"):
            getattr(wk, name).fill_(7)
    a.V.fill_(3.0)
    ko.gmres_start_ordered_plain(r, a)
    ko.gmres_start_plain(r, b)
    ko.gmres_start(r, c)
    assert rel(a.beta, b.beta) < 1e-14 and float(a.beta[-1]) == 0.0
    assert rel(a.V[0], b.V[0]) < 1e-14 and not a.V[0, -1].any()
    assert bool((a.V[1:] == 3.0).all())
    assert rel(a.g, b.g) < 1e-14 and torch.equal(a.flag, b.flag)
    for name in ("R", "cs", "sn", "ks"):
        assert not getattr(a, name).any(), name
    for name in ko.GmresWork._fields[:13]:
        assert torch.equal(getattr(b, name), getattr(c, name)), name


@pytest.mark.parametrize("n", [1, 2048, 2049, 497664])
def test_gmres_work_sizes_the_workspace(n):
    """The partials of the step's three sums, (2m + 1) mb per RED_CHUNK-entry
    chunk in the work's dtype; no launch shape on the CPU (the card's is
    sized by the kernel's grid entry); a restart beyond the kernel's rows
    refused."""
    wk = ko.gmres_work(3, n, M, torch.float32, "cpu")
    assert wk.partial.shape == ((2 * M + 1) * 3 * -(-n // 2048),)
    assert wk.partial.dtype == torch.float32
    assert (wk.grid, wk.upb, wk.staged) == (0, 0, 0)
    assert wk.V.shape == (M + 1, 3, n) and not wk.V.any()
    with pytest.raises(NotImplementedError):
        ko.gmres_work(3, n, ko.MAX_RESTART + 1, torch.float32, "cpu")


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_pcg_entries_match_the_formulas(mode):
    """alpha, the projected updates (none, the mean, the masked mean),
    rz / zz / beta / the flag and the direction in one entry
    (krylov.py:101-111), on a live work (flag 1)."""
    rng = np.random.default_rng(24)
    shape = (4, 300)
    x, r, p, Ap, z = (rng.normal(size=shape) for _ in range(5))
    w = (rng.uniform(size=shape) > 0.3).astype(np.float64)
    wsum = w.sum() if mode == 2 else float(x.size)
    wk = ko.PcgWork(sc=t64([1.7, 2.0, 0.0, 0.0, 1e-30, wsum]),
                    flag=torch.ones(1, dtype=torch.int32), w=t64(w) if mode == 2 else None,
                    mode=mode)
    ko.pcg_dot(t64(p), t64(Ap), wk)
    alpha = 1.7 / np.vdot(p, Ap)
    assert rel(wk.sc[ko.ALPHA], alpha) < 1e-15

    def proj(v):
        if mode == 1:
            return v - v.mean()
        if mode == 2:
            return (v - np.sum(v * w) / wsum) * w
        return v

    xt, rt = ko.pcg_update(t64(x), t64(r), t64(p), t64(Ap), wk)
    assert rel(xt, proj(x + alpha * p)) < 1e-14 and rel(rt, proj(r - alpha * Ap)) < 1e-14
    pt = t64(p)
    assert ko.pcg_dot2_direction(t64(r), t64(z), pt, wk) is wk
    rz = np.vdot(r, z)
    assert rel(wk.sc[ko.RZ], rz) < 1e-14 and rel(wk.sc[ko.ZZ], np.vdot(z, z)) < 1e-14
    assert rel(wk.sc[ko.BETA], rz / 1.7) < 1e-14 and int(wk.flag) == 1
    assert rel(pt, z + (rz / 1.7) * p) < 1e-14


@pytest.mark.parametrize("shape,above", [((4, 300), True), ((8, 2049), False),
                                         ((3 * 2048 + 17,), True)])
def test_pcg_dot2_direction_plain_matches_the_jax_body(shape, above):
    """The fused entry's plain version against the JAX loop body
    (knpemidg_tpu/solvers/krylov.py:107-111): rz_new = r . z, beta =
    rz_new / rz, p = z + beta p, zz = z . z, and the carried test zz >
    tol^2 on either side of the tolerance; p is updated in place, alpha,
    tol^2 and wsum are left as they were.  rz_new and beta are held to
    1e-14 of the sum of |r z| (the dots add in another order), p to 1e-14
    of |z| + (|beta| + that bound on beta) |p| elementwise.  The work is
    live (flag 1) with no iteration cap, so the flag is the tolerance test
    alone and the count goes to 1."""
    rng = np.random.default_rng(30)
    r, z, p = (rng.normal(size=shape) for _ in range(3))
    rz = 1.3
    rj, zj, pj = (jnp.asarray(v) for v in (r, z, p))
    rz_new = jkry._dot(rj, zj)
    beta = rz_new / rz
    p_new = zj + beta * pj
    zz = jkry._dot(zj, zj)
    tol2 = float(zz) * (0.5 if above else 2.0)
    sc = [rz, 0.0, 0.25, 0.0, tol2, float(r.size)]
    wk = ko.pcg_work(t64(sc), torch.ones(1, dtype=torch.int32), None, 1, r.size)
    pt = t64(p)
    assert ko.pcg_dot2_direction_plain(t64(r), t64(z), pt, wk) is wk
    assert wk.iters.tolist() == [1]
    # the dots in another order: round-off against their sums of |terms|
    rz_abs = np.abs(r * z).sum()
    assert abs(float(wk.sc[ko.RZ]) - float(rz_new)) < 1e-14 * rz_abs
    assert abs(float(wk.sc[ko.BETA]) - float(beta)) < 1e-14 * rz_abs / rz
    assert rel(wk.sc[ko.ZZ], zz) < 1e-14
    # p: its own round-off and beta's, elementwise
    bound = 1e-14 * (np.abs(z) + (abs(float(beta)) + rz_abs / rz) * np.abs(p))
    assert np.all(np.abs(to_np(pt) - np.asarray(p_new)) <= bound)
    assert int(wk.flag) == int(above)
    assert wk.sc[[ko.ALPHA, ko.TOL2, ko.WSUM]].tolist() == [0.25, tol2, float(r.size)]


def _system(rng, nc=240, K=4, m=2, nd=4):
    nbr = np.vstack([np.arange(nc), rng.integers(0, nc, size=(K - 1, nc))]).astype(np.int32)
    B = rng.normal(size=(m, K, nd, nd, nc)) * 0.05
    B[:, 0, range(nd), range(nd), :] += 3.0
    return B, nbr


# (restart, rtol, b_ref, system 0's dominance): several restart cycles, a
# reference rhs for the tolerance, uneven convergence (system 0 frozen
# while system 1 steps on)
GMRES_CASES = {"restarts": (4, 1e-10, False, 1.0), "b_ref": (6, 1e-8, True, 1.0),
               "frozen": (12, 1e-9, False, 30.0)}


@pytest.mark.parametrize("case", sorted(GMRES_CASES))
def test_gmres_batched_through_the_wrappers_matches_jax(case):
    restart, rtol, use_ref, dom = GMRES_CASES[case]
    rng = np.random.default_rng(25)
    B, nbr = _system(rng)
    B[0, 0] *= dom
    b = rng.normal(size=(2, 4, B.shape[-1]))
    bref = b + rng.normal(size=b.shape) if use_ref else None
    prec = lambda r: r * 0.3
    rj = jkry.gmres_batched(lambda V: jbmm(jnp.asarray(B), jnp.asarray(nbr), V),
                            jnp.asarray(b), jnp.zeros(b.shape), prec, rtol=rtol, atol=0.0,
                            max_it=400, restart=restart,
                            b_ref=None if bref is None else jnp.asarray(bref))
    nbr_t = torch.as_tensor(nbr)
    rt = krylov.gmres_batched(lambda V: bell_matvec_multi(t64(B), nbr_t, V), t64(b),
                              torch.zeros(b.shape, dtype=torch.float64), prec, rtol=rtol,
                              atol=0.0, max_it=400, restart=restart,
                              b_ref=None if bref is None else t64(bref))
    assert rt.converged and bool(np.all(np.asarray(rj.converged)))
    assert rt.iters == np.asarray(rj.iters).tolist()
    assert rel(rt.x, rj.x) < 1e-10
    assert rel(rt.resnorm, rj.resnorm) < 1e-6
    if case == "frozen":
        assert rt.iters[0] < rt.iters[1]
    if case == "restarts":
        assert max(rt.iters) > restart


def _ring(rng, nc, nd=4):
    """A singular SPD cell-ring operator (constants its null mode)."""
    nbr = np.vstack([np.arange(nc), (np.arange(nc) + 1) % nc,
                     (np.arange(nc) - 1) % nc]).astype(np.int32)
    B = np.zeros((3, nd, nd, nc))
    wts = rng.uniform(0.5, 1.5, nc)
    for i in range(nd):
        B[1, i, i] = -wts
        B[2, i, i] = -np.roll(wts, 1)
        B[0, i, i] = wts + np.roll(wts, 1)
    B[0] += (np.eye(nd) - 1.0 / nd)[..., None] * rng.uniform(0.5, 1.0, nc)
    return B, nbr


def test_pcg_masked_projection_matches_jax():
    """The pair layout's masked projection: inert padded cells (identity
    rows, outside the ring) carry no constant mode; the projection averages
    over the real cells and zeroes the pads, and the preconditioner is
    masked as the solver masks it."""
    rng = np.random.default_rng(26)
    nc, nd, npad = 160, 4, 16
    Br, nbr_r = _ring(rng, nc, nd)
    ntot = nc + npad
    B = np.zeros((3, nd, nd, ntot))
    B[..., :nc] = Br
    B[0, range(nd), range(nd), nc:] = 1.0
    nbr = np.vstack([np.arange(ntot)] * 3).astype(np.int32)
    nbr[:, :nc] = nbr_r
    mask = np.zeros((nd, ntot), dtype=bool)
    mask[:, :nc] = True
    b = rng.normal(size=(nd, ntot)) * mask
    dinv = 1.0 / np.diagonal(B[0] + 0.1 * np.eye(nd)[..., None], axis1=0, axis2=1).T
    rj = jkry.pcg(lambda v: jbm(jnp.asarray(B), jnp.asarray(nbr), v), jnp.asarray(b),
                  jnp.zeros((nd, ntot)), lambda r: jnp.asarray(dinv * mask) * r, rtol=1e-10,
                  atol=0.0, max_it=500, project_nullspace=True,
                  nullspace_mask=jnp.asarray(mask))
    mt = torch.as_tensor(mask)
    rt = krylov.pcg(lambda v: bell_matvec(t64(B), torch.as_tensor(nbr), v), t64(b),
                    torch.zeros(nd, ntot, dtype=torch.float64),
                    lambda r: t64(dinv * mask) * r, rtol=1e-10, atol=0.0, max_it=500,
                    project_nullspace=True, nullspace_mask=mt)
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    assert rel(rt.x, rj.x) < 1e-10
    assert not rt.x[:, nc:].any()


def test_pcg_without_projection_matches_jax():
    """An SPD system without the nullspace projection (the flag carried in
    the work, the direction updated in place)."""
    rng = np.random.default_rng(27)
    B, nbr = _ring(rng, 200)
    B[0, range(4), range(4), :] += 0.5                 # nonsingular
    b = rng.normal(size=(4, 200))
    dinv = 1.0 / np.diagonal(B[0], axis1=0, axis2=1).T
    rj = jkry.pcg(lambda v: jbm(jnp.asarray(B), jnp.asarray(nbr), v), jnp.asarray(b),
                  jnp.zeros((4, 200)), lambda r: jnp.asarray(dinv) * r, rtol=1e-11,
                  atol=0.0, max_it=500)
    rt = krylov.pcg(lambda v: bell_matvec(t64(B), torch.as_tensor(nbr), v), t64(b),
                    torch.zeros(4, 200, dtype=torch.float64), lambda r: t64(dinv) * r,
                    rtol=1e-11, atol=0.0, max_it=500)
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    assert rel(rt.x, rj.x) < 1e-10


# entry counts around the kernels' chunk of 2048 and a finish over 4 chunks
ORDERED_SIZES = [1, 255, 2048, 2049, 3 * 2048 + 17]


@pytest.mark.parametrize("n", ORDERED_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nprod", [1, 2])
def test_pcg_dots_ordered_plain_matches_dot(n, dtype, nprod):
    """The kernels' summation order (chunks, strided thread sums, the block
    tree, then the chunk sums) adds every product once: against numpy's
    float64 dot to within the recursive-summation bound of that order,
    (8 + 5 + 7 + ceil(chunks / 256) + 5 + 7 + 1) eps sum |terms|, and
    against torch.dot in float64 to round-off."""
    rng = np.random.default_rng(28 + n)
    vecs = [torch.as_tensor(rng.normal(size=(n,)), dtype=dtype) for _ in range(2 * nprod)]
    got = ko.pcg_dots_ordered_plain(*vecs)
    assert got.shape == (nprod,) and got.dtype == dtype
    nblk = -(-n // ko.RED_CHUNK)
    depth = 8 + 5 + 7 + -(-nblk // 256) + 5 + 7 + 1
    for k in range(nprod):
        a, b = (v.double().numpy() for v in vecs[2 * k:2 * k + 2])
        bound = depth * torch.finfo(dtype).eps * np.abs(a * b).sum()
        assert abs(float(got[k]) - np.dot(a, b)) <= bound
        if dtype == torch.float64:
            assert abs(float(got[k]) - float(torch.dot(vecs[2 * k], vecs[2 * k + 1]))) <= bound


def test_pcg_dots_ordered_plain_is_exact_on_integers():
    """Integer-valued products whose partial sums stay exact: every entry
    counted once, in every chunk and lane."""
    n = 5 * 2048 + 333
    a = torch.arange(n, dtype=torch.float64) % 97
    b = torch.arange(n, dtype=torch.float64) % 13 - 6
    c = torch.ones(n, dtype=torch.float32)
    got = ko.pcg_dots_ordered_plain(a, b, c, c)
    assert float(got[0]) == float((a * b).sum()) and float(got[1]) == n


@pytest.mark.parametrize("n", [1, 2048, 2049, 497664])
def test_pcg_work_sizes_the_workspace(n):
    """Two block sums per RED_CHUNK-entry chunk, in sc's dtype, a zero
    int32 ticket and a zero int32 iteration count; no iteration cap unless
    one is given."""
    sc = torch.zeros(6, dtype=torch.float32)
    wk = ko.pcg_work(sc, torch.zeros(1, dtype=torch.int32), None, 1, n)
    assert wk.partial.shape == (2 * -(-n // 2048),) and wk.partial.dtype == torch.float32
    assert wk.ticket.dtype == torch.int32 and wk.ticket.tolist() == [0]
    assert wk.iters.dtype == torch.int32 and wk.iters.tolist() == [0]
    assert wk.max_it == ko.MAX_ITERS
    assert ko.pcg_work(sc, torch.zeros(1, dtype=torch.int32), None, 1, n, 7).max_it == 7
    assert wk.sc is sc and wk.mode == 1 and wk.w is None


PCG_WORK_REFUSALS = {
    "sc_shape": (lambda sc, fl, w: (sc[:5], fl, None, 1), ValueError),
    "sc_dtype": (lambda sc, fl, w: (sc.to(torch.int64), fl, None, 1), ValueError),
    "flag_dtype": (lambda sc, fl, w: (sc, fl.to(torch.int64), None, 1), TypeError),
    "mode2_without_w": (lambda sc, fl, w: (sc, fl, None, 2), ValueError),
    "w_size": (lambda sc, fl, w: (sc, fl, w[:-1], 2), ValueError),
    "mode": (lambda sc, fl, w: (sc, fl, None, 3), ValueError),
}


@pytest.mark.parametrize("case", sorted(PCG_WORK_REFUSALS))
def test_pcg_work_refuses_what_the_kernels_cannot_take(case):
    make, exc = PCG_WORK_REFUSALS[case]
    sc = torch.zeros(6, dtype=torch.float64)
    fl = torch.zeros(1, dtype=torch.int32)
    w = torch.ones(40, dtype=torch.float64)
    with pytest.raises(exc):
        ko.pcg_work(*make(sc, fl, w), 40)
