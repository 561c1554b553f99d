"""The vector and scalar work of the Krylov loops, kernels K8 (the PCG
iteration, ``csrc/pcg.cu``) and K9 (the batched GMRES cycle,
``csrc/gmres.cu``), with the loops' scalars held on the device.

K9 keeps the Krylov basis rows first, ``V (m+1, mb, n)``, so row j of all
systems is one contiguous slab the matvec takes as it is.  The kernels read
only the populated rows 0..j; no kernel reads a row it has not written, so
:func:`gmres_work` allocates V with ``torch.empty`` on the card.  The plain
versions (``*_plain``) keep the whole-basis einsums of the reference and a
zeroed basis (:func:`gmres_start_plain` zeroes it every cycle), so the CPU
tests hold the populated-rows kernels to the full-basis semantics.  An
Arnoldi step (CGS2, the next basis row and the Givens work) is one
cooperative launch (:func:`gmres_arnoldi`), and so is the cycle's start
(:func:`gmres_start`); its entries work in the workspace and on the launch
shape :func:`gmres_work` builds once per solve, so they allocate nothing
and check only the vectors they are given, and
:func:`gmres_arnoldi_ordered_plain` and :func:`gmres_start_ordered_plain`
replay their summation orders in torch.  The Arnoldi step (kernel and
plain twins) reads the work's flag first and writes nothing where it is 0,
so the loop may queue a step before it has read the flag of the one
before.  The cycle's end (:func:`gmres_solve_update`: the triangular solve
and the update) is one launch, bitwise
:func:`gmres_solve_update_ordered_plain`.

K8 keeps ``sc = [rz, zz, alpha, beta, tol^2, wsum]`` (:data:`RZ` ...), the
iteration count and an int32 flag (zz > tol^2 and count < max_it: the JAX
while-loop's test) on the device.  Every K8 entry reads the flag first and
writes nothing where it is 0, so the loop may queue an iteration before it
has read the flag of the one before (``solvers/krylov.pcg``).  Its entries
work in the workspace :func:`pcg_work` allocates once per solve, so they
allocate nothing and read nothing back; the update with its projection,
and the second dot with the direction update, are one cooperative launch
each (:func:`pcg_update`, :func:`pcg_dot2_direction`) on a grid that
:func:`pcg_work` sizes once.

Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for CUDA tensors; there is no fallback between the two.  Every sum
of the kernels is a fixed-order reduction (no floating-point atomics).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _cuda

RED_CHUNK = 2048      # entries a reduction block of the kernels covers
MAX_RESTART = 63      # csrc/gmres.cu GM_MAX_ROWS - 1
MAX_SYSTEMS = 32      # csrc/gmres.cu GM_MAX_SYS: systems of a batch on the card
RZ, ZZ, ALPHA, BETA, TOL2, WSUM = range(6)    # slots of the PCG scalars
MAX_ITERS = 2 ** 31 - 1   # the int32 count's cap: a PCG without an iteration cap


def _nblk(n):
    return -(-n // RED_CHUNK)


# ---------------------------------------------------------------------------
# K9: batched GMRES
# ---------------------------------------------------------------------------

class GmresWork(NamedTuple):
    """Basis, scalars and reduction workspace of one batched GMRES solve (mb
    systems of n entries, restart m), built once per solve by
    :func:`gmres_work`."""
    V: torch.Tensor       # (m+1, mb, n) Krylov basis, rows first
    h1: torch.Tensor      # (mb, m+1) first CGS projection
    h2: torch.Tensor      # (mb, m+1) second CGS projection
    hj1: torch.Tensor     # (mb,) norm of the orthogonalised vector
    beta: torch.Tensor    # (mb,) residual norm at the cycle's start
    tol: torch.Tensor     # (mb,) absolute tolerance per system
    R: torch.Tensor       # (mb, m+1, m) rotated Hessenberg columns
    g: torch.Tensor       # (mb, m+1) rotated beta e1
    cs: torch.Tensor      # (mb, m) stored rotations
    sn: torch.Tensor      # (mb, m)
    ks: torch.Tensor      # (mb,) int32 steps of each system in the cycle
    y: torch.Tensor       # (mb, m) least-squares coefficients
    flag: torch.Tensor    # (1,) int32: some system is still above its tolerance
    # the kernels' reduction partials, ((2m + 1) mb ceil(n / RED_CHUNK),):
    # the Arnoldi step's first dot, second dot and norm; the start and the
    # tolerance dot use the first part
    partial: "torch.Tensor | None" = None
    # ((m+1) mb,) int32 release tickets of the tolerance dot's sums, one a
    # row and system, 0 between launches
    ticket: "torch.Tensor | None" = None
    # the cooperative launch of the Arnoldi step and of the cycle's start
    # (on the card): its blocks, the RED_CHUNK-entry chunks a block takes,
    # and 1 where the blocks keep their chunks of w (the start's: of r) in
    # shared memory (0: they are read again from device memory)
    grid: int = 0
    upb: int = 0
    staged: int = 0

    @property
    def m(self):
        return self.cs.shape[1]


def gmres_work(mb: int, n: int, m: int, dtype, device) -> GmresWork:
    """Buffers of a solve, with the kernels' partials.  On the card V is
    left unwritten (the kernels read only rows they wrote) and the launch
    shape of the Arnoldi step and the cycle's start is sized once
    (``knp_gmres_arnoldi_grid``, which also raises both kernels'
    shared-memory limits where the shape needs more than 48 KB); on the
    CPU V is zeroed, as the plain versions' whole-basis einsums need.  The
    entries then allocate nothing and check only the vectors they are
    given.  The flag starts live (1); :func:`gmres_start` writes it."""
    if m > MAX_RESTART:
        raise NotImplementedError(f"gmres: restart above {MAX_RESTART} is not supported")
    dev = torch.device(device)
    if dev.type == "cuda" and mb > MAX_SYSTEMS:
        raise NotImplementedError(f"gmres: more than {MAX_SYSTEMS} systems in one batch")
    new = torch.empty if dev.type == "cuda" else torch.zeros
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    shape = (0, 0, 0)
    if dev.type == "cuda":
        out = (ctypes.c_int * 3)()
        _cuda.call("knp_gmres_arnoldi_grid", dtype, mb, n, m, ctypes.addressof(out))
        shape = tuple(out)
    return GmresWork(V=new((m + 1, mb, n), dtype=dtype, device=dev), h1=z(mb, m + 1),
                     h2=z(mb, m + 1), hj1=z(mb), beta=z(mb), tol=z(mb), R=z(mb, m + 1, m),
                     g=z(mb, m + 1), cs=z(mb, m), sn=z(mb, m),
                     ks=torch.zeros(mb, dtype=torch.int32, device=dev), y=z(mb, m),
                     flag=torch.ones(1, dtype=torch.int32, device=dev),
                     partial=torch.empty((2 * m + 1) * mb * _nblk(n), dtype=dtype, device=dev),
                     ticket=torch.zeros((m + 1) * mb, dtype=torch.int32, device=dev),
                     grid=shape[0], upb=shape[1], staged=shape[2])


def gmres_cgs_dot_plain(V, w, rows, out):
    """out[:, :R] = the projections of w (mb, n) on every basis row of V
    (R, mb, n); rows beyond the populated ``rows`` are zero rows of V."""
    out[:, :V.shape[0]] = torch.einsum("ksn,sn->sk", V, w)
    return out


def gmres_cgs_dot_ordered_plain(V, w, rows, out):
    """:func:`gmres_cgs_dot_plain` over the populated rows with each sum in
    the dot kernel's order (:func:`_ordered_sums`), so the kernel equals it
    to the last bit; out beyond ``rows`` is left as it is.  For the tests
    and chip_smoke.py; the wrapper's CPU path keeps the einsum."""
    mb, n = w.shape
    Vs = V[:rows].transpose(0, 1).reshape(mb * rows, n)
    ws = w[:, None].expand(mb, rows, n).reshape(mb * rows, n)
    out[:, :rows] = _ordered_sums(Vs, ws).reshape(mb, rows)
    return out


def gmres_cgs_update_plain(V, w, h, rows):
    """w -= sum_k h[:, k] V[k] over the whole basis, in place."""
    return w.sub_(torch.einsum("sk,ksn->sn", h[:, :V.shape[0]], V))


def _norms(v):
    return torch.sqrt(torch.einsum("sn,sn->s", v, v))


def gmres_start_plain(r, wk: GmresWork):
    """The cycle's start: beta = ||r||, the basis zeroed with V[0] = r /
    beta, the scalars zeroed with g = beta e1, and the flag any beta > tol."""
    beta = _norms(r)
    wk.beta.copy_(beta)
    wk.V.zero_()
    wk.V[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))[:, None]
    for t in (wk.R, wk.g, wk.cs, wk.sn, wk.ks):
        t.zero_()
    wk.g[:, 0] = beta
    wk.flag.fill_(int(bool(torch.any(beta > wk.tol))))
    return wk


def gmres_start_ordered_plain(r, wk: GmresWork):
    """:func:`gmres_start_plain` with beta summed in the start kernel's
    order (:func:`_ordered_sums`), so the kernel equals it to the last bit;
    V[0] written, the other rows of V left as they are (the kernel writes
    only row 0).  For the tests and chip_smoke.py; the wrapper's CPU path
    keeps the einsum."""
    beta = torch.sqrt(_ordered_sums(r, r))
    wk.beta.copy_(beta)
    wk.V[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))[:, None]
    for t in (wk.R, wk.g, wk.cs, wk.sn, wk.ks):
        t.zero_()
    wk.g[:, 0] = beta
    wk.flag.fill_(int(bool(torch.any(beta > wk.tol))))
    return wk


def gmres_next_plain(w, wk: GmresWork, j):
    """hj1 = ||w|| and the next basis row V[j+1] (zero for a system whose
    residual estimate |g[:, j]| already met its tolerance)."""
    hj1 = _norms(w)
    wk.hj1.copy_(hj1)
    live = torch.abs(wk.g[:, j]) > wk.tol
    vnext = torch.where((hj1 > 1e-300)[:, None],
                        w / torch.where(hj1 > 0, hj1, torch.ones_like(hj1))[:, None],
                        torch.zeros_like(w))
    wk.V[j + 1] = torch.where(live[:, None], vnext, torch.zeros_like(w))
    return wk


def gmres_givens_plain(wk: GmresWork, j):
    """One Arnoldi step's scalar work (krylov.py:397-439 of the JAX
    package): the new Hessenberg column h1 + h2 with hj1 below it, the j
    stored rotations replayed, the new rotation, the freeze of systems that
    are no longer live, ks += live, and the flag any |g[:, j+1]| > tol."""
    m = wk.m
    gj = wk.g[:, j].clone()
    live = torch.abs(gj) > wk.tol
    h = wk.h1 + wk.h2
    h[:, j + 1:] = 0
    h[:, j + 1] = wk.hj1
    for i in range(j):
        c, s = wk.cs[:, i], wk.sn[:, i]
        hi = c * h[:, i] + s * h[:, i + 1]
        hi1 = -s * h[:, i] + c * h[:, i + 1]
        h[:, i] = hi
        h[:, i + 1] = hi1
    hj, hjp = h[:, j].clone(), h[:, j + 1].clone()
    denom = torch.sqrt(hj * hj + hjp * hjp)
    one, zero = torch.ones_like(denom), torch.zeros_like(denom)
    pos = denom > 0
    dsafe = torch.where(pos, denom, one)
    c_new = torch.where(live, torch.where(pos, hj / dsafe, one), one)
    s_new = torch.where(live, torch.where(pos, hjp / dsafe, zero), zero)
    wk.cs[:, j] = c_new
    wk.sn[:, j] = s_new
    h[:, j] = torch.where(live, denom, hj)
    h[:, j + 1] = 0
    wk.g[:, j + 1] = torch.where(live, -s_new * gj, zero)
    wk.g[:, j] = torch.where(live, c_new * gj, gj)
    wk.R[:, :, j] = torch.where(live[:, None], h[:, :m + 1], wk.R[:, :, j])
    wk.ks.add_(live.to(torch.int32))
    wk.flag.fill_(int(bool(torch.any(torch.abs(wk.g[:, j + 1]) > wk.tol))))
    return wk


def gmres_arnoldi_plain(w, wk: GmresWork, j):
    """Arnoldi step j after w = A V[j]: CGS2 over the whole basis (h1, h2;
    w orthogonalised in place), hj1 and V[j+1], then the scalar work --
    the composition of the ``*_plain`` steps (knpemidg_tpu/solvers/
    krylov.py:385-439); nothing written where the flag is 0 (a step queued
    after the loop's exit); returns wk."""
    if not bool(wk.flag):
        return wk
    rows = j + 1
    gmres_cgs_dot_plain(wk.V, w, rows, wk.h1)
    gmres_cgs_update_plain(wk.V, w, wk.h1, rows)
    gmres_cgs_dot_plain(wk.V, w, rows, wk.h2)
    gmres_cgs_update_plain(wk.V, w, wk.h2, rows)
    gmres_next_plain(w, wk, j)
    return gmres_givens_plain(wk, j)


def gmres_arnoldi_ordered_plain(w, wk: GmresWork, j):
    """:func:`gmres_arnoldi_plain` with the sums in the order of the step
    kernel, to the last bit: each projection and the norm summed as the dot
    kernels sum (:func:`_ordered_sums`) over the populated rows 0..j only,
    each update h[0] V[0] + h[1] V[1] + ... left to right; the written
    outputs are h1[:, :j+1], h2[:, :j+1], hj1, V[j+1] and the scalar work's
    (:func:`gmres_givens_plain`).  w ends orthogonalised; nothing is written
    where the flag is 0.  For the tests and chip_smoke.py; the wrapper's
    CPU path keeps the einsums."""
    if not bool(wk.flag):
        return wk
    rows = j + 1
    mb, n = w.shape
    Vr = wk.V[:rows]
    Vs = Vr.transpose(0, 1).reshape(mb * rows, n)

    def dots(v):
        return _ordered_sums(Vs, v[:, None].expand(mb, rows, n).reshape(mb * rows, n)) \
            .reshape(mb, rows)

    def update(v, h):
        acc = h[:, :1] * Vr[0]
        for k in range(1, rows):
            acc = acc + h[:, k:k + 1] * Vr[k]
        return v - acc

    h1 = dots(w)
    w1 = update(w, h1)
    h2 = dots(w1)
    w2 = update(w1, h2)
    hj1 = torch.sqrt(_ordered_sums(w2, w2))
    wk.h1[:, :rows] = h1
    wk.h2[:, :rows] = h2
    wk.hj1.copy_(hj1)
    keep = (torch.abs(wk.g[:, j]) > wk.tol) & (hj1 > 1e-300)
    safe = torch.where(hj1 > 0, hj1, torch.ones_like(hj1))
    wk.V[j + 1] = torch.where(keep[:, None], w2 / safe[:, None], torch.zeros_like(w2))
    w.copy_(w2)
    return gmres_givens_plain(wk, j)


def gmres_solve_update_plain(wk: GmresWork, x):
    """y solves R[:ks, :ks] y = g[:ks] per system (zero beyond ks); then
    x += y^T V[:m] over the whole basis, in place."""
    wk.y.zero_()
    for s, k in enumerate(wk.ks.tolist()):
        if k:
            wk.y[s, :k] = torch.linalg.solve_triangular(
                wk.R[s, :k, :k], wk.g[s, :k, None], upper=True)[:, 0]
    return x.add_(torch.einsum("sk,ksn->sn", wk.y, wk.V[:wk.m]))


def gmres_solve_update_ordered_plain(wk: GmresWork, x):
    """:func:`gmres_solve_update_plain` in the kernel's order, to the last
    bit: per system of ks = k, y by back substitution (row r from the last,
    acc = g_r, acc -= R[r, l] y_l for l ascending, y_r = acc / R[r, r]),
    zero beyond k; then x = x + acc, acc = y_0 V[0] and += y_l V[l] for l =
    1 .. k - 1 in order over the populated rows; x untouched where k = 0.
    For the tests and chip_smoke.py; the wrapper's CPU path keeps the
    triangular solve and the einsum."""
    wk.y.zero_()
    for s, k in enumerate(wk.ks.tolist()):
        y = wk.y[s]
        for r in range(k - 1, -1, -1):
            acc = wk.g[s, r]
            for l in range(r + 1, k):
                acc = acc - wk.R[s, r, l] * y[l]
            y[r] = acc / wk.R[s, r, r]
        if k:
            acc = y[0] * wk.V[0, s]
            for l in range(1, k):
                acc = acc + y[l] * wk.V[l, s]
            x[s] = x[s] + acc
    return x


def _check_vec(wk: GmresWork, v):
    """What may change between calls of a K9 entry: the vector against the
    work (dtype, shape (mb, n), on the card, contiguous), one plain pass;
    the work and its workspace were checked by gmres_work.  The slow path
    names what is wrong."""
    if not (wk.grid > 0 and v.is_cuda and v.dtype == wk.V.dtype
            and v.shape == wk.V.shape[1:] and v.is_contiguous()):
        if wk.grid <= 0 or wk.partial is None:
            raise ValueError("gmres: the work has no card workspace; build it with gmres_work")
        _cuda.check("vector", v, wk.V.dtype, wk.V.shape[1:])


def gmres_cgs_dot(V, w, rows, out, wk: "GmresWork | None" = None):
    """out[:, :rows] = V[:rows] . w per system, the basis V (R, mb, n)
    populated in its first ``rows`` rows (one kernel launch on a CUDA
    tensor, its partials and tickets in the workspace of ``wk``, a work of
    the same mb and n from :func:`gmres_work`, which checked them; its
    outputs bitwise those of :func:`gmres_cgs_dot_ordered_plain`); returns
    out.  The vectors are checked against the work in one plain pass."""
    if not V.is_cuda:
        return gmres_cgs_dot_plain(V, w, rows, out)
    if not (wk is not None and wk.grid > 0 and wk.ticket is not None
            and V.dtype == w.dtype == out.dtype == wk.V.dtype and w.is_cuda and out.is_cuda
            and V.shape[1:] == w.shape == wk.V.shape[1:]
            and 1 <= rows <= min(V.shape[0], wk.V.shape[0])
            and out.dim() == 2 and out.shape[0] == w.shape[0] and out.shape[1] >= rows
            and V.is_contiguous() and w.is_contiguous() and out.is_contiguous()):
        _cgs_dot_refusal(V, w, rows, out, wk)
    mb, n = w.shape
    _cuda.launch("gmres_cgs_dot", "knp_gmres_dot", V.dtype, V.data_ptr(), w.data_ptr(),
                 wk.partial.data_ptr(), wk.ticket.data_ptr(), out.data_ptr(), mb, n, rows,
                 out.shape[1])
    return out


def _cgs_dot_refusal(V, w, rows, out, wk):
    """Raise the reason the dot kernel cannot take these operands."""
    if wk is None or wk.partial is None or wk.ticket is None or wk.grid <= 0:
        raise ValueError("gmres_cgs_dot: needs the workspace of a work from gmres_work")
    _cuda.check("V", V, wk.V.dtype)
    _cuda.check("w", w, wk.V.dtype, wk.V.shape[1:])
    if V.shape[1:] != w.shape:
        raise ValueError(f"gmres_cgs_dot: a basis of {tuple(V.shape[1:])} rows for w "
                         f"{tuple(w.shape)}")
    if not 1 <= rows <= min(V.shape[0], wk.V.shape[0]):
        raise ValueError(f"gmres: {rows} populated rows of a {V.shape[0]}-row basis "
                         f"(the work holds {wk.V.shape[0]})")
    _cuda.check("out", out, wk.V.dtype)
    raise ValueError("gmres_cgs_dot: out must be (mb, >= rows)")


def gmres_start(r, wk: GmresWork):
    """The cycle's start from the preconditioned residual r (mb, n): beta,
    V[0], the zeroed scalars and the flag (one cooperative kernel launch on
    a CUDA tensor, on the Arnoldi step's launch shape; its outputs bitwise
    those of :func:`gmres_start_ordered_plain`); returns wk."""
    if not r.is_cuda:
        return gmres_start_plain(r, wk)
    _check_vec(wk, r)
    mb, n = r.shape
    _cuda.launch("gmres_start", "knp_gmres_start", r.dtype, r.data_ptr(), wk.V.data_ptr(),
                 wk.partial.data_ptr(), wk.beta.data_ptr(), wk.tol.data_ptr(), wk.R.data_ptr(),
                 wk.g.data_ptr(), wk.cs.data_ptr(), wk.sn.data_ptr(), wk.ks.data_ptr(),
                 wk.flag.data_ptr(), mb, n, wk.m, wk.grid, wk.upb, wk.staged)
    return wk


def gmres_arnoldi(w, wk: GmresWork, j):
    """Arnoldi step j after w = A V[j] (mb, n): h1, h2, hj1, V[j+1], the
    rotations, the freeze, ks and the flag into wk (one cooperative kernel
    launch on a CUDA tensor; its outputs bitwise those of
    :func:`gmres_arnoldi_ordered_plain`).  On the card w is consumed: its
    contents afterwards are unspecified.  Returns wk."""
    if not w.is_cuda:
        return gmres_arnoldi_plain(w, wk, j)
    _check_vec(wk, w)
    if not 0 <= j < wk.m:
        raise ValueError(f"gmres_arnoldi: step {j} outside the restart {wk.m}")
    mb, n = w.shape
    _cuda.launch("gmres_arnoldi", "knp_gmres_arnoldi", w.dtype, wk.V.data_ptr(), w.data_ptr(),
                 wk.partial.data_ptr(), wk.h1.data_ptr(), wk.h2.data_ptr(), wk.hj1.data_ptr(),
                 wk.tol.data_ptr(), wk.R.data_ptr(), wk.g.data_ptr(), wk.cs.data_ptr(),
                 wk.sn.data_ptr(), wk.ks.data_ptr(), wk.flag.data_ptr(), mb, n, wk.m, j,
                 wk.grid, wk.upb, wk.staged)
    return wk


def gmres_solve_update(wk: GmresWork, x):
    """x (mb, n) += the cycle's correction, in place, and y into wk (one
    kernel launch on a CUDA tensor; its outputs bitwise those of
    :func:`gmres_solve_update_ordered_plain`); returns x."""
    if not x.is_cuda:
        return gmres_solve_update_plain(wk, x)
    _check_vec(wk, x)
    mb, n = x.shape
    _cuda.launch("gmres_solve_update", "knp_gmres_solve_update", x.dtype, wk.R.data_ptr(),
                 wk.g.data_ptr(), wk.ks.data_ptr(), wk.y.data_ptr(), wk.V.data_ptr(),
                 x.data_ptr(), mb, n, wk.m)
    return x


# ---------------------------------------------------------------------------
# K8: PCG
# ---------------------------------------------------------------------------

class PcgWork(NamedTuple):
    """Scalars, count, projection data and reduction workspace of one PCG
    solve (build it with :func:`pcg_work`)."""
    sc: torch.Tensor               # (6,) rz, zz, alpha, beta, tol^2, wsum
    flag: torch.Tensor             # (1,) int32: zz > tol^2 and iters < max_it
    w: "torch.Tensor | None"       # nullspace mask expanded to the vector shape (mode 2)
    mode: int                      # 0 no projection, 1 mean, 2 masked mean
    partial: "torch.Tensor | None" = None   # (2 ceil(n / RED_CHUNK),) the block sums
    ticket: "torch.Tensor | None" = None    # (1,) int32 blocks done, 0 between launches
    grid: int = 0                  # blocks of the cooperative launches (on the card)
    iters: "torch.Tensor | None" = None     # (1,) int32 live iterations so far
    max_it: int = MAX_ITERS        # the cap the flag holds the count to


def pcg_work(sc, flag, w, mode, n, max_it=None) -> PcgWork:
    """The work of a solve on n-entry vectors, checked once, with the
    kernels' partial sums (``torch.empty``), the int32 ticket and the
    iteration count (zero) on the device of ``sc``: the entries then
    allocate nothing.  ``flag`` is the loop's test before the first
    iteration (nonzero: live); ``max_it`` (default: no cap) is the cap the
    flag also holds the count to.  On the card it also sizes the grid of
    the cooperative update and dot2_direction launches: the chunks, at most
    the blocks that can be resident together (a cooperative launch needs
    them all)."""
    if mode not in (0, 1, 2):
        raise ValueError(f"pcg_work: mode {mode} is not 0, 1 or 2")
    if sc.dtype not in (torch.float32, torch.float64) or tuple(sc.shape) != (6,):
        raise ValueError(f"pcg_work: sc must be (6,) float32/float64, got "
                         f"{tuple(sc.shape)} {sc.dtype}")
    if flag.dtype != torch.int32 or tuple(flag.shape) != (1,):
        raise TypeError(f"pcg_work: flag must be (1,) int32, got {tuple(flag.shape)} "
                        f"{flag.dtype}")
    if mode == 2 and (w is None or w.dtype != sc.dtype or w.numel() != n):
        raise ValueError("pcg_work: mode 2 needs the mask w, n entries in sc's dtype")
    if any(t.device != sc.device or not t.is_contiguous()
           for t in [sc, flag] + ([w] if mode == 2 else [])):
        raise ValueError("pcg_work: sc, flag and w must be contiguous, on one device")
    max_it = MAX_ITERS if max_it is None else int(max_it)
    if not 0 <= max_it <= MAX_ITERS:
        raise ValueError(f"pcg_work: max_it {max_it} outside 0..{MAX_ITERS}")
    grid = 0
    if sc.is_cuda:
        g = ctypes.c_int(0)
        _cuda.call("knp_pcg_grid", sc.dtype, n, RED_CHUNK, ctypes.addressof(g))
        grid = g.value
    return PcgWork(sc=sc, flag=flag, w=w, mode=mode,
                   partial=torch.empty(2 * _nblk(n), dtype=sc.dtype, device=sc.device),
                   ticket=torch.zeros(1, dtype=torch.int32, device=sc.device), grid=grid,
                   iters=torch.zeros(1, dtype=torch.int32, device=sc.device), max_it=max_it)


def _frozen(wk: PcgWork):
    """The plain entries' freeze: the loop has exited (flag 0)."""
    return not bool(wk.flag)


def _proj_plain(v, wk: PcgWork):
    if wk.mode == 1:
        return v - torch.mean(v)
    if wk.mode == 2:
        return (v - torch.sum(v * wk.w) / wk.sc[WSUM]) * wk.w
    return v


def pcg_dot_plain(p, Ap, wk: PcgWork):
    """alpha = rz / (p . Ap); nothing written where the flag is 0."""
    if not _frozen(wk):
        wk.sc[ALPHA] = wk.sc[RZ] / torch.dot(p.reshape(-1), Ap.reshape(-1))
    return wk


def pcg_update_plain(x, r, p, Ap, wk: PcgWork):
    """x = proj(x + alpha p), r = proj(r - alpha Ap), in place; nothing
    written where the flag is 0."""
    if not _frozen(wk):
        alpha = wk.sc[ALPHA]
        x.copy_(_proj_plain(x + alpha * p, wk))
        r.copy_(_proj_plain(r - alpha * Ap, wk))
    return x, r


def pcg_dot2_plain(r, z, wk: PcgWork):
    """rz' = r . z, zz = z . z, beta = rz' / rz, rz = rz', iters += 1, and
    flag = zz > tol^2 and iters < max_it (the JAX while-loop's test)."""
    rz_new = torch.dot(r.reshape(-1), z.reshape(-1))
    wk.sc[BETA] = rz_new / wk.sc[RZ]
    wk.sc[RZ] = rz_new
    wk.sc[ZZ] = torch.dot(z.reshape(-1), z.reshape(-1))
    if wk.iters is not None:
        wk.iters.add_(1)
    live = bool(wk.sc[ZZ] > wk.sc[TOL2]) and (wk.iters is None or int(wk.iters) < wk.max_it)
    wk.flag.fill_(int(live))
    return wk


def pcg_direction_plain(p, z, wk: PcgWork):
    """p = z + beta p, in place."""
    return p.copy_(z + wk.sc[BETA] * p)


def pcg_dot2_direction_plain(r, z, p, wk: PcgWork):
    """:func:`pcg_dot2_plain`, then :func:`pcg_direction_plain`: rz, zz,
    beta, the count and the flag into wk, p = z + beta p in place; nothing
    written where the flag is 0.  Returns wk."""
    if not _frozen(wk):
        pcg_direction_plain(p, z, pcg_dot2_plain(r, z, wk))
    return wk


def _block_sums(v):
    """Per row of v (rows, 256): the sum a block of the kernels forms of one
    value per thread, each warp's xor-shuffle tree (16, 8, 4, 2, 1), then
    the 8 warps in index order (csrc/common.cuh knp_block_sum)."""
    v = v.reshape(-1, 8, 32)
    lane = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    acc = v[:, 0, 0]
    for k in range(1, 8):
        acc = acc + v[:, k, 0]
    return acc


def _thread_sums(v, rows):
    """Each thread t of ``rows`` blocks adds its values t + 256 k of the
    block's row of v, in order from zero; returns (rows, 256)."""
    v = v.reshape(rows, -1, 256)
    acc = torch.zeros((rows, 256), dtype=v.dtype, device=v.device)
    for k in range(v.shape[1]):
        acc = acc + v[:, k]
    return acc


def _ordered_sums(a, b):
    """sum_i a[r, i] b[r, i] for each row r of a, b (R, n), in the order of
    the dot kernels, to the last bit: RED_CHUNK-entry chunks, thread t of a
    chunk's block adding its products t + 256 k in order, the block tree,
    then the chunk sums the same way in one block.  Returns (R,)."""
    rows, n = a.shape
    nblk = _nblk(n)
    prod = torch.zeros((rows, nblk * RED_CHUNK), dtype=a.dtype, device=a.device)
    prod[:, :n] = a * b
    part = torch.zeros((rows, -(-nblk // 256) * 256), dtype=a.dtype, device=a.device)
    part[:, :nblk] = _block_sums(_thread_sums(prod, rows * nblk)).reshape(rows, nblk)
    return _block_sums(_thread_sums(part, rows))


def pcg_dots_ordered_plain(a, b, c=None, d=None):
    """a . b (and c . d) summed in the order of the dot kernels, to the last
    bit (:func:`_ordered_sums`).  Returns a (1,) or (2,) tensor.  For the
    tests and chip_smoke.py; the wrappers' CPU path keeps torch.dot."""
    return torch.cat([_ordered_sums(u.reshape(1, -1), v.reshape(1, -1))
                      for u, v in [(a, b)] + ([] if c is None else [(c, d)])])


def pcg_update_ordered_plain(x, r, p, Ap, wk: PcgWork):
    """:func:`pcg_update_plain` with the projection's sums in the update
    kernel's order (:func:`_ordered_sums` of each updated vector against the
    mask, or against ones in mode 1), so the kernel equals it to the last
    bit; nothing written where the flag is 0.  For the tests and
    chip_smoke.py; the wrapper's CPU path keeps torch.mean / torch.sum."""
    if _frozen(wk):
        return x, r
    alpha = wk.sc[ALPHA]
    xn, rn = x + alpha * p, r - alpha * Ap
    if wk.mode:
        w = (wk.w if wk.mode == 2 else torch.ones_like(xn)).reshape(1, -1)
        mx, mr = (_ordered_sums(v.reshape(1, -1), w)[0] / wk.sc[WSUM] for v in (xn, rn))
        xn, rn = xn - mx, rn - mr
        if wk.mode == 2:
            xn, rn = xn * wk.w, rn * wk.w
    x.copy_(xn)
    r.copy_(rn)
    return x, r


def _check_vecs(wk: PcgWork, *vecs):
    """What may change between calls of a K8 entry: the vectors' dtype,
    size, device and layout against the work, one plain pass (what is
    frozen for a solve was checked by pcg_work); returns their size.  The
    slow path names what is wrong."""
    dt, n = wk.sc.dtype, vecs[0].numel()
    ok = wk.iters is not None and wk.grid > 0 and 2 * _nblk(n) == wk.partial.numel()
    for v in vecs:
        ok = ok and v.dtype == dt and v.numel() == n and v.is_cuda and v.is_contiguous()
    if not ok:
        _pcg_refusal(wk, vecs)
    return n


def _pcg_refusal(wk: PcgWork, vecs):
    """Raise the reason a K8 kernel cannot take these vectors."""
    if wk.partial is None or wk.iters is None or wk.grid <= 0:
        raise ValueError("pcg: the work has no card workspace; build it with pcg_work")
    n = vecs[0].numel()
    for v in vecs:
        if v.dtype != wk.sc.dtype:
            raise TypeError(f"pcg: a {v.dtype} vector for a {wk.sc.dtype} work")
        if v.numel() != n or 2 * _nblk(n) != wk.partial.numel():
            raise ValueError(f"pcg: vectors of {n} / {v.numel()} entries for a work of "
                             f"{wk.partial.numel() // 2} chunks")
    raise ValueError("pcg: expected contiguous CUDA vectors")


def pcg_dot(p, Ap, wk: PcgWork):
    """alpha = rz / (p . Ap) into wk.sc (one kernel launch on a CUDA tensor,
    into the work's workspace; nothing written where the flag is 0)."""
    if not p.is_cuda:
        return pcg_dot_plain(p, Ap, wk)
    n = _check_vecs(wk, p, Ap)
    _cuda.launch("pcg_dot", "knp_pcg_dot", p.dtype, p.data_ptr(), Ap.data_ptr(),
                 wk.partial.data_ptr(), wk.ticket.data_ptr(), wk.sc.data_ptr(),
                 wk.flag.data_ptr(), n, RED_CHUNK)
    return wk


def pcg_update(x, r, p, Ap, wk: PcgWork):
    """x += alpha p, r -= alpha Ap and their nullspace projection, in place
    (one cooperative kernel launch on a CUDA tensor, its block sums in the
    work's workspace; nothing written where the flag is 0)."""
    if not x.is_cuda:
        return pcg_update_plain(x, r, p, Ap, wk)
    n = _check_vecs(wk, x, r, p, Ap)
    _cuda.launch("pcg_update", "knp_pcg_update", x.dtype, x.data_ptr(), r.data_ptr(),
                 p.data_ptr(), Ap.data_ptr(), wk.sc.data_ptr(),
                 None if wk.w is None else wk.w.data_ptr(), wk.partial.data_ptr(),
                 wk.flag.data_ptr(), n, wk.grid, wk.mode)
    return x, r


def pcg_dot2_direction(r, z, p, wk: PcgWork):
    """rz, zz, beta, the count and the flag into wk, then p = z + beta p in
    place (one cooperative kernel launch on a CUDA tensor, into the work's
    workspace; nothing written where the flag is 0); returns wk."""
    if not r.is_cuda:
        return pcg_dot2_direction_plain(r, z, p, wk)
    n = _check_vecs(wk, r, z, p)
    _cuda.launch("pcg_dot2_direction", "knp_pcg_dot2_direction", r.dtype, r.data_ptr(),
                 z.data_ptr(), p.data_ptr(), wk.partial.data_ptr(), wk.sc.data_ptr(),
                 wk.flag.data_ptr(), wk.iters.data_ptr(), wk.max_it, n, wk.grid)
    return wk


# ---------------------------------------------------------------------------
# K15: batched BiCGStab
# ---------------------------------------------------------------------------

# slots of a system's row of the BiCGStab scalars (csrc/bicgstab.cu BI_*):
# the carried rho, alpha, omega; the tolerance; r . r and rhat . r of the
# current residual; the iteration's alpha
BI_RHO, BI_ALPHA, BI_OMEGA, BI_TOL, BI_RR, BI_RHON, BI_ALPHAN = range(7)
BI_NSC = 8


class BicgWork(NamedTuple):
    """Vectors, scalars and reduction workspace of one batched BiCGStab
    solve (mb systems of n entries), built once per solve by
    :func:`bicgstab_work`."""
    r: torch.Tensor       # (mb, n) preconditioned residual
    rhat: torch.Tensor    # (mb, n) shadow residual
    p: torch.Tensor       # (mb, n) search direction
    v: torch.Tensor       # (mb, n) A p of the last iteration
    s: torch.Tensor       # (mb, n) r - alpha v of the iteration
    sc: torch.Tensor      # (mb, BI_NSC) the scalars of each system (BI_*)
    ks: torch.Tensor      # (mb,) int32 iterations each system was live in
    live: torch.Tensor    # (mb,) int32 sqrt(r . r) > tol
    flag: torch.Tensor    # (1,) int32: some system is live
    # the kernels' reduction partials, (4 mb ceil(n / RED_CHUNK),)
    partial: "torch.Tensor | None" = None
    grid: int = 0         # blocks of the cooperative launches (on the card)


def bicgstab_work(mb: int, n: int, dtype, device) -> BicgWork:
    """Buffers of a solve, with the kernels' partials; on the card the
    launches' grid is sized once (``knp_bicgstab_grid``: the units, at most
    the blocks all three kernels can hold resident).  The entries then
    allocate nothing and check only the vectors they are given.  On the
    card more than MAX_SYSTEMS systems or a dtype other than float32 /
    float64 raise NotImplementedError."""
    dev = torch.device(device)
    grid = 0
    if dev.type == "cuda":
        if mb > MAX_SYSTEMS:
            raise NotImplementedError(f"bicgstab: more than {MAX_SYSTEMS} systems in one batch")
        if dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(f"bicgstab: the kernel takes float32/float64, got {dtype}")
        g = ctypes.c_int(0)
        _cuda.call("knp_bicgstab_grid", dtype, mb, n, ctypes.addressof(g))
        grid = g.value
    vec = lambda: torch.zeros((mb, n), dtype=dtype, device=dev)
    return BicgWork(r=vec(), rhat=vec(), p=vec(), v=vec(), s=vec(),
                    sc=torch.zeros((mb, BI_NSC), dtype=dtype, device=dev),
                    ks=torch.zeros(mb, dtype=torch.int32, device=dev),
                    live=torch.zeros(mb, dtype=torch.int32, device=dev),
                    flag=torch.zeros(1, dtype=torch.int32, device=dev),
                    partial=torch.empty(4 * mb * _nblk(n), dtype=dtype, device=dev), grid=grid)


def _rowdots(a, b, ordered):
    """Per-row a . b of (mb, n) arrays: the einsum, or (``ordered``) summed
    in the kernels' order to the last bit (:func:`_ordered_sums`)."""
    return _ordered_sums(a, b) if ordered else torch.einsum("sn,sn->s", a, b)


def _bicgstab_direction(wk: BicgWork, ordered):
    """rr and rho' of the current r, live (sqrt(rr) > tol), the flag, and
    the direction p = live ? r + beta (p - omega v) : p with the breakdown
    guard beta = 0 unless |rho| > 0, |omega| > 0 and live (krylov.py:531-537
    of the JAX package, the first half of its loop body)."""
    sc = wk.sc
    rr = _rowdots(wk.r, wk.r, ordered)
    rhon = _rowdots(wk.rhat, wk.r, ordered)
    live = torch.sqrt(rr) > sc[:, BI_TOL]
    rho, alpha, omega = sc[:, BI_RHO], sc[:, BI_ALPHA], sc[:, BI_OMEGA]
    safe = (torch.abs(rho) > 0) & (torch.abs(omega) > 0) & live
    beta = torch.where(safe, (rhon / rho) * (alpha / omega), torch.zeros_like(rho))
    wk.p.copy_(torch.where(live[:, None], wk.r + beta[:, None] * (wk.p - omega[:, None] * wk.v),
                           wk.p))
    sc[:, BI_RR] = rr
    sc[:, BI_RHON] = rhon
    wk.live.copy_(live.to(torch.int32))
    wk.flag.fill_(int(bool(torch.any(live))))
    return wk


def bicgstab_start_plain(r0, bz, wk: BicgWork, rtol, atol, ordered=False):
    """The solve's start from the preconditioned residual r0 and the
    preconditioned reference rhs bz (mb, n): tol = max(rtol ||bz||, atol),
    r = rhat = r0, v = p = 0, rho = alpha = omega = 1, ks = 0, then
    :func:`_bicgstab_direction` (rr, rho', live, the flag, the first p);
    ``ordered`` sums in the kernel's order.  Returns wk."""
    bb = _rowdots(bz, bz, ordered)
    wk.sc.zero_()
    wk.sc[:, BI_TOL] = torch.clamp(rtol * torch.sqrt(bb), min=atol)
    for k in (BI_RHO, BI_ALPHA, BI_OMEGA):
        wk.sc[:, k] = 1.0
    wk.r.copy_(r0)
    wk.rhat.copy_(r0)
    wk.p.zero_()
    wk.v.zero_()
    wk.ks.zero_()
    return _bicgstab_direction(wk, ordered)


def bicgstab_alpha_plain(v, wk: BicgWork, ordered=False):
    """After v = A p: ks += live, alpha' = rho' / (rhat . v) (0 where the
    dot is 0 or the system is frozen), s = r - alpha' v, and v kept in
    wk.v.  Returns wk."""
    sc = wk.sc
    live = wk.live.bool()
    wk.ks.add_(wk.live)
    denom = _rowdots(wk.rhat, v, ordered)
    zero = torch.zeros_like(denom)
    an = torch.where(torch.abs(denom) > 0, sc[:, BI_RHON] / denom, zero)
    an = torch.where(live, an, zero)
    sc[:, BI_ALPHAN] = an
    wk.s.copy_(wk.r - an[:, None] * v)
    wk.v.copy_(v)
    return wk


def bicgstab_omega_plain(t, x, wk: BicgWork, ordered=False):
    """After t = A s: omega' = (t . s) / (t . t) (0 where t . t is 0, the
    carried omega where frozen), x += alpha' p + omega' s (in place; omega'
    0 where frozen), r = live ? s - omega' t : r, the carried rho = live ?
    rho' : rho, alpha = alpha' + (not live) alpha, omega = omega', then
    :func:`_bicgstab_direction` for the next iteration.  Returns wk."""
    sc = wk.sc
    live = wk.live.bool()
    tt = _rowdots(t, t, ordered)
    ts = _rowdots(t, wk.s, ordered)
    zero = torch.zeros_like(tt)
    om = torch.where(tt > 0, ts / tt, zero)
    om = torch.where(live, om, sc[:, BI_OMEGA])
    an = sc[:, BI_ALPHAN]
    x.copy_(x + an[:, None] * wk.p + torch.where(live, om, zero)[:, None] * wk.s)
    wk.r.copy_(torch.where(live[:, None], wk.s - om[:, None] * t, wk.r))
    sc[:, BI_RHO] = torch.where(live, sc[:, BI_RHON], sc[:, BI_RHO])
    sc[:, BI_ALPHA] = an + (~live).to(sc.dtype) * sc[:, BI_ALPHA]
    sc[:, BI_OMEGA] = om
    return _bicgstab_direction(wk, ordered)


def _check_bicg(wk: BicgWork, *vecs):
    """What may change between calls of a K15 entry: the vectors against
    the work (dtype, shape (mb, n), on the card, contiguous), one plain
    pass; the work was checked by bicgstab_work.  The slow path names what
    is wrong."""
    ok = wk.grid > 0 and wk.partial is not None
    for v in vecs:
        ok = ok and (v.is_cuda and v.dtype == wk.r.dtype and v.shape == wk.r.shape
                     and v.is_contiguous())
    if not ok:
        if wk.grid <= 0 or wk.partial is None:
            raise ValueError("bicgstab: the work has no card workspace; build it with "
                             "bicgstab_work")
        for v in vecs:
            _cuda.check("vector", v, wk.r.dtype, wk.r.shape)


def bicgstab_start(r0, bz, wk: BicgWork, rtol, atol):
    """The solve's start (:func:`bicgstab_start_plain`; one cooperative
    kernel launch on CUDA tensors, its outputs bitwise those of the plain
    version with ``ordered=True``).  r0 and bz are read only.  Returns wk."""
    if not r0.is_cuda:
        return bicgstab_start_plain(r0, bz, wk, rtol, atol)
    _check_bicg(wk, r0, bz)
    mb, n = r0.shape
    _cuda.launch("bicgstab_start", "knp_bicgstab_start", r0.dtype, r0.data_ptr(), bz.data_ptr(),
                 wk.r.data_ptr(), wk.rhat.data_ptr(), wk.p.data_ptr(), wk.v.data_ptr(),
                 wk.partial.data_ptr(), wk.sc.data_ptr(), wk.ks.data_ptr(), wk.live.data_ptr(),
                 wk.flag.data_ptr(), mb, n, wk.grid, float(rtol), float(atol))
    return wk


def bicgstab_alpha(v, wk: BicgWork):
    """After v = A p (:func:`bicgstab_alpha_plain`; one cooperative kernel
    launch on a CUDA tensor).  v is read only and copied into wk.v, so the
    apply may hand back a buffer it reuses.  Returns wk."""
    if not v.is_cuda:
        return bicgstab_alpha_plain(v, wk)
    _check_bicg(wk, v)
    mb, n = v.shape
    _cuda.launch("bicgstab_alpha", "knp_bicgstab_alpha", v.dtype, v.data_ptr(), wk.r.data_ptr(),
                 wk.rhat.data_ptr(), wk.v.data_ptr(), wk.s.data_ptr(), wk.partial.data_ptr(),
                 wk.sc.data_ptr(), wk.ks.data_ptr(), wk.live.data_ptr(), mb, n, wk.grid)
    return wk


def bicgstab_omega(t, x, wk: BicgWork):
    """After t = A s (:func:`bicgstab_omega_plain`; one cooperative kernel
    launch on CUDA tensors): x (mb, n) updated in place, the next iteration's
    direction, scalars and flag.  Returns wk."""
    if not t.is_cuda:
        return bicgstab_omega_plain(t, x, wk)
    _check_bicg(wk, t, x)
    mb, n = t.shape
    _cuda.launch("bicgstab_omega", "knp_bicgstab_omega", t.dtype, t.data_ptr(), x.data_ptr(),
                 wk.r.data_ptr(), wk.rhat.data_ptr(), wk.p.data_ptr(), wk.v.data_ptr(),
                 wk.s.data_ptr(), wk.partial.data_ptr(), wk.sc.data_ptr(), wk.live.data_ptr(),
                 wk.flag.data_ptr(), mb, n, wk.grid)
    return wk
