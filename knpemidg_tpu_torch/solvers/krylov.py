"""Krylov solvers: preconditioned CG, restarted GMRES and its batched
form, batched BiCGStab (torch port of knpemidg_tpu/solvers/krylov.py).

Convergence test: ||M^-1 r||_2 <= max(rtol * ||M^-1 b||_2, atol) -- the
preconditioned residual norm (PETSc's KSP_NORM_PRECONDITIONED), which for
the EMI system weights the small membrane-jump modes by 1/lambda.

The JAX ``lax.while_loop``s become Python loops around the vector and
scalar work of ``ops/krylov_ops.py`` (kernels K8, K9 and K15 on the card),
which keeps the loops' scalars on the device.  The PCG loop keeps its test
on the device as well: K8 writes the flag (the JAX loop's ``cond``) and the
iteration count, and writes nothing once the flag is 0.  So the host queues
iteration j before it looks at the flag of iteration j - 1, which reaches
it through pinned memory behind a CUDA event (:class:`_FlagLookahead`):
the device always has an iteration queued, at most one iteration runs
frozen after the exit, and a solve makes two blocking reads (the count and
the convergence test at its end).  The batched GMRES loop reads its
Arnoldi steps' flag the same way, one step behind (K9's step writes
nothing once the flag is 0); its blocking reads are the cycle starts' flags
and the counts and convergence test at its end.  Per BiCGStab iteration
the host reads one convergence flag and copies nothing else across.  An
Arnoldi step after the matvec is one call (one kernel launch on the card).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import krylov_ops as ko


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: object             # int (pcg) or list of ints (gmres_batched)
    resnorm: torch.Tensor
    converged: bool


# the PCG loop's look-ahead, summed over solves for the scripts that report
# it: solves, and iterations queued after the loop's exit (every K8 entry of
# such an iteration wrote nothing; at most one a solve)
PCG_LOOKAHEAD = {"solves": 0, "frozen": 0}
# the batched GMRES loop's: solves, restart cycles, Arnoldi steps queued
# (live and frozen) and steps queued after a cycle's exit (every K9 step
# entry of such a step wrote nothing; at most one a cycle)
GMRES_LOOKAHEAD = {"solves": 0, "cycles": 0, "steps": 0, "frozen": 0}
_PINNED = {}              # device -> (pinned int32 (2,), its two slots, two events)


class _FlagLookahead:
    """A Krylov loop's flag (PCG's, or batched GMRES's within a cycle),
    read one iteration behind.  ``record(j)`` copies the flag after
    iteration j (j = -1: before the first) into slot j % 2:
    on the card asynchronously, into pinned host memory behind a CUDA event
    on the stream current when the solve began; on the CPU by value.
    ``done(j)`` says, without waiting, whether that copy has landed (always
    on the CPU); ``read(j)`` returns it, on the card after waiting on its
    event only.  The two slots alternate, so a slot is read before it is
    written again."""

    def __init__(self, flag):
        self.flag = flag
        if flag.is_cuda:
            if flag.device not in _PINNED:
                host = torch.zeros(2, dtype=torch.int32, pin_memory=True)
                _PINNED[flag.device] = (host.numpy(), (host[0:1], host[1:2]),
                                        (torch.cuda.Event(), torch.cuda.Event()))
            self.values, self.slots, self.events = _PINNED[flag.device]
            self.stream = torch.cuda.current_stream(flag.device)
        else:
            self.values = [0, 0]

    def record(self, j):
        s = j % 2
        if self.flag.is_cuda:
            self.slots[s].copy_(self.flag, non_blocking=True)
            self.events[s].record(self.stream)
        else:
            self.values[s] = int(self.flag)

    def done(self, j):
        return not self.flag.is_cuda or self.events[j % 2].query()

    def read(self, j):
        s = j % 2
        if self.flag.is_cuda:
            self.events[s].synchronize()
        return int(self.values[s])


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _project_constant(x):
    """Remove the constant-vector component (EMI nullspace)."""
    return x - torch.mean(x)


def pcg(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    precond: Callable,
    rtol: float,
    atol: float,
    max_it: int,
    project_nullspace: bool = False,
    b_ref: Optional[torch.Tensor] = None,
    nullspace_mask: Optional[torch.Tensor] = None,
) -> KrylovResult:
    """Preconditioned conjugate gradients.

    The loop's test (the carried ||z||^2 above tol^2, fewer than ``max_it``
    iterations) and its count stay on the device; the host queues each
    iteration before it reads the flag of the one before, and stops at the
    first flag it reads 0.  Where that flag has already reached the host
    after the next matvec is queued (a loop whose host work outlasts the
    device's), the loop stops there; otherwise the iteration queued after
    the exit runs frozen: its matvec and preconditioner apply recompute
    from the unchanged r and p, and every K8 entry writes nothing.  Either
    way the outputs are the same bits.  ``iters`` is the device's count of
    live iterations.

    ``b_ref``: the vector whose preconditioned norm anchors the relative
    tolerance instead of ``b`` (increment-form solves, where ``b`` is the
    initial residual).

    ``nullspace_mask``: boolean mask (broadcastable to the vector shape)
    of the REAL entries when the vector carries inert padding (the dead
    halves of the pair layout).  The constant mode of the padded operator
    is 1 on the real entries and 0 on the pads, so the projection averages
    over the real entries only and zeroes the pads."""
    if nullspace_mask is not None and project_nullspace:
        w = nullspace_mask.to(b.dtype)
        wsum = torch.sum(w) * (b.numel() // nullspace_mask.numel())
        w = w.expand(b.shape).contiguous()
        mode = 2

        def proj(v):
            return (v - torch.sum(v * w) / wsum) * w
    else:
        w, wsum = None, torch.tensor(float(b.numel()), dtype=b.dtype, device=b.device)
        mode = 1 if project_nullspace else 0
        proj = _project_constant if project_nullspace else (lambda v: v)

    b = proj(b)
    x = proj(x0).clone(memory_format=torch.contiguous_format)
    r = proj(b - matvec(x)).contiguous()
    z = precond(r).contiguous()
    p = z.clone()
    rz = _dot(r, z)
    zz = _dot(z, z)
    bz = precond(b if b_ref is None else b_ref)
    bnorm = torch.sqrt(_dot(bz, bz))
    tol = torch.clamp(rtol * bnorm, min=atol)
    zero = torch.zeros_like(rz)
    wk = ko.pcg_work(torch.stack([rz, zz, zero, zero, tol * tol, wsum]),
                     (zz > tol * tol).to(torch.int32).reshape(1), w, mode, b.numel(),
                     max_it)

    # the test reads the carried ||z||^2 and the count of the last iteration
    look = _FlagLookahead(wk.flag)
    look.record(-1)
    PCG_LOOKAHEAD["solves"] += 1
    for j in range(max_it):
        Ap = matvec(p).contiguous()
        if look.done(j - 1) and not look.read(j - 1):
            break                              # the exit seen without a wait
        ko.pcg_dot(p, Ap, wk)                  # alpha = rz / p.Ap
        ko.pcg_update(x, r, p, Ap, wk)         # x += alpha p, r -= alpha Ap, projected
        z = precond(r).contiguous()
        ko.pcg_dot2_direction(r, z, p, wk)     # rz, zz, beta, count, flag; p = z + beta p
        look.record(j)
        if not look.read(j - 1):               # iteration j ran frozen
            PCG_LOOKAHEAD["frozen"] += 1
            break
    rn = torch.sqrt(wk.sc[ko.ZZ])
    return KrylovResult(x=x, iters=int(wk.iters), resnorm=rn, converged=bool(rn <= tol))


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    precond: Callable,
    rtol: float,
    atol: float,
    max_it: int,
    restart: int = 20,
    matvec_hi: Optional[Callable] = None,
    b_ref: Optional[torch.Tensor] = None,
) -> KrylovResult:
    """Left-preconditioned restarted GMRES(restart) of one system, with
    CGS2 orthogonalisation and Givens-rotation residual estimates: the
    batched loop of :func:`gmres_batched` with one system (kernel K9 at
    mb = 1 on the card), whose semantics per system are the JAX package's
    ``gmres``.  ``iters`` counts the Arnoldi steps (an int).

    ``matvec_hi``: a higher-precision matvec used only for each restart's
    residual, b - A x computed in its dtype and rounded back to b's (mixed
    precision iterative refinement)."""
    def one(f):
        return lambda v: f(v[0])[None]

    res = gmres_batched(one(matvec), b[None], x0[None], one(precond), rtol, atol, max_it,
                        restart, None if b_ref is None else b_ref[None],
                        matvec_hi=None if matvec_hi is None else one(matvec_hi))
    return KrylovResult(x=res.x[0], iters=res.iters[0], resnorm=res.resnorm[0],
                        converged=res.converged)


def gmres_batched(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    precond: Callable,
    rtol: float,
    atol: float,
    max_it: int,
    restart: int = 20,
    b_ref: Optional[torch.Tensor] = None,
    matvec_hi: Optional[Callable] = None,
) -> KrylovResult:
    """m independent left-preconditioned GMRES(restart) solves sharing one
    Krylov loop (CGS2 orthogonalisation, Givens rotations replayed per
    column).

    ``matvec``/``precond`` act on the full batch (m, ...) -> (m, ...).  The
    Arnoldi loop runs until every system's residual estimate clears its
    tolerance; a system that has converged freezes (identity rotation, no
    Hessenberg update, zero basis vector), so the extra shared steps cannot
    perturb its solution, and its ``iters`` count only its own steps.  Each
    restart recomputes the preconditioned residual from scratch, with
    ``matvec_hi`` where given (see :func:`gmres`).

    Within a cycle the host queues step j before it reads the flag of step
    j - 1 (:class:`_FlagLookahead`), and stops at the first it reads 0:
    where that flag is already home before step j's matvec is queued, the
    cycle ends there; otherwise step j runs frozen (its matvec and
    preconditioner apply recompute from V[j], which live step j - 1 wrote,
    and K9's step writes nothing).  Either way the outputs are the same
    bits.  Step m is never queued; each cycle start's flag is a blocking
    read."""
    mb = b.shape[0]
    shape = b.shape
    n = b.numel() // mb
    bv = b.reshape(mb, n)

    def Aop(v):
        return precond(matvec(v.reshape(shape))).reshape(mb, n).contiguous()

    def res_of(x):
        if matvec_hi is None:
            r = bv - matvec(x.reshape(shape)).reshape(mb, n)
        else:
            Ax = matvec_hi(x.reshape(shape)).reshape(mb, n)
            r = (bv.to(Ax.dtype) - Ax).to(b.dtype)
        return precond(r.reshape(shape)).reshape(mb, n).contiguous()

    m = restart
    wk = ko.gmres_work(mb, n, m, b.dtype, b.device)
    bz = precond((bv if b_ref is None else b_ref.reshape(mb, n))
                 .reshape(shape)).reshape(mb, n).contiguous()
    ko.gmres_cgs_dot(bz[None], bz, 1, wk.h1, wk)
    wk.tol.copy_(torch.clamp(rtol * torch.sqrt(wk.h1[:, 0]), min=atol))
    max_cycles = -(-max_it // restart)

    x = x0.reshape(mb, n).clone()
    it = torch.zeros(mb, dtype=torch.int32, device=b.device)
    look = _FlagLookahead(wk.flag)
    GMRES_LOOKAHEAD["solves"] += 1
    k = 0
    while True:
        # beta = ||r||, V[0] = r / beta, g = beta e1; the flag: any beta > tol
        ko.gmres_start(res_of(x), wk)
        if not (k < max_cycles and bool(wk.flag)):
            break
        GMRES_LOOKAHEAD["cycles"] += 1
        for j in range(m):
            if j and look.done(j - 1) and not look.read(j - 1):
                break                          # step j - 1 ended the cycle, seen without a wait
            w = Aop(wk.V[j])
            # classical Gram-Schmidt with reorthogonalisation (CGS2) over the
            # populated rows 0..j, hj1, V[j+1], the rotations, the freeze,
            # ks and the flag
            ko.gmres_arnoldi(w, wk, j)
            GMRES_LOOKAHEAD["steps"] += 1
            look.record(j)
            if j and not look.read(j - 1):     # step j ran frozen
                GMRES_LOOKAHEAD["frozen"] += 1
                break
        ko.gmres_solve_update(wk, x)           # x += V^T y
        it += wk.ks
        k += 1
    converged = bool(torch.all(wk.beta <= wk.tol))
    return KrylovResult(x=x.reshape(shape), iters=[int(v) for v in it.tolist()],
                        resnorm=wk.beta.clone(), converged=converged)


def bicgstab_batched(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    precond: Callable,
    rtol: float,
    atol: float,
    max_it: int,
    b_ref: Optional[torch.Tensor] = None,
) -> KrylovResult:
    """m independent left-preconditioned BiCGStab solves sharing one loop,
    with the batching contract of :func:`gmres_batched`: ``matvec`` /
    ``precond`` act on the full batch (m, ...), the tolerance is
    max(rtol ||M^-1 b_ref||, atol) in the preconditioned residual norm, and
    a system that is no longer live freezes (its x, r and p kept).  Two
    applies of M^-1 A an iteration; ``iters`` counts each system's live
    iterations (PETSc's bcgs convention), a list of ints.

    The loop body's vector and scalar work is kernel K15 on the card
    (``ko.bicgstab_alpha`` after the first apply, ``ko.bicgstab_omega``
    after the second, which also forms the next direction and the flag the
    host reads once an iteration).  The applies may return a buffer they
    reuse: each result is consumed, or copied into the work, before the
    next apply."""
    mb = b.shape[0]
    shape = b.shape
    n = b.numel() // mb
    bv = b.reshape(mb, n)

    def Aop(v):
        return precond(matvec(v.reshape(shape))).reshape(mb, n).contiguous()

    bz = precond((bv if b_ref is None else b_ref.reshape(mb, n))
                 .reshape(shape)).reshape(mb, n).clone(memory_format=torch.contiguous_format)
    r0 = precond((bv - matvec(x0).reshape(mb, n)).reshape(shape)).reshape(mb, n).contiguous()
    wk = ko.bicgstab_work(mb, n, b.dtype, b.device)
    ko.bicgstab_start(r0, bz, wk, rtol, atol)
    x = x0.reshape(mb, n).clone(memory_format=torch.contiguous_format)
    k = 0
    while k < max_it and bool(wk.flag):
        ko.bicgstab_alpha(Aop(wk.p), wk)       # ks, alpha, s = r - alpha v
        ko.bicgstab_omega(Aop(wk.s), x, wk)    # omega, x, r, the next p and the flag
        k += 1
    rn = torch.sqrt(wk.sc[:, ko.BI_RR])
    tol = wk.sc[:, ko.BI_TOL]
    return KrylovResult(x=x.reshape(shape), iters=[int(v) for v in wk.ks.tolist()],
                        resnorm=rn, converged=bool(torch.all(rn <= tol)))
