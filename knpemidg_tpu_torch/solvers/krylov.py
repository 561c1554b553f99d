"""Krylov solvers: preconditioned CG and batched restarted GMRES (torch
port of knpemidg_tpu/solvers/krylov.py).

Convergence test: ||M^-1 r||_2 <= max(rtol * ||M^-1 b||_2, atol) -- the
preconditioned residual norm (PETSc's KSP_NORM_PRECONDITIONED), which for
the EMI system weights the small membrane-jump modes by 1/lambda.

The JAX ``lax.while_loop``s become Python loops that read the convergence
flag on the host every iteration.  Vector work stays on the device; the
GMRES Hessenberg column, its Givens rotations and the small triangular
solve (a few dozen scalars per system) run on the host in the vector
dtype, in the same order as the JAX version.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.linalg
import torch


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: object             # int (pcg) or list of ints (gmres_batched)
    resnorm: torch.Tensor
    converged: bool


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

        def proj(v):
            return (v - torch.sum(v * w) / wsum) * w
    else:
        proj = _project_constant if project_nullspace else (lambda v: v)

    b = proj(b)
    x = proj(x0)
    r = proj(b - matvec(x))
    z = precond(r)
    p = z
    rz = _dot(r, z)
    zz = _dot(z, z)
    bz = precond(b if b_ref is None else b_ref)
    bnorm = torch.sqrt(_dot(bz, bz))
    tol = torch.clamp(rtol * bnorm, min=atol)
    tol2 = tol * tol

    k = 0
    # the convergence test reads the carried ||z||^2 of the last iteration
    while k < max_it and bool(zz > tol2):
        Ap = matvec(p)
        alpha = rz / _dot(p, Ap)
        x = proj(x + alpha * p)
        r = proj(r - alpha * Ap)
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        zz = _dot(z, z)
        k += 1
    rn = torch.sqrt(zz)
    return KrylovResult(x=x, iters=k, resnorm=rn, converged=bool(rn <= tol))


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
) -> KrylovResult:
    """m independent left-preconditioned GMRES(restart) solves sharing one
    Krylov loop (CGS2 orthogonalisation, Givens rotations replayed per
    column).

    ``matvec``/``precond`` act on the full batch (m, ...) -> (m, ...).  The
    Arnoldi loop runs until every system's residual estimate clears its
    tolerance; a system that has converged freezes (identity rotation, no
    Hessenberg update, zero basis vector), so the extra shared steps cannot
    perturb its solution, and its ``iters`` count only its own steps.  Each
    restart recomputes the preconditioned residual from scratch."""
    mb = b.shape[0]
    shape = b.shape
    n = b.numel() // mb
    bv = b.reshape(mb, n)

    def Aop(v):
        return precond(matvec(v.reshape(shape))).reshape(mb, n)

    def res_of(x):
        return precond((bv - matvec(x.reshape(shape)).reshape(mb, n))
                       .reshape(shape)).reshape(mb, n)

    def norms(v):                                     # (mb, n) -> (mb,)
        return torch.sqrt(torch.einsum("sn,sn->s", v, v))

    bz = precond((bv if b_ref is None else b_ref.reshape(mb, n))
                 .reshape(shape)).reshape(mb, n)
    tol_t = torch.clamp(rtol * norms(bz), min=atol)
    tol = tol_t.cpu().numpy()
    rdt = tol.dtype                       # host scalars in the vector dtype
    max_cycles = -(-max_it // restart)
    m = restart

    def host(t):
        return t.cpu().numpy().astype(rdt)

    def cycle(x, r):
        beta_t = norms(r)
        safe = torch.where(beta_t > 0, beta_t, torch.ones_like(beta_t))
        V = torch.zeros((mb, m + 1, n), dtype=b.dtype, device=b.device)
        V[:, 0] = r / safe[:, None]
        # R: rotated Hessenberg columns; g: rotated beta*e1 (|g[j]| is the
        # residual-norm estimate after j steps); cs/sn: stored rotations
        R = np.zeros((mb, m + 1, m), dtype=rdt)
        g = np.zeros((mb, m + 1), dtype=rdt)
        g[:, 0] = host(beta_t)
        cs = np.zeros((mb, m), dtype=rdt)
        sn = np.zeros((mb, m), dtype=rdt)
        ks = np.zeros(mb, dtype=np.int64)
        j = 0
        while j < m and np.any(np.abs(g[:, j]) > tol):
            gj = g[:, j].copy()
            live = np.abs(gj) > tol                   # systems still stepping
            ks += live
            w = Aop(V[:, j])
            # classical Gram-Schmidt with reorthogonalisation (CGS2) over
            # the whole basis (rows > j are zero)
            h1 = torch.einsum("skn,sn->sk", V, w)
            w = w - torch.einsum("sk,skn->sn", h1, V)
            h2 = torch.einsum("skn,sn->sk", V, w)
            w = w - torch.einsum("sk,skn->sn", h2, V)
            hj1_t = norms(w)
            vnext = torch.where(
                (hj1_t > 1e-300)[:, None],
                w / torch.where(hj1_t > 0, hj1_t, torch.ones_like(hj1_t))[:, None],
                torch.zeros_like(w))
            live_t = torch.as_tensor(live, device=b.device)
            V[:, j + 1] = torch.where(live_t[:, None], vnext, torch.zeros_like(w))
            h = host(h1 + h2)
            h[:, j + 1] = host(hj1_t)
            # replay the j stored rotations on the new column
            for i in range(j):
                hi = cs[:, i] * h[:, i] + sn[:, i] * h[:, i + 1]
                hi1 = -sn[:, i] * h[:, i] + cs[:, i] * h[:, i + 1]
                h[:, i] = hi
                h[:, i + 1] = hi1
            hj = h[:, j].copy()
            hjp = h[:, j + 1].copy()
            denom = np.sqrt(hj ** 2 + hjp ** 2)
            dsafe = np.where(denom > 0, denom, rdt.type(1))
            c_new = np.where(denom > 0, hj / dsafe, rdt.type(1))
            s_new = np.where(denom > 0, hjp / dsafe, rdt.type(0))
            # freeze converged systems: identity rotation, masked updates
            c_new = np.where(live, c_new, rdt.type(1)).astype(rdt)
            s_new = np.where(live, s_new, rdt.type(0)).astype(rdt)
            cs[:, j] = c_new
            sn[:, j] = s_new
            h[:, j] = np.where(live, denom, hj)
            h[:, j + 1] = 0
            g[:, j + 1] = np.where(live, -s_new * gj, rdt.type(0))
            g[:, j] = np.where(live, c_new * gj, gj)
            R[:, :, j] = np.where(live[:, None], h, R[:, :, j])
            j += 1
        # triangular solve of R[:k,:k] y = g[:k] per system
        y = np.zeros((mb, m), dtype=rdt)
        for s in range(mb):
            k = int(ks[s])
            if k:
                y[s, :k] = scipy.linalg.solve_triangular(
                    R[s, :k, :k], g[s, :k], lower=False)
        y_t = torch.as_tensor(y, dtype=b.dtype, device=b.device)
        u = torch.einsum("sk,skn->sn", y_t, V[:, :m])
        return x + u, ks

    x = x0.reshape(mb, n)
    it = np.zeros(mb, dtype=np.int64)
    k = 0
    while True:
        r = res_of(x)
        rn = norms(r)
        if not (np.any(host(rn) > tol) and k < max_cycles):
            break
        x, steps = cycle(x, r)
        k += 1
        it += steps
    converged = bool(torch.all(rn <= tol_t))
    return KrylovResult(x=x.reshape(shape), iters=[int(v) for v in it],
                        resnorm=rn, converged=converged)
