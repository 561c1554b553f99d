"""Two-level + deflation preconditioner (torch port of the main-path subset
of knpemidg_tpu/solvers/twolevel.py).

Additive SPD pieces: a block-Jacobi smoother (kernel B on the card), a
coarse solve over contiguous fixed-size cell chunks (cells are numbered
(compartment, Morton), so chunks never straddle membranes and
restrict/prolong are reshape-sum/broadcast), exact deflation of the
per-compartment constant modes, polynomial moment deflation and the Ritz
deflation of harvested small-eigenvalue modes.  The coarse data is built
once per preconditioner build (an equilibrated dense Cholesky inverse; on
large meshes three-level: a Jacobi sweep on the chunk diagonal and the
dense inverse on super-chunks, build_two_level's ``max_dense``);
the per-iteration coarse and deflation apply is kernels K6/K7 on the card
(ops/coarse.py).  The Ritz harvest runs once per build: a device Lanczos
(ritz_lanczos_W) or a host float64 one (ritz_lanczos_W_host), then a host
float64 Galerkin (ritz_galerkin_host).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops import coarse
from ..ops.spmv import bell_matvec, block_jacobi_inverse, block_jacobi_operands


def compartment_ids(mesh) -> np.ndarray:
    """Connected components of the same-subdomain-tag cell graph: one id per
    enclosed compartment (each ICS cell body, plus the ECS)."""
    from ..mesh.core import _compartments

    return _compartments(mesh)


def moment_vectors(coords, comp, order: int = 2, *, dtype=None, device=None,
                   order_per_comp=None, host: bool = False, axial_order: int = 0,
                   axial_min_aspect: float = 4.0, return_comp: bool = False):
    """Per-compartment polynomial moment fields W (nw, nd, nc): for every
    compartment the centred, per-axis scaled monomials {x,y,z} (order >= 1),
    {x^2,xy,...} (order >= 2), the cubic (>= 3) and quartic (>= 4) ones,
    zero outside the compartment.  Constants are excluded: the compartment
    deflation handles them exactly.  ``coords`` (nc, nd, d): nodal
    coordinates per cell; ``comp`` (nc,), -1 on inert pad cells (which get
    no field).

    ``order_per_comp`` (n_comp,): a compartment's own order in place of
    ``order``.  ``axial_order``: a compartment whose largest per-axis
    extent is at least ``axial_min_aspect`` times each other one also gets
    the Chebyshev polynomials T_j of its scaled coordinate along that axis,
    j = its order + 1 .. axial_order (slow variation along an elongated
    compartment at a cost of one row a degree).  ``host=True`` returns W
    as contiguous numpy float64 and touches no device (the host moment
    Galerkin); otherwise a tensor of ``dtype`` on ``device``.
    ``return_comp``: also return the compartment of each row (nw,)."""
    comp = np.asarray(comp)
    nc, nd, d = coords.shape
    rows = []
    row_comp = []
    for p in range(int(comp.max()) + 1):
        order_p = int(order if order_per_comp is None else order_per_comp[p])
        m = comp == p
        sel = coords[m]
        ctr = sel.mean(axis=(0, 1))
        L = np.abs(sel - ctr).max(axis=(0, 1))
        L = np.where(L > 0, L, 1.0)
        loc = (coords - ctr) / L                   # (nc, nd, d)
        base = []
        if order_p >= 1:
            base += [loc[:, :, a] for a in range(d)]
        if order_p >= 2:
            base += [loc[:, :, a] * loc[:, :, b]
                     for a in range(d) for b in range(a, d)]
        if order_p >= 3:
            base += [loc[:, :, a] * loc[:, :, b] * loc[:, :, c]
                     for a in range(d) for b in range(a, d) for c in range(b, d)]
        if order_p >= 4:
            base += [loc[:, :, a] * loc[:, :, b] * loc[:, :, c] * loc[:, :, e]
                     for a in range(d) for b in range(a, d)
                     for c in range(b, d) for e in range(c, d)]
        if axial_order > order_p:
            ax = int(np.argmax(L))
            others = np.delete(L, ax)
            if others.size == 0 or L[ax] >= axial_min_aspect * others.max():
                x = loc[:, :, ax]
                tm1, t = np.ones_like(x), x          # T_0, T_1
                for j in range(2, axial_order + 1):
                    tm1, t = t, 2.0 * x * t - tm1
                    if j > order_p:
                        base.append(t)
        for f in base:
            rows.append(np.where(m[:, None], f, 0.0).T)    # (nd, nc)
            row_comp.append(p)
    W = np.stack(rows) if rows else np.zeros((0, nd, nc))
    W = np.ascontiguousarray(W) if host else torch.as_tensor(W, dtype=dtype, device=device)
    if return_comp:
        return W, np.asarray(row_comp, dtype=np.int64)
    return W


def _equilibration_scale(d):
    """rsqrt of a diagonal with an underflow-safe relative floor: exactly
    zero entries (dead chunks) clamp to max(1e-12 * max(d), tiny) instead of
    sending inf into the coarse inverse."""
    dmax = torch.max(d)
    tiny = torch.finfo(d.dtype).tiny
    floor = torch.clamp(1e-12 * dmax, min=tiny)
    return torch.rsqrt(torch.maximum(d, floor))


def _spd_inverse(A):
    """Explicit inverse of an SPD matrix through its upper Cholesky factor
    (the cho_factor / cho_solve pair of the JAX package)."""
    U = torch.linalg.cholesky(A, upper=True)
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return torch.cholesky_solve(eye, U, upper=True)


def build_moment_deflation(W, fan, ridge: float = 1e-6):
    """Galerkin data for the moment-deflation correction: ``W (nw, nd, nc)``
    deflation fields, ``fan`` a batched operator apply (nw, nd, nc) ->
    (nw, nd, nc).  Returns arrays to merge into the two-level data dict."""
    AW = fan(W)
    Am = torch.einsum("wic,vic->wv", W, AW)
    Am = 0.5 * (Am + Am.T)
    dm = torch.diagonal(Am)
    sm = _equilibration_scale(dm)
    As = Am * sm[:, None] * sm[None, :]
    As = As + ridge * torch.eye(As.shape[0], dtype=As.dtype, device=As.device)
    return {"mom_W": W, "mom_inv": _spd_inverse(As), "mom_s": sm}


def build_two_level(blocks, nbr, agg_size: int, sym: bool = True,
                    comp_onehot=None, comp_ids=None, extra_diag=None,
                    mass_diag=None, v=None, max_dense: int | None = 4096,
                    ridge: float = 1e-5):
    """Frozen coarse-level data of the two-level preconditioner: the dense
    equilibrated coarse inverse and the compartment-deflation inverse.

    The Galerkin assembly is cancellation-free: off-diagonals take only the
    chunk-crossing block sums, diagonals come from the identity
    A(non-mass part) @ 1 = 0 plus the explicitly supplied positive parts
    (``mass_diag`` (nc,): the KNP mass; ``extra_diag`` (nd, nd, nc): the EMI
    B-operator regularisation).

    ``v``: precomputed per-slot block value sums (K, n), the only thing
    ``blocks`` is read for.  The pair layout passes ops.pairs.pair_v_sums
    with ``blocks=None``; ``nbr`` and the chunks then index pairs.

    ``max_dense``: the largest dense coarse size.  Above it (n_agg = nc /
    agg_size chunks > max_dense) the build is three-level: the level-1
    chunk system gets a Jacobi sweep on its cancellation-free diagonal
    (``d1inv`` (n_agg,), no matrix formed; 0 on a dead chunk, whose
    diagonal is under the floor max(1e-12 max d1, tiny)), and the dense
    equilibrated inverse moves up to super-chunks of agg_size k2 cells,
    k2 = ceil(n_agg / max_dense): level-1 chunk a lies in super-chunk
    a // k2.  A ~1M-cell mesh at agg 64 then needs a 3,888^2 dense coarse
    instead of a 15,552^2 one."""
    if v is None:
        nd_b = blocks.shape[1]
        v = sum(blocks[:, i, j] for i in range(nd_b) for j in range(nd_b))  # (K, nc)
    nc = v.shape[1]
    n_agg = -(-nc // agg_size)
    if ridge < 1e-5:
        raise NotImplementedError("the coarse_ridge NaN-fallback ladder "
                                  "(ridge < 1e-5) is not ported")
    pad = n_agg * agg_size - nc
    if max_dense is not None and n_agg > max_dense:
        k2 = -(-n_agg // max_dense)
        data = build_two_level(None, nbr, agg_size * k2, sym=sym, comp_onehot=comp_onehot,
                               comp_ids=comp_ids, extra_diag=extra_diag,
                               mass_diag=mass_diag, v=v, max_dense=None, ridge=ridge)
        agg = torch.arange(nc + pad, dtype=torch.int64, device=v.device) // agg_size
        cross = agg[torch.nn.functional.pad(nbr.long(), (0, pad))] != agg[None, :]
        vm = torch.where(cross, torch.nn.functional.pad(v, (0, pad)), 0.0)
        d1 = -vm.sum(dim=0).reshape(n_agg, agg_size).sum(dim=1)
        if mass_diag is not None:
            d1 = d1 + torch.nn.functional.pad(mass_diag, (0, pad)).reshape(
                n_agg, agg_size).sum(dim=1)
        if extra_diag is not None:
            d1 = d1 + torch.nn.functional.pad(
                extra_diag.sum(dim=(0, 1)), (0, pad)).reshape(n_agg, agg_size).sum(dim=1)
        floor1 = torch.clamp(1e-12 * torch.max(d1), min=torch.finfo(d1.dtype).tiny)
        # dead padded chunks get an exact zero (their residual is zero too)
        data["d1inv"] = torch.where(d1 > floor1, 1.0 / torch.maximum(d1, floor1), 0.0)
        return data
    dev = v.device
    agg = torch.arange(nc + pad, dtype=torch.int64, device=dev) // agg_size
    nbr_p = torch.nn.functional.pad(nbr.long(), (0, pad))
    cols = agg[nbr_p]
    cross_chunk = cols != agg[None, :]
    v_p = torch.nn.functional.pad(v, (0, pad))
    vm_chunk = torch.where(cross_chunk, v_p, 0.0)
    rows = agg[None, :].expand_as(vm_chunk)
    Ac = torch.zeros((n_agg, n_agg), dtype=v.dtype, device=dev)
    Ac.index_put_((rows.reshape(-1), cols.reshape(-1)), vm_chunk.reshape(-1),
                  accumulate=True)
    crossing_rowsum = vm_chunk.sum(dim=0).reshape(n_agg, agg_size).sum(dim=1)
    diag = -crossing_rowsum
    if mass_diag is not None:
        diag = diag + torch.nn.functional.pad(mass_diag, (0, pad)).reshape(
            n_agg, agg_size).sum(dim=1)
    if extra_diag is not None:
        diag = diag + torch.nn.functional.pad(
            extra_diag.sum(dim=(0, 1)), (0, pad)).reshape(n_agg, agg_size).sum(dim=1)
    Ac = Ac + torch.diag(diag)
    if not sym:
        Ac = 0.5 * (Ac + Ac.T)
    rank1 = extra_diag is None and mass_diag is None
    d = torch.diagonal(Ac)
    s = _equilibration_scale(d)
    As = Ac * s[:, None] * s[None, :]
    if rank1:
        As = As + (1.0 / n_agg) * torch.ones_like(As)
    # small diagonal shift: f32 Galerkin noise can push a near-null
    # compartment-constant mode slightly indefinite
    As = As + ridge * torch.eye(n_agg, dtype=As.dtype, device=dev)
    data = {"inv": _spd_inverse(As), "s": s}
    if sym:
        data["As"] = As

    if comp_onehot is not None:
        comp_ids = comp_ids.long()
        n_comp = comp_onehot.shape[0]
        cid_nbr = comp_ids[nbr.long()]
        crossing = cid_nbr != comp_ids[None, :]
        vm = torch.where(crossing, v, 0.0)
        rowsc = comp_ids[None, :].expand_as(vm)
        Acomp = torch.zeros((n_comp, n_comp), dtype=v.dtype, device=dev)
        Acomp.index_put_((rowsc.reshape(-1), cid_nbr.reshape(-1)), vm.reshape(-1),
                         accumulate=True)
        offdiag_rowsum = comp_onehot @ vm.sum(dim=0)
        Acomp = Acomp - torch.diag(offdiag_rowsum)
        if not sym:
            Acomp = 0.5 * (Acomp + Acomp.T)
        dc = torch.diagonal(Acomp)
        sc = _equilibration_scale(dc)
        Asc = Acomp * sc[:, None] * sc[None, :] + (1.0 / n_comp) * torch.ones(
            (n_comp, n_comp), dtype=Acomp.dtype, device=dev)
        data["comp_inv"] = _spd_inverse(Asc)
        data["comp_s"] = sc
        data["comp_As"] = Asc
        data["comp_onehot"] = comp_onehot
    return data


def two_level_apply_fn(data, P_diag, agg_size: int, halves: bool = False,
                       buffer: bool = False, mask=None, inv_out=None) -> Callable:
    """Per-solve additive preconditioner apply from frozen coarse ``data``
    (see build_two_level) and the current block-Jacobi diagonal: BJ +
    chunk coarse (with one refinement sweep when ``As`` is present) +
    compartment deflation + moment deflation + Ritz deflation (each when
    its entries are in ``data``; with ``d1inv`` the three-level coarse of
    build_two_level).  The BJ inverse is kernel B's, read from
    ``P_diag`` in place (``halves``: the pair diagonal's two diagonal
    sub-blocks only, pair_bj = 'halves', the diagonal unmasked or masked
    alike), into ``inv_out`` where given (the step's buffer).  The apply is
    one coarse.coarse_add: on the card at nd = 4 the BJ apply folds into
    K6's prolong-add; elsewhere kernel B's apply, then K6's restrict,
    solve and prolong-add added in place into it.  ``mask`` (nd, nc): the
    pair layout's live mask, applied by the prolong-add in the same pass
    (the apply's result is the masked sum).  ``buffer``: every apply
    returns the same tensor, overwritten, for a caller that is done with
    it before the next apply (PCG's z is consumed by its direction update,
    GMRES's w by its Arnoldi step); without it each apply returns a new
    tensor."""
    if "momb_W" in data:
        raise NotImplementedError("two-level data 'momb_W' (emi_moment_blocked) is not ported")
    bj = block_jacobi_operands(block_jacobi_inverse(P_diag, halves, inv_out), halves, buffer)
    co = coarse.operands(data, agg_size, batched=False)

    def apply(r):                      # additive: BJ + coarse (+ deflation)
        r = r.contiguous()
        out = torch.empty_like(r) if bj.buf is None else bj.buf
        coarse.coarse_add(co, out[None], r[None], mask, bj)
        return out

    return apply


def two_level_apply_batched(data, P_diag, agg_size: int, halves: bool = False,
                            buffer: bool = False, mask=None, inv_out=None) -> Callable:
    """Batched additive two-level apply: ``data`` leaves and ``P_diag``
    carry a leading system axis m (``P_diag`` may be a view whose systems
    lie apart: slot 0 of the (m, K, nd, nd, nc) operator); the returned
    apply maps (m, nd, nc) -> (m, nd, nc).  The block-Jacobi inverses are
    computed once here, not per apply; the chunk coarse is K7 (on the card
    one launch, the chunk sums, the coarse solve and the prolong-add: no
    deflation, no As; at nd = 4 with the BJ apply folded in; two- or
    three-level, as build_two_level made ``data``).  ``halves``,
    ``buffer``, ``mask`` (nd, nc, shared by the systems) and ``inv_out``
    as in :func:`two_level_apply_fn`."""
    if "ritz_W" in data:
        raise NotImplementedError("two-level data 'ritz_W' (knp_ritz) is not ported")
    bj = block_jacobi_operands(block_jacobi_inverse(P_diag, halves, inv_out), halves, buffer)
    co = coarse.operands(data, agg_size, batched=True)

    def apply(r):
        r = r.contiguous()
        out = torch.empty_like(r) if bj.buf is None else bj.buf
        return coarse.coarse_add(co, out, r, mask, bj)

    return apply


def make_two_level(blocks, P_diag, nbr, agg_size: int, sym: bool = True,
                   comp_onehot=None, comp_ids=None, extra_diag=None,
                   mass_diag=None, ridge: float = 1e-5) -> Callable:
    """Build-and-apply in one go (build_two_level + two_level_apply_fn)."""
    data = build_two_level(blocks, nbr, agg_size, sym=sym,
                           comp_onehot=comp_onehot, comp_ids=comp_ids,
                           extra_diag=extra_diag, mass_diag=mass_diag,
                           ridge=ridge)
    return two_level_apply_fn(data, P_diag, agg_size)


# ---------------------------------------------------------------------------
# Ritz deflation: harvest of small-eigenvalue modes of the preconditioned
# EMI operator, once per pc build (off the per-iteration path)
# ---------------------------------------------------------------------------

def ritz_lanczos_W(blocks, nbr, precond, b, k: int = 40, n_ritz: int = 8,
                   project_mean: bool = True, matvec=None, mask=None):
    """Device half of the Ritz harvest: k steps of preconditioned Lanczos
    with full reorthogonalization from rhs ``b`` (nd, nc), returning the
    ``n_ritz`` smallest normalized Ritz fields W (n_ritz, nd, nc) on b's
    device.  Pair with :func:`ritz_galerkin_host`.

    ``project_mean`` removes the global constant from the iterates (the EMI
    nullspace convention of the production PCG); ``matvec`` overrides the
    block-ELL apply (the pair layout); ``mask`` (b-shaped, 0/1) marks the
    live entries: the projection averages over and re-masks to them, so
    the pair layout's dead halves stay exactly zero.  The tridiagonal
    eigenproblem is solved in float64 on the host."""
    mv = matvec if matvec is not None else (
        lambda v: bell_matvec(blocks, nbr, v.contiguous()))

    def dot(a, c):
        return torch.sum(a * c)

    if mask is not None:
        w_m = mask.to(b.dtype)
        wsum = torch.sum(w_m)
        if project_mean:
            proj = lambda v: (v - torch.sum(v * w_m) / wsum) * w_m
        else:
            proj = lambda v: v * w_m
    elif project_mean:
        proj = lambda v: v - torch.mean(v)
    else:
        proj = lambda v: v
    r = proj(b)
    z = proj(precond(r))
    beta0 = torch.sqrt(torch.clamp(dot(r, z), min=1e-30))
    Qr = torch.zeros((k,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    Qz = torch.zeros_like(Qr)
    Qr[0], Qz[0] = r / beta0, z / beta0
    alphas = torch.zeros(k, dtype=b.dtype, device=b.device)
    betas = torch.zeros(k, dtype=b.dtype, device=b.device)
    for j in range(k - 1):
        qz = Qz[j]
        w = mv(qz)
        if j > 0:
            w = w - betas[j - 1] * Qr[j - 1]
        a = dot(qz, w)
        w = w - a * Qr[j]
        # full reorthogonalization in the M-inner product (k is small;
        # rows above j are still zero)
        coef = torch.einsum("kic,ic->k", Qz, w)
        w = w - torch.einsum("k,kic->ic", coef, Qr)
        w = proj(w)
        z = proj(precond(w))
        bnew = torch.sqrt(torch.clamp(dot(w, z), min=1e-30))
        Qr[j + 1], Qz[j + 1] = w / bnew, z / bnew
        alphas[j] = a
        betas[j] = bnew
    alphas[k - 1] = dot(Qz[k - 1], mv(Qz[k - 1]))
    al = alphas.cpu().double()
    be = betas[: k - 1].cpu().double()
    T = torch.diag(al) + torch.diag(be, 1) + torch.diag(be, -1)
    theta, Y = torch.linalg.eigh(T)
    idx = torch.argsort(theta)[:n_ritz]
    Ysel = Y[:, idx].to(dtype=b.dtype, device=b.device)
    W = torch.einsum("kv,kic->vic", Ysel, Qz)
    return W / torch.sqrt(torch.einsum("vic,vic->v", W, W))[:, None, None]


def _np(x, dtype=None):
    """Host numpy copy of a tensor or array (float64 when asked)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype=dtype)


def np_two_level_apply(data, P_diag, agg_size: int):
    """Numpy float64 mirror of :func:`two_level_apply_fn` (additive form with
    the three-level, compartment, moment and Ritz pieces present in
    ``data``), the
    preconditioner of the host Ritz harvest: the float32 device Lanczos is
    chaotic, a float64 recursion is deterministic."""
    if "momb_W" in data:
        raise NotImplementedError("two-level data 'momb_W' (emi_moment_blocked) is not ported")
    d = {k: _np(v, np.float64) for k, v in data.items()}
    Pd = _np(P_diag, np.float64)
    Pinv = np.moveaxis(np.linalg.inv(np.moveaxis(Pd, -1, 0)), 0, -1)   # (nd, nd, nc)
    nc = Pd.shape[2]
    inv, s = d["inv"], d["s"]
    As = d.get("As")

    def dense_solve(rc):
        rs = s * rc
        z = inv @ rs
        if As is not None:
            z = z + inv @ (rs - As @ z)
        return s * z

    if "d1inv" in d:                   # three-level (build_two_level max_dense)
        d1inv = d["d1inv"]
        n_agg = d1inv.shape[0]
        n2 = inv.shape[0]
        k2 = -(-n_agg // n2)
        pad2 = n2 * k2 - n_agg

        def coarse_solve(rc):
            rc2 = np.pad(rc, (0, pad2)).reshape(n2, k2).sum(axis=1)
            return rc * d1inv + np.repeat(dense_solve(rc2), k2)[:n_agg]
    else:
        n_agg = inv.shape[0]
        coarse_solve = dense_solve
    pad = n_agg * agg_size - nc

    def apply(r):
        z = np.einsum("ijc,jc->ic", Pinv, r)
        rs = r.sum(axis=0)
        rc = np.pad(rs, (0, pad)).reshape(n_agg, agg_size).sum(axis=1)
        zc = np.repeat(coarse_solve(rc), agg_size)[:nc]
        if "comp_inv" in d:
            invc, sc, OH = d["comp_inv"], d["comp_s"], d["comp_onehot"]
            Asc = d["comp_As"]
            rsc = sc * (OH @ rs)
            zco = invc @ rsc
            zco = zco + invc @ (rsc - Asc @ zco)
            zc = zc + (sc * zco) @ OH
        out = z + zc[None, :]
        if "mom_W" in d:
            Wm, inv_m, s_m = d["mom_W"], d["mom_inv"], d["mom_s"]
            rw = s_m * np.einsum("wic,ic->w", Wm, r)
            out = out + np.einsum("w,wic->ic", s_m * (inv_m @ rw), Wm)
        if "ritz_W" in d:
            Wr, inv_r, s_r = d["ritz_W"], d["ritz_inv"], d["ritz_s"]
            rr = s_r * np.einsum("vic,ic->v", Wr, r)
            out = out + np.einsum("v,vic->ic", s_r * (inv_r @ rr), Wr)
        return out

    return apply


def ritz_lanczos_W_host(blocks, nbr, data, P_diag, b, agg_size: int,
                        k: int = 40, n_ritz: int = 8,
                        project_mean: bool = True):
    """Host float64 Ritz harvest: preconditioned Lanczos with full
    reorthogonalization in numpy, numerically deterministic (the mirror of
    :func:`ritz_lanczos_W`, with :func:`np_two_level_apply`).  Returns W
    (n_ritz, nd, nc) numpy float64 for :func:`ritz_galerkin_host`."""
    B = _np(blocks, np.float64)
    N = _np(nbr)
    precond = np_two_level_apply(data, P_diag, agg_size)

    def mv(x):
        y = np.einsum("ijc,jc->ic", B[0], x)
        for kk in range(1, B.shape[0]):
            y = y + np.einsum("ijc,jc->ic", B[kk], x[:, N[kk]])
        return y

    proj = (lambda v: v - v.mean()) if project_mean else (lambda v: v)
    r = proj(_np(b, np.float64))
    z = proj(precond(r))
    dot = lambda a, c: float(np.einsum("ic,ic->", a, c))
    beta0 = np.sqrt(max(dot(r, z), 1e-300))
    Qr = np.zeros((k,) + r.shape)
    Qz = np.zeros((k,) + r.shape)
    Qr[0], Qz[0] = r / beta0, z / beta0
    alphas = np.zeros(k)
    betas = np.zeros(k)
    for j in range(k - 1):
        w = mv(Qz[j])
        if j > 0:
            w = w - betas[j - 1] * Qr[j - 1]
        a = dot(Qz[j], w)
        w = w - a * Qr[j]
        # full reorthogonalization in the M-inner product
        coef = np.einsum("kic,ic->k", Qz[: j + 1], w)
        w = w - np.einsum("k,kic->ic", coef, Qr[: j + 1])
        w = proj(w)
        z = proj(precond(w))
        bnew = np.sqrt(max(dot(w, z), 1e-300))
        alphas[j] = a
        betas[j] = bnew
        Qr[j + 1], Qz[j + 1] = w / bnew, z / bnew
    alphas[k - 1] = dot(Qz[k - 1], mv(Qz[k - 1]))
    T = (np.diag(alphas) + np.diag(betas[: k - 1], 1)
         + np.diag(betas[: k - 1], -1))
    theta, Y = np.linalg.eigh(T)
    idx = np.argsort(theta)[:n_ritz]
    W = np.einsum("kv,kic->vic", Y[:, idx], Qz)
    return W / np.sqrt(np.einsum("vic,vic->v", W, W))[:, None, None]


def ritz_galerkin_host(blocks, nbr, W, ridge: float = 1e-8,
                       project_mean: bool = False, drop_rel: float = 1e-6):
    """Host float64 deflation Galerkin of the Ritz fields W (v, nd, nc) on
    the cell blocks (K, nd, nd, nc).

    ``project_mean`` (EMI): remove the global-constant component of each
    field in float64 (a field that collapsed onto the EMI nullspace has
    A-energy ~0, and its 1/sqrt(dg) equilibration would amplify noise into
    every apply); a field that was the constant is zeroed.  ``drop_rel``:
    fields whose A-energy is below drop_rel * max are zeroed with their
    scale.  The inverse is an eigenvalue-truncated pseudo-inverse (a
    near-breakdown harvest can give near-parallel fields).

    Returns {'ritz_W', 'ritz_inv', 'ritz_s'} as tensors of W's dtype on W's
    device for a tensor W, and as float32 CPU tensors for a numpy W (the
    JAX function's float32 for numpy fields)."""
    B = _np(blocks, np.float64)                       # (K, nd, nd, nc)
    N = _np(nbr)
    Wh = _np(W, np.float64)                           # (v, nd, nc)
    if project_mean:
        Wh = Wh - Wh.mean(axis=(1, 2), keepdims=True)
        nrm = np.sqrt((Wh ** 2).sum(axis=(1, 2), keepdims=True))
        ok = nrm > 1e-3
        Wh = np.where(ok, Wh / np.maximum(nrm, 1e-30), 0.0)
    AW = np.einsum("ijc,vjc->vic", B[0], Wh)
    for s in range(1, B.shape[0]):
        AW += np.einsum("ijc,vjc->vic", B[s], Wh[:, :, N[s]])
    G = np.einsum("vic,wic->vw", Wh, AW)
    Wh, inv, sg = _galerkin_inverse(G, Wh, ridge, drop_rel)
    if isinstance(W, torch.Tensor):
        dtype, device = W.dtype, W.device
    else:
        dtype, device = torch.float32, "cpu"
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return {"ritz_W": t(Wh), "ritz_inv": t(inv), "ritz_s": t(sg)}


def moment_galerkin_host(blocks, nbr, W, ridge: float = 1e-6):
    """Host float64 deflation Galerkin of the moment fields W (numpy
    (nw, nd, nc)) on the cell blocks (K, nd, nd, nc): ritz_galerkin_host's
    Galerkin and inverse (no mean projection), for the ~95 axial fields at
    ~1M cells that its einsums take minutes over.  A W runs as
    multiply-adds of whole field rows, elementwise, and the Galerkin as one
    matrix product on one thread (a threaded BLAS product splits the long
    sum by the thread count, and its bits with it), in torch on the CPU, so
    the result repeats whatever the host's threads.  Its rounding is not
    the einsums': ritz_galerkin_host keeps those, because the Ritz data of
    the main path reach its recorded counts and kernel digests.

    Returns (W, inv, s), float64 numpy, the dead fields zeroed in W."""
    B = torch.from_numpy(np.ascontiguousarray(_np(blocks, np.float64)))
    N = torch.from_numpy(np.ascontiguousarray(_np(nbr)))
    Wt = torch.from_numpy(np.ascontiguousarray(W, dtype=np.float64))
    AW = torch.zeros_like(Wt)
    for s in range(B.shape[0]):
        Wg = Wt if s == 0 else Wt[:, :, N[s]]
        for i in range(B.shape[1]):
            for j in range(B.shape[2]):
                AW[:, i].addcmul_(B[s, i, j], Wg[:, j])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        G = (Wt.reshape(Wt.shape[0], -1) @ AW.reshape(Wt.shape[0], -1).T).numpy()
    finally:
        torch.set_num_threads(threads)
    return _galerkin_inverse(G, Wt.numpy(), ridge, 1e-6)


def _galerkin_inverse(G, Wh, ridge, drop_rel):
    """The equilibrated, ridged pseudo-inverse of the Galerkin G of the
    fields Wh: (Wh with its dead fields zeroed, inv, s), float64 numpy."""
    G = 0.5 * (G + G.T)
    dg = np.diagonal(G).copy()
    live = dg > drop_rel * max(dg.max(), 1e-300)
    Wh = np.where(live[:, None, None], Wh, 0.0)
    sg = np.where(live, 1.0 / np.sqrt(np.maximum(dg, 1e-300)), 0.0)
    Gs = G * sg[:, None] * sg[None, :]
    Gs = Gs + ridge * np.eye(Gs.shape[0])
    Gs[~live, :] = 0.0
    Gs[:, ~live] = 0.0
    Gs[~live, ~live] = 1.0
    lam, V = np.linalg.eigh(Gs)
    keep = lam > 1e-6 * lam.max()
    inv = (V[:, keep] / lam[keep]) @ V[:, keep].T
    return Wh, inv, sg


def build_ritz_deflation(blocks, nbr, precond, b, k: int = 40,
                         n_ritz: int = 8, ridge: float = 1e-8):
    """Harvest approximate small-eigenvalue modes of the preconditioned EMI
    operator (device Lanczos, :func:`ritz_lanczos_W`) and build their
    deflation Galerkin in float64 on the host (:func:`ritz_galerkin_host`):
    the 'ritz_W', 'ritz_inv', 'ritz_s' entries of the two-level data."""
    W = ritz_lanczos_W(blocks, nbr, precond, b, k=k, n_ritz=n_ritz)
    return ritz_galerkin_host(blocks, nbr, W, ridge=ridge, project_mean=True)
