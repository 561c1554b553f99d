"""Two-level + deflation preconditioner (torch port of the main-path subset
of knpemidg_tpu/solvers/twolevel.py).

Additive SPD pieces: a block-Jacobi smoother (kernel B on the card), a
coarse solve over contiguous fixed-size cell chunks (cells are numbered
(compartment, Morton), so chunks never straddle membranes and
restrict/prolong are reshape-sum/broadcast), exact deflation of the
per-compartment constant modes, and order-2 moment deflation.  The coarse
data is built once per preconditioner build (an equilibrated dense
Cholesky inverse); the per-iteration apply is dense GEMVs only.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.spmv import block_jacobi_apply, block_jacobi_inverse


def compartment_ids(mesh) -> np.ndarray:
    """Connected components of the same-subdomain-tag cell graph: one id per
    enclosed compartment (each ICS cell body, plus the ECS)."""
    from ..mesh.core import _compartments

    return _compartments(mesh)


def moment_vectors(coords, comp, order: int = 2, *, dtype, device):
    """Per-compartment polynomial moment fields W (nw, nd, nc): for every
    compartment the centred, per-axis scaled monomials {x,y,z} (order >= 1)
    and {x^2,xy,...} (order >= 2), zero outside the compartment.  Constants
    are excluded: the compartment deflation handles them exactly.
    ``coords`` (nc, nd, d): nodal coordinates per cell; ``comp`` (nc,),
    -1 on inert pad cells (which get no field)."""
    if order > 2:
        raise NotImplementedError("moment deflation orders above 2 are not ported")
    comp = np.asarray(comp)
    nc, nd, d = coords.shape
    rows = []
    for p in range(int(comp.max()) + 1):
        m = comp == p
        sel = coords[m]
        ctr = sel.mean(axis=(0, 1))
        L = np.abs(sel - ctr).max(axis=(0, 1))
        L = np.where(L > 0, L, 1.0)
        loc = (coords - ctr) / L                   # (nc, nd, d)
        base = []
        if order >= 1:
            base += [loc[:, :, a] for a in range(d)]
        if order >= 2:
            base += [loc[:, :, a] * loc[:, :, b]
                     for a in range(d) for b in range(a, d)]
        for f in base:
            rows.append(np.where(m[:, None], f, 0.0).T)    # (nd, nc)
    W = np.stack(rows) if rows else np.zeros((0, nd, nc))
    return torch.as_tensor(W, dtype=dtype, device=device)


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
                    mass_diag=None, v=None, max_dense: int = 4096,
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
    with ``blocks=None``; ``nbr`` and the chunks then index pairs."""
    if v is None:
        nd_b = blocks.shape[1]
        v = sum(blocks[:, i, j] for i in range(nd_b) for j in range(nd_b))  # (K, nc)
    nc = v.shape[1]
    n_agg = -(-nc // agg_size)
    if n_agg > max_dense:
        raise NotImplementedError(
            f"three-level coarse ({n_agg} chunks > {max_dense}) is not ported")
    if ridge < 1e-5:
        raise NotImplementedError("the coarse_ridge NaN-fallback ladder "
                                  "(ridge < 1e-5) is not ported")
    pad = n_agg * agg_size - nc
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


def _chunk_restrict(rs, n_agg, agg_size):
    """(..., nc) -> (..., n_agg): zero-pad to whole chunks and sum each."""
    pad = n_agg * agg_size - rs.shape[-1]
    rp = torch.nn.functional.pad(rs, (0, pad))
    return rp.reshape(rs.shape[:-1] + (n_agg, agg_size)).sum(dim=-1)


def _chunk_prolong(zc, agg_size, nc):
    """(..., n_agg) -> (..., nc): broadcast each chunk value to its cells."""
    out = zc[..., :, None].expand(zc.shape + (agg_size,))
    return out.reshape(zc.shape[:-1] + (-1,))[..., :nc]


def two_level_apply_fn(data, P_diag, agg_size: int) -> Callable:
    """Per-solve additive preconditioner apply from frozen coarse ``data``
    (see build_two_level) and the current block-Jacobi diagonal: BJ +
    chunk coarse (with one refinement sweep when ``As`` is present) +
    compartment deflation + moment deflation."""
    for key in ("d1inv", "momb_W", "ritz_W"):
        if key in data:
            raise NotImplementedError(f"two-level data {key!r} is not ported")
    Pinv = block_jacobi_inverse(P_diag.contiguous())
    nd = P_diag.shape[0]
    nc = P_diag.shape[2]
    inv, s = data["inv"], data["s"]
    refine = "As" in data
    As = data.get("As")
    n_agg = inv.shape[0]

    def dense_solve(rc):
        rs = s * rc
        z = inv @ rs
        if refine:
            z = z + inv @ (rs - As @ z)
        return s * z

    comp = "comp_inv" in data
    if comp:
        invc, sc, OH = data["comp_inv"], data["comp_s"], data["comp_onehot"]
        Asc = data["comp_As"]

        def comp_solve(rcomp):
            # one refinement sweep: the compartment system is the
            # f32-fragile piece (tiny membrane-scale eigenvalues)
            rsc = sc * rcomp
            zc = invc @ rsc
            zc = zc + invc @ (rsc - Asc @ zc)
            return sc * zc

    mom = "mom_W" in data
    if mom:
        Wm, inv_m, s_m = data["mom_W"], data["mom_inv"], data["mom_s"]

    def coarse(r):
        rs = r.sum(dim=0)                                # (nc,)
        zc = dense_solve(_chunk_restrict(rs, n_agg, agg_size))
        z = _chunk_prolong(zc, agg_size, nc)
        if comp:
            z = z + comp_solve(OH @ rs) @ OH
        out = z[None, :].expand(nd, nc)
        if mom:
            rw = s_m * torch.einsum("wic,ic->w", Wm, r)
            out = out + torch.einsum("w,wic->ic", s_m * (inv_m @ rw), Wm)
        return out

    def apply(r):                      # additive: BJ + coarse (+ deflation)
        return block_jacobi_apply(Pinv, r.contiguous()) + coarse(r)

    return apply


def two_level_apply_batched(data, P_diag, agg_size: int) -> Callable:
    """Batched additive two-level apply: ``data`` leaves and ``P_diag``
    carry a leading system axis m; the returned apply maps (m, nd, nc) ->
    (m, nd, nc).  The block-Jacobi inverses are computed once here, not per
    apply."""
    for key in ("d1inv", "ritz_W"):
        if key in data:
            raise NotImplementedError(f"two-level data {key!r} is not ported")
    Pinv = block_jacobi_inverse(P_diag.contiguous())
    inv, s = data["inv"], data["s"]                  # (m, n, n), (m, n)
    refine = "As" in data
    n_agg = inv.shape[-1]
    m, nd, _, nc = P_diag.shape

    def coarse_only(r):
        rc = s * _chunk_restrict(r.sum(dim=1), n_agg, agg_size)   # (m, n_agg)
        z = torch.einsum("mij,mj->mi", inv, rc)
        if refine:
            z = z + torch.einsum("mij,mj->mi", inv,
                                 rc - torch.einsum("mij,mj->mi", data["As"], z))
        zf = _chunk_prolong(s * z, agg_size, nc)                  # (m, nc)
        return zf[:, None, :].expand(m, nd, nc)

    def apply(r):
        return block_jacobi_apply(Pinv, r.contiguous()) + coarse_only(r)

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
