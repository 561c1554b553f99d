"""Inert cell padding and cell renumbering of a solver (torch port of the
single-device part of knpemidg_tpu/parallel/sharding.py).

The interleaved pair layout (Solver.enable_pair_layout) pads the cell axis
with inert cells and renumbers it so that pair p occupies slots (2p, 2p+1);
these are the helpers it uses.  Device arrays are cells-last, so the cell
axis is always the trailing one.  Sharding over several devices (the halo
exchange and ``shard_solver``) is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

CELL_ARRAYS = {"vol", "G", "diam", "cell_tag", "cell_qp", "cell_mid",
               "cf_idx", "cf_is_plus", "nbr", "GG", "nodes"}


def _pad_last(a: torch.Tensor, n_extra: int, fill) -> torch.Tensor:
    pad = torch.full(a.shape[:-1] + (n_extra,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=-1)


def _permute_cell_dict(g, perm, inv):
    """Permute one geometry dict's cell axis and remap its cell-id-valued
    arrays (neighbour table, facet->cell and exterior-facet->cell maps)."""
    g = dict(g)
    dev = g["nbr"].device
    perm_t = torch.as_tensor(perm, device=dev)
    inv_t = torch.as_tensor(inv, device=dev)
    for k in CELL_ARRAYS:
        if k == "nbr" or g.get(k) is None:
            continue
        g[k] = g[k][..., perm_t].contiguous()
    g["nbr"] = inv_t[g["nbr"].long()][:, perm_t].to(g["nbr"].dtype).contiguous()
    for k in ("f_cp", "f_cm", "e_c"):
        g[k] = inv_t[g[k].long()].to(g[k].dtype)
    return g


def permute_cells(S, perm: np.ndarray):
    """Renumber the solver's cell axis by ``perm`` (new position -> old id):
    permutes every cell-indexed array and remaps every array whose values
    are cell ids.  Records ``S._cell_perm`` and ``S._cell_perm_inv`` so
    states can be mapped out of the new numbering (unpad_state)."""
    nc = perm.size
    inv = np.empty(nc, dtype=np.int64)
    inv[perm] = np.arange(nc)
    S.g = _permute_cell_dict(S.g, perm, inv)
    inv_t = torch.as_tensor(inv, device=S.g["nbr"].device)
    perm_t = torch.as_tensor(perm, device=S.g["nbr"].device)
    for k in ("cp", "cm"):                 # membrane-presliced cell maps
        if k in getattr(S, "mem_dev", {}):
            S.mem_dev[k] = inv_t[S.mem_dev[k].long()].to(S.mem_dev[k].dtype)
    S.D = S.D[:, perm_t].contiguous()
    S.rho = S.rho[perm_t].contiguous()
    S.__dict__.pop("_emit_bufs", None)     # the cell tables point at the old arrays
    S._comp_np = S._comp_np[perm]
    S._cell_perm = perm
    S._cell_perm_inv = inv


def pad_cell_axis(S, extra: int):
    """Append ``extra`` inert cells to every cell-indexed array of solver S.

    Padded cells are isolated unit cells: mean volume (so the KNP mass
    diagonal and the coarse-level equilibration stay well-scaled), zero
    gradients (no stiffness or drift: decoupled rows), subdomain tag 0,
    self-referencing neighbours, quadrature points far outside the domain
    (so spatial locators never select them), and the dummy facet in the
    cell->facet map.  Their EMI rows are zero (the masked nullspace
    projection of solvers/krylov.pcg removes their constant modes) and
    their KNP rows are pure mass."""
    if extra == 0:
        return
    nc = S.n_cells
    far = float(np.abs(np.asarray(S.mesh.vertices)).max()) * 2.0 + 1.0

    def pad_dict(g):
        g = dict(g)
        nf_dummy = int(g["f_area"].shape[-1]) - 1
        # host means, as the JAX package takes them
        fills = {"vol": float(g["vol"].cpu().numpy().mean()), "diam": 1.0,
                 "cell_tag": 0, "cell_qp": far, "cell_mid": far,
                 "cf_idx": nf_dummy, "cf_is_plus": True}
        for k in CELL_ARRAYS:
            if k == "nbr" or g.get(k) is None:
                continue
            g[k] = _pad_last(g[k], extra, fills.get(k, 0))
        nbr = g["nbr"]
        n0 = nbr.shape[1]
        self_idx = torch.arange(n0, n0 + extra, dtype=nbr.dtype, device=nbr.device)
        g["nbr"] = torch.cat([nbr, self_idx.expand(nbr.shape[0], extra)], dim=1)
        return g

    S.g = pad_dict(S.g)
    # D stays positive at pads: kappa = F psi sum z^2 D c feeds the EMI
    # preconditioner diagonal, and a zero kappa row would make the
    # block-Jacobi inverse singular
    D = S.D.cpu().numpy()
    Dm = torch.as_tensor(np.broadcast_to(D.mean(axis=1, keepdims=True),
                                         (D.shape[0], extra)).copy(),
                         dtype=S.D.dtype, device=S.D.device)
    S.D = torch.cat([S.D, Dm], dim=1)
    S.rho = _pad_last(S.rho, extra, 0.0)
    S.__dict__.pop("_emit_bufs", None)     # the cell tables point at the old arrays
    oh, ids = S._comp_arrays()                    # built at the real size
    S._comp_onehot = torch.nn.functional.pad(oh, (0, extra))   # zero columns:
    S._comp_ids = torch.nn.functional.pad(ids, (0, extra))     # pads invisible
    S._pad_mask = torch.arange(nc + extra, device=S.D.device) < nc


def unpad_state(S, state):
    """Fields of ``state`` in the solver's original cell numbering: strips
    the inert cell padding and undoes the renumbering."""
    nc = S.n_cells
    out = dict(state)
    # interleaved pair layout: pads are interspersed (dead pair halves), so
    # the one-gather original-id -> padded-slot map applies directly
    idx = getattr(S, "_cell_unpad_idx", None)
    inv = getattr(S, "_cell_perm_inv", None)
    for key in ("c", "c_elim", "phi", "phi_prev"):
        if key not in state:
            continue
        v = state[key]
        if idx is not None:
            out[key] = v[..., torch.as_tensor(idx, device=v.device)]
            continue
        v = v[..., :nc]
        if inv is not None:
            v = v[..., torch.as_tensor(inv, device=v.device)]
        out[key] = v
    return out
