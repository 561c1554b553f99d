"""Geometric tabulations for DG1 / DLT0 spaces on simplicial meshes.

Replaces DOLFIN's function spaces + dofmaps + FFC element tables (SURVEY.md
N1/N2).  The DG1 dof layout is dense: ``u[cell, i]`` is the value at local
vertex ``i`` (cell-local Lagrange nodes), so the dofmap is pure index
arithmetic.  The DLT0 trace space has one dof per (membrane) facet.

Everything here is computed once on host in float64 numpy, then shipped to
the device as torch tensors via :meth:`Geometry.to_device`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import basis as fe
from .quadrature import simplex_rule
from ..mesh.core import Mesh


@dataclasses.dataclass
class Geometry:
    """Static-geometry arrays (see module docstring).  Interior facet arrays
    carry one extra zero/dummy row at index ``nf`` so gather maps can pad."""

    d: int
    nd: int                    # dofs per cell: binom(d+degree, degree)

    # cells -----------------------------------------------------------------
    vol: np.ndarray            # (nc,)
    G: np.ndarray              # (nc, d+1, d): barycentric (P1) gradients;
                               # for degree 1 these ARE the basis gradients,
                               # for degree>=2 per-point gradients compose as
                               # A_c @ G (fem/basis.grad_coeffs)
    diam: np.ndarray           # (nc,) cell diameter (max vertex distance)
    cell_tag: np.ndarray       # (nc,) int32
    cell_qp: np.ndarray        # (nc, nq_c, d) physical cell quad points
    w_c: np.ndarray            # (nq_c,) weights (sum 1)
    Phi_c: np.ndarray          # (nq_c, nd) P1 basis at cell quad points
    cell_mid: np.ndarray       # (nc, d)

    # interior facets (index nf = dummy row) ---------------------------------
    f_cp: np.ndarray           # (nf+1,) plus cell (ECS / lower tag side)
    f_cm: np.ndarray           # (nf+1,) minus cell
    f_n: np.ndarray            # (nf+1, d) unit normal out of plus cell (= n_g)
    f_area: np.ndarray         # (nf+1,)
    f_havg: np.ndarray         # (nf+1,) avg of the two cell diameters
    f_Rp: np.ndarray           # (nf+1, nq_f, nd) trace of plus-cell P1 basis
    f_Rm: np.ndarray           # (nf+1, nq_f, nd)
    f_stag: np.ndarray         # (nf+1,) int32 surface tag (-1 on dummy row)
    f_qp: np.ndarray           # (nf+1, nq_f, d)
    f_mid: np.ndarray          # (nf+1, d)
    w_f: np.ndarray            # (nq_f,)

    # exterior facets ---------------------------------------------------------
    e_c: np.ndarray            # (ne,)
    e_n: np.ndarray            # (ne, d) outward normal
    e_area: np.ndarray         # (ne,)
    e_R: np.ndarray            # (ne, nq_f, nd)
    e_qp: np.ndarray           # (ne, nq_f, d)
    e_tag: np.ndarray          # (ne,) int32

    # gather maps -------------------------------------------------------------
    cf_idx: np.ndarray         # (nc, d+1) facet id (nf = none)
    cf_is_plus: np.ndarray     # (nc, d+1) bool
    nbr: np.ndarray            # (nc, d+2): [self, neighbor across facet l...]

    # degree-aware extras -------------------------------------------------------
    degree: int = 1
    nodes: np.ndarray = None   # (nc, nd, d) physical Lagrange node coords
    A_c: np.ndarray = None     # (nq_c, nd, d+1) grad coeffs at cell qp
    f_gnp: np.ndarray = None   # (nf+1, nq_f, nd) n.grad(basis), plus side
    f_gnm: np.ndarray = None   # (nf+1, nq_f, nd) (degree >= 2 only)

    # Arrays whose leading cell/facet axis is moved LAST on device.  The
    # cells-last layout makes every per-cell kernel read coalesced: thread
    # c of a warp touches element c of each (nd, nd) block row.
    _CELLS_LAST = {
        "G", "cell_qp", "cell_mid", "f_Rp", "f_Rm", "f_n", "f_qp", "f_mid",
        "e_R", "e_n", "e_qp", "cf_idx", "cf_is_plus", "nbr",
        "nodes", "f_gnp", "f_gnm",
    }

    def to_device(self, dtype=torch.float64, *, device):
        """Return a dict of torch tensors on `device` (floats cast to
        `dtype`, indices int32), cell/facet-indexed tensors transposed to
        the cells-last layout.  Exterior slots of ``nbr`` point at the cell
        itself, so every neighbour gather stays in bounds."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                if f.name in self._CELLS_LAST and v.ndim > 1:
                    v = np.moveaxis(v, 0, -1)
                v = np.ascontiguousarray(v)
                if np.issubdtype(v.dtype, np.floating):
                    out[f.name] = torch.as_tensor(v, dtype=dtype, device=device)
                elif v.dtype == bool:
                    out[f.name] = torch.as_tensor(v, device=device)
                else:
                    out[f.name] = torch.as_tensor(v.astype(np.int32),
                                                  device=device)
            else:
                out[f.name] = v
        return out


def _barycentric_matrices(vertices, cells):
    """Minv (nc, nd, nd) with lambda(x) = Minv @ [x; 1]."""
    nc, nd = cells.shape
    d = nd - 1
    M = np.empty((nc, nd, nd))
    M[:, :d, :] = vertices[cells].transpose(0, 2, 1)   # column i = vertex i
    M[:, d, :] = 1.0
    return np.linalg.inv(M), M


def build_geometry(mesh: Mesh, quad_degree_cell: int = 4,
                   quad_degree_facet: int = 4, degree: int = 1) -> Geometry:
    d = mesh.dim
    nd1 = d + 1                                   # barycentric count
    nd = fe.n_basis(d, degree)
    # mass/penalty exactness requires quadrature degree >= 2*degree
    quad_degree_cell = max(quad_degree_cell, 2 * degree)
    quad_degree_facet = max(quad_degree_facet, 2 * degree)
    verts, cells = mesh.vertices, mesh.cells
    nc = mesh.num_cells

    Minv, M = _barycentric_matrices(verts, cells)
    G = Minv[:, :, :d].copy()                     # (nc, d+1, d)
    detM = np.linalg.det(M)
    vol = np.abs(detM) / math.factorial(d)

    x = verts[cells]                              # (nc, d+1, d)
    diam = np.zeros(nc)
    for i in range(nd1):
        for j in range(i + 1, nd1):
            diam = np.maximum(diam, np.linalg.norm(x[:, i] - x[:, j], axis=1))
    cell_mid = x.mean(axis=1)

    lam_c, w_c = simplex_rule(nd1, quad_degree_cell)
    cell_qp = np.einsum("qi,cid->cqd", lam_c, x)
    Phi_c = fe.values(lam_c, degree)               # (nq_c, nd)
    A_c = fe.grad_coeffs(lam_c, degree) if degree > 1 else None
    nodes = fe.nodes_physical(verts, cells, degree)

    # --- interior facets -----------------------------------------------------
    nf = mesh.num_interior_facets
    fx = verts[mesh.if_verts]                      # (nf, d, d) facet vertex coords
    lam_f, w_f = simplex_rule(d, quad_degree_facet)
    nq_f = len(w_f)
    f_qp = np.einsum("qi,fid->fqd", lam_f, fx)     # (nf, nq_f, d)
    f_mid = fx.mean(axis=1)

    cp = mesh.if_cells[:, 0]
    cm = mesh.if_cells[:, 1]

    def lam_at(cell_ids, qp):
        """Barycentric coords of physical points wrt cells -> (n, nq, d+1)."""
        Mi = Minv[cell_ids]                        # (n, d+1, d+1)
        ones = np.ones(qp.shape[:2] + (1,))
        xh = np.concatenate([qp, ones], axis=2)    # (n, nq, d+1)
        return np.einsum("nij,nqj->nqi", Mi, xh)

    def traces(cell_ids, qp):
        """Basis values of cell at physical points -> (n, nq, nd)."""
        return fe.values(lam_at(cell_ids, qp), degree)

    f_Rp = traces(cp, f_qp)
    f_Rm = traces(cm, f_qp)

    if d == 2:
        t = fx[:, 1] - fx[:, 0]
        f_area = np.linalg.norm(t, axis=1)
        n = np.stack([t[:, 1], -t[:, 0]], axis=1) / f_area[:, None]
    else:
        c = np.cross(fx[:, 1] - fx[:, 0], fx[:, 2] - fx[:, 0])
        nrm = np.linalg.norm(c, axis=1)
        f_area = 0.5 * nrm
        n = c / nrm[:, None]
    # orient out of the plus cell
    flip = np.einsum("fd,fd->f", n, f_mid - cell_mid[cp]) < 0
    n[flip] *= -1.0

    f_havg = 0.5 * (diam[cp] + diam[cm])

    # --- exterior facets -------------------------------------------------------
    ne = mesh.ef_verts.shape[0]
    ex = verts[mesh.ef_verts]
    e_qp = np.einsum("qi,fid->fqd", lam_f, ex)
    e_mid = ex.mean(axis=1)
    e_c = mesh.ef_cells
    e_R = traces(e_c, e_qp)
    if d == 2:
        t = ex[:, 1] - ex[:, 0]
        e_area = np.linalg.norm(t, axis=1)
        en = np.stack([t[:, 1], -t[:, 0]], axis=1) / e_area[:, None]
    else:
        c = np.cross(ex[:, 1] - ex[:, 0], ex[:, 2] - ex[:, 0])
        nrm = np.linalg.norm(c, axis=1)
        e_area = 0.5 * nrm
        en = c / nrm[:, None]
    flip = np.einsum("fd,fd->f", en, e_mid - cell_mid[e_c]) < 0
    en[flip] *= -1.0

    # --- pad dummy interior-facet row -----------------------------------------
    def pad(a, fill=0):
        shape = (1,) + a.shape[1:]
        return np.concatenate([a, np.full(shape, fill, dtype=a.dtype)])

    f_gnp_p = f_gnm_p = None
    if degree > 1:
        # n . grad(basis) per facet quad point and side: grad phi_a(x_q) =
        # sum_i A[q,a,i] G[cell,i,:] (fem/basis.grad_coeffs)
        Ap = fe.grad_coeffs(lam_at(cp, f_qp), degree)   # (nf, nq, nd, d+1)
        Am = fe.grad_coeffs(lam_at(cm, f_qp), degree)
        gp = np.einsum("fqai,fid->fqad", Ap, G[cp])
        gm = np.einsum("fqai,fid->fqad", Am, G[cm])
        f_gnp_p = pad(np.einsum("fqad,fd->fqa", gp, n))
        f_gnm_p = pad(np.einsum("fqad,fd->fqa", gm, n))

    f_cp = pad(cp.astype(np.int64))
    f_cm = pad(cm.astype(np.int64))
    f_n = pad(n)
    f_area_p = pad(f_area)
    f_havg_p = pad(f_havg, fill=1.0)
    f_Rp_p = pad(f_Rp)
    f_Rm_p = pad(f_Rm)
    f_stag = pad(mesh.if_tags.astype(np.int32), fill=-1)
    f_qp_p = pad(f_qp)
    f_mid_p = pad(f_mid)

    # --- neighbor table for block-ELL SpMV -------------------------------------
    cf = mesh.cf_idx                              # (nc, d+1), nf = pad
    is_p = mesh.cf_is_plus
    other = np.where(is_p, f_cm[cf], f_cp[cf])
    other = np.where(cf == nf, np.arange(nc)[:, None], other)
    nbr = np.concatenate([np.arange(nc)[:, None], other], axis=1)

    return Geometry(
        d=d, nd=nd,
        vol=vol, G=G, diam=diam, cell_tag=mesh.cell_tags.astype(np.int32),
        cell_qp=cell_qp, w_c=w_c, Phi_c=Phi_c, cell_mid=cell_mid,
        f_cp=f_cp, f_cm=f_cm, f_n=f_n, f_area=f_area_p, f_havg=f_havg_p,
        f_Rp=f_Rp_p, f_Rm=f_Rm_p, f_stag=f_stag, f_qp=f_qp_p, f_mid=f_mid_p,
        w_f=w_f,
        e_c=e_c.astype(np.int64), e_n=en, e_area=e_area, e_R=e_R, e_qp=e_qp,
        e_tag=mesh.ef_tags.astype(np.int32),
        cf_idx=cf.astype(np.int64), cf_is_plus=is_p,
        nbr=nbr.astype(np.int64),
        degree=degree, nodes=nodes, A_c=A_c, f_gnp=f_gnp_p, f_gnm=f_gnm_p,
    )


@dataclasses.dataclass
class MembraneTables:
    """DLT0 membrane bookkeeping (replaces dlt_dof_extraction.py).

    Membrane facets are interior facets whose surface tag is in `tags`,
    concatenated in tag order so each tag owns a contiguous slice (the
    reference's per-tag MembraneModel instances, membrane.py:9-41).
    One extra dummy slot (index n_mem) pads non-membrane facets.
    """

    tags: Tuple[int, ...]
    slices: Dict[int, Tuple[int, int]]   # tag -> (start, stop)
    fidx: np.ndarray                     # (n_mem,) facet id of membrane dof m
    mem_of_facet: np.ndarray             # (nf+1,) mem id or n_mem
    midpoints: np.ndarray                # (n_mem, d) dof locations

    @property
    def n_mem(self) -> int:
        return len(self.fidx)

    def to_device(self, dtype=torch.float64, *, device):
        return {
            "fidx": torch.as_tensor(self.fidx.astype(np.int32), device=device),
            "mem_of_facet": torch.as_tensor(
                self.mem_of_facet.astype(np.int32), device=device),
            "midpoints": torch.as_tensor(self.midpoints, dtype=dtype,
                                         device=device),
        }


def cell_center_distance(mesh: Mesh):
    """Per-facet cell-center distances (reference CellCenterDistance,
    utils.py:126-164): for interior facets the distance between the two
    adjacent cell midpoints; for exterior facets midpoint-to-facet-center.
    Returns (interior (nf,), exterior (ne,))."""
    cmid = mesh.cell_midpoints()
    fmid_i = mesh.facet_midpoints(interior=True)
    fmid_e = mesh.facet_midpoints(interior=False)
    d_int = np.linalg.norm(
        cmid[mesh.if_cells[:, 0]] - cmid[mesh.if_cells[:, 1]], axis=1
    )
    d_ext = np.linalg.norm(cmid[mesh.ef_cells] - fmid_e, axis=1)
    return d_int, d_ext


def build_membrane_tables(mesh: Mesh, tags: Sequence[int]) -> MembraneTables:
    nf = mesh.num_interior_facets
    fidx_parts = []
    slices = {}
    start = 0
    for tag in sorted(tags):
        ids = np.flatnonzero(mesh.if_tags == tag)
        fidx_parts.append(ids)
        slices[int(tag)] = (start, start + len(ids))
        start += len(ids)
    fidx = (
        np.concatenate(fidx_parts) if fidx_parts else np.zeros(0, dtype=np.int64)
    ).astype(np.int64)
    mem_of_facet = np.full(nf + 1, len(fidx), dtype=np.int64)
    mem_of_facet[fidx] = np.arange(len(fidx))
    mids = mesh.vertices[mesh.if_verts].mean(axis=1)
    midpoints = mids[fidx] if len(fidx) else np.zeros((0, mesh.dim))
    return MembraneTables(
        tags=tuple(sorted(int(t) for t in tags)),
        slices=slices,
        fidx=fidx,
        mem_of_facet=mem_of_facet,
        midpoints=midpoints,
    )
