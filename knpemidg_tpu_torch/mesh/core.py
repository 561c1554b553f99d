"""Host-side mesh representation and topology construction.

Copy of knpemidg_tpu/mesh/core.py with the numpy facet path only (the
C++ meshkit of the JAX package builds identical tables).

This replaces the DOLFIN C++ mesh layer of the reference (N1 in SURVEY.md):
`Mesh`, `MeshFunction` tags, facet iteration, and the ghost/ownership
machinery all collapse into dense numpy index arrays built once here, then
shipped to device as static-shape int32/float arrays.

Geometry/tag conventions follow the reference exactly
(src/knpemidg/solver.py:45-60, README.md:65-72):

* ECS cells are tagged 0, ICS cells 1, 2, ...;
* interior facets between cells of *equal* tag carry surface tag 0 and get
  the standard DG (SIP + upwind) coupling;
* interior facets between cells of *different* tags are membrane facets; the
  interface normal points from the lower tag to the higher tag (ECS -> ICS),
  i.e. our canonical "plus" side is the ECS/lower-tag cell (= `plus()` in
  utils.py:87-91) and "minus" is the ICS cell, so
  ``JUMP(f) = f_minus - f_plus = f_i - f_e`` (solver.py:14);
* interior facets whose surface tag is neither 0 nor a membrane-model tag
  receive *no* facet integrals (the reference's dS(tag) measures simply skip
  them, e.g. the remapped tag-10 facets of run_EMIx_simulation.py:204-216).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass
class Mesh:
    """Simplicial mesh with subdomain (cell) and surface (facet) tags.

    Facet-related arrays are in *canonical facet order* (lexicographic by
    sorted vertex tuple) and split into interior / exterior lists.
    """

    vertices: np.ndarray          # (nv, d) float64
    cells: np.ndarray             # (nc, d+1) int64 vertex ids
    cell_tags: np.ndarray         # (nc,) int32 subdomain tags

    # interior facets ------------------------------------------------------
    if_verts: np.ndarray          # (nf, d) vertex ids (sorted)
    if_cells: np.ndarray          # (nf, 2) [cell_plus, cell_minus]
    if_tags: np.ndarray           # (nf,) int32 surface tag

    # exterior facets ------------------------------------------------------
    ef_verts: np.ndarray          # (ne, d)
    ef_cells: np.ndarray          # (ne,)
    ef_tags: np.ndarray           # (ne,) int32

    # cell -> interior-facet incidence (for gather-only assembly/SpMV) ------
    cf_idx: np.ndarray            # (nc, d+1) interior facet id or nf (pad)
    cf_is_plus: np.ndarray        # (nc, d+1) bool: this cell is the facet's plus side

    @property
    def dim(self) -> int:
        return self.vertices.shape[1]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_interior_facets(self) -> int:
        return self.if_cells.shape[0]

    def facet_midpoints(self, interior: bool = True) -> np.ndarray:
        verts = self.if_verts if interior else self.ef_verts
        return self.vertices[verts].mean(axis=1)

    def cell_midpoints(self) -> np.ndarray:
        return self.vertices[self.cells].mean(axis=1)

    def hmin(self) -> float:
        """Minimum cell diameter, parity with dolfin ``mesh.hmin()``
        (used by tests/run_MMS_space.py:267).  dolfin's hmin is the minimum
        circumdiameter for simplices; for the convergence-rate ratios only
        the scaling matters, so we use the min edge-based diameter."""
        x = self.vertices[self.cells]  # (nc, d+1, d)
        d = x.shape[2]
        hmax = np.zeros(self.num_cells)
        for i in range(d + 1):
            for j in range(i + 1, d + 1):
                hmax = np.maximum(hmax, np.linalg.norm(x[:, i] - x[:, j], axis=1))
        return float(hmax.min())


def reorder_cells(mesh: "Mesh", perm: np.ndarray) -> "Mesh":
    """Renumber cells by permutation `perm` (new_index -> old_index),
    remapping every cell-referencing table consistently.  Facet identities,
    tags and orientations are unchanged."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Mesh(
        vertices=mesh.vertices,
        cells=mesh.cells[perm],
        cell_tags=mesh.cell_tags[perm],
        if_verts=mesh.if_verts,
        if_cells=inv[mesh.if_cells],
        if_tags=mesh.if_tags,
        ef_verts=mesh.ef_verts,
        ef_cells=inv[mesh.ef_cells],
        ef_tags=mesh.ef_tags,
        cf_idx=mesh.cf_idx[perm],
        cf_is_plus=mesh.cf_is_plus[perm],
    )


SurfaceTagSpec = Union[None, np.ndarray, Dict[tuple, int], Callable[[np.ndarray], np.ndarray]]


def morton_order(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-order (Morton) permutation of points for gather locality: cells
    renumbered along a space-filling curve keep their facet neighbors in
    nearby rows, which tightens the block-ELL gathers and makes contiguous
    chunks usable as preconditioner aggregates."""
    p = points - points.min(axis=0)
    scale = p.max(axis=0)
    scale[scale == 0] = 1.0
    q = np.minimum((p / scale * (2**bits - 1)).astype(np.uint64), 2**bits - 1)
    code = np.zeros(len(points), dtype=np.uint64)
    d = points.shape[1]
    for b in range(bits):
        for ax in range(d):
            code |= ((q[:, ax] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * d + ax)
    return np.argsort(code, kind="stable")


def build_mesh(
    vertices: np.ndarray,
    cells: np.ndarray,
    cell_tags: np.ndarray,
    surface_tags: SurfaceTagSpec = None,
    membrane_tag_from_cells: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
    reorder: Optional[str] = "morton",
) -> Mesh:
    """Build full facet topology with canonical membrane orientation.

    surface_tags may be:
      * None            -- all facets tagged 0 (membrane facets must then be
                           tagged via `membrane_tag_from_cells`),
      * callable(mids)  -- vectorized geometric marker on facet midpoints,
                           applied to all facets (like the reference's
                           SubDomain markers, tests/make_mesh_MMS.py:89-102),
      * dict            -- sorted-vertex-tuple -> tag (file loaders).

    membrane_tag_from_cells(midpoints, tag_lo, tag_hi) -> facet tag, applied
    to interior facets whose two cells have different subdomain tags; used by
    generators/loaders that derive membranes from cell-label adjacency
    (run_rat_neuron.py:192-201).
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int64)
    cell_tags = np.asarray(cell_tags, dtype=np.int32)
    if reorder == "morton":
        perm = morton_order(vertices[cells].mean(axis=1))
        cells = cells[perm]
        cell_tags = cell_tags[perm]
    nc, nvc = cells.shape
    d = vertices.shape[1]
    assert nvc == d + 1, "simplicial meshes only"

    # enumerate all (cell, local facet) pairs; local facet i = all vertices
    # except local vertex i
    loc = np.array([[j for j in range(d + 1) if j != i] for i in range(d + 1)])
    fv = cells[:, loc]                       # (nc, d+1, d)
    fv = np.sort(fv, axis=2)
    flat = fv.reshape(-1, d)                 # (nc*(d+1), d)
    owner_cell = np.repeat(np.arange(nc), d + 1)
    owner_loc = np.tile(np.arange(d + 1), nc)

    order = np.lexsort(flat.T[::-1])
    flat_s = flat[order]
    same = np.all(flat_s[1:] == flat_s[:-1], axis=1)
    starts = np.flatnonzero(np.concatenate([[True], ~same]))
    counts = np.diff(np.concatenate([starts, [flat_s.shape[0]]]))
    if counts.max() > 2:
        raise ValueError("non-manifold mesh")

    int_g = starts[counts == 2]
    ext_g = starts[counts == 1]

    if_verts = flat_s[int_g]
    ca = owner_cell[order[int_g]]
    cb = owner_cell[order[int_g + 1]]
    la = owner_loc[order[int_g]]
    lb = owner_loc[order[int_g + 1]]
    ef_verts = flat_s[ext_g]
    ef_cells = owner_cell[order[ext_g]].astype(np.int64)

    # --- canonical orientation: plus = ECS / lower subdomain tag ----------
    ta, tb = cell_tags[ca], cell_tags[cb]
    # tie-break equal tags by cell index (orientation-invariant terms only)
    swap = (tb < ta) | ((tb == ta) & (cb < ca))
    cp = np.where(swap, cb, ca)
    cm = np.where(swap, ca, cb)
    if_cells = np.stack([cp, cm], axis=1).astype(np.int64)

    # --- surface tags ------------------------------------------------------
    nf = if_verts.shape[0]
    ne = ef_verts.shape[0]
    if_tags = np.zeros(nf, dtype=np.int32)
    ef_tags = np.zeros(ne, dtype=np.int32)
    if callable(surface_tags):
        if_tags = np.asarray(
            surface_tags(vertices[if_verts].mean(axis=1)), dtype=np.int32
        )
        ef_tags = np.asarray(
            surface_tags(vertices[ef_verts].mean(axis=1)), dtype=np.int32
        )
    elif isinstance(surface_tags, dict):
        for i, key in enumerate(map(tuple, if_verts)):
            if_tags[i] = surface_tags.get(key, 0)
        for i, key in enumerate(map(tuple, ef_verts)):
            ef_tags[i] = surface_tags.get(key, 0)
    elif isinstance(surface_tags, np.ndarray):
        raise ValueError("array surface tags must be passed as a dict keyed by facet vertices")

    if membrane_tag_from_cells is not None:
        diff = cell_tags[cp] != cell_tags[cm]
        lo = np.minimum(cell_tags[cp], cell_tags[cm])[diff]
        hi = np.maximum(cell_tags[cp], cell_tags[cm])[diff]
        mids = vertices[if_verts[diff]].mean(axis=1)
        if_tags[diff] = np.asarray(
            membrane_tag_from_cells(mids, lo, hi), dtype=np.int32
        )

    # --- cell -> facet incidence (gather maps) -----------------------------
    cf_idx = np.full((nc, d + 1), nf, dtype=np.int64)
    cf_is_plus = np.zeros((nc, d + 1), dtype=bool)
    fid = np.arange(nf)
    cf_idx[ca, la] = fid
    cf_is_plus[ca, la] = ca == cp
    cf_idx[cb, lb] = fid
    cf_is_plus[cb, lb] = cb == cp

    mesh = Mesh(
        vertices=vertices,
        cells=cells,
        cell_tags=cell_tags,
        if_verts=if_verts.astype(np.int64),
        if_cells=if_cells,
        if_tags=if_tags,
        ef_verts=ef_verts.astype(np.int64),
        ef_cells=ef_cells,
        ef_tags=ef_tags,
        cf_idx=cf_idx,
        cf_is_plus=cf_is_plus,
    )
    if reorder == "morton":
        # secondary sort by connected compartment (stable, preserves Morton
        # within compartments): contiguous cell chunks then never straddle a
        # membrane, which the two-level preconditioner exploits to keep its
        # coarse restrict/prolong gather-free (solvers/twolevel.py)
        comp = _compartments(mesh)
        mesh = reorder_cells(mesh, np.argsort(comp, kind="stable"))
    return mesh


def _compartments(mesh: "Mesh") -> np.ndarray:
    """Connected components of the same-subdomain-tag cell graph."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    cp, cm = mesh.if_cells[:, 0], mesh.if_cells[:, 1]
    same = mesh.cell_tags[cp] == mesh.cell_tags[cm]
    A = sp.coo_matrix(
        (np.ones(int(same.sum())), (cp[same], cm[same])),
        shape=(mesh.num_cells, mesh.num_cells),
    )
    _, labels = csgraph.connected_components(A, directed=False)
    return labels.astype(np.int64)
