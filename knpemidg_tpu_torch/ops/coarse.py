"""The coarse and deflation part of the two-level preconditioner apply,
kernels K6 (the EMI apply, one system) and K7 (the ion-batched KNP apply),
in three steps over m systems (``csrc/two_level.cu``):

  restrict      r (m, nd, nc) -> chunk sums rc (m, n_agg) and the
                projections proj (m, nf) on the compartment one-hots, the
                moment fields and the Ritz fields (nf of them in all);
  solve         the equilibrated dense coarse solve (one refinement sweep
                when the data has ``As``) and the small deflation solves:
                zc (m, n_agg), coef (m, nf); three-level data (``d1inv``,
                build_two_level above max_dense) solves densely on the n2
                super-chunk sums of k2 chunks each and adds the level-1
                Jacobi sweep, zc = rc d1inv + z2[a / k2];
  prolong_add   out += broadcast zc + coef^T [OH; W; Wr], in place, then
                out *= the live mask (nd, nc) where one is given (the pair
                layout's masked apply).

:func:`coarse_add` runs the three in turn; on the card, operands without
deflation fields or ``As`` (the KNP apply, K7) take them in one cooperative
launch instead (``two_level_coarse``, ``two_level_coarse_batched``), with
the same bits.  Given the block-Jacobi operands of the apply's smoother
(``bj``, spmv.block_jacobi_operands), :func:`coarse_add` computes the whole
additive apply, out = P^-1 r + the coarse part: on the card at nd = 4 (the
cell layout, the full form) the block-Jacobi values are computed inside
the prolong-add or the one-launch apply (the folded apply: no kernel-B
launch, z never in memory, the same bits); elsewhere kernel B's apply
writes out first and the coarse part adds into it.

Each wrapper runs its plain torch version (``*_plain``) for tensors on the
CPU and launches its kernel for CUDA tensors; there is no fallback between
the two.  The kernels take nd = 4 (cell layout) and 2nd = 8 (pair layout),
and restrict and prolong_add nd = 3 (2D cells, the MMS verification path),
where every apply takes the three launches (the one-launch apply is built
for nd = 4 and 8).  K6 and K7 count their launches apart (``_batched`` for
K7), restrict and prolong_add their nd = 3 launches apart (``_nd3``), and
the solve and the one-launch apply their three-level forms (``_three``).
The three-level forms compute every product and sum rounded apart, so
their twins in the kernels' order (:func:`solve_ordered_plain`,
:func:`coarse_apply_ordered_plain`) equal them to the last bit.

The two-level data is frozen for a whole Krylov solve, so :func:`operands`
checks it once and builds the solve's workspace (:class:`CoarseWork`): the
buffers that restrict and solve write, the solve kernel's launch
parameters and the fields' span table.  A CUDA call then checks only the
vectors it is handed and allocates nothing; the solve is one cooperative
launch.  On the card, restrict and solve return the workspace's buffers,
which the next call of the same operands overwrites.

A field's span (:func:`field_spans`) is the range of cells [lo, hi) outside
which all its values are exactly zero: a compartment's one-hot and moment
fields are zero outside the compartment, whose cells are contiguous.  The
restrict and prolong kernels read each field only in the blocks its span
overlaps, with the same sums as a dense pass (``csrc/two_level.cu``).  The
spans are computed on the device once per field tensor (a cache keyed on
the tensor), so once per preconditioner build, not per solve.  The plain
versions stay dense.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _cuda
from .spmv import block_jacobi_apply

COARSE_ND = (3, 4, 8)     # restrict and prolong_add
FUSED_ND = (4, 8)         # the one-launch apply (tl_coarse_kernel)
FOLD_ND = (4,)            # the block-Jacobi apply folded into the prolong-add or
                          # the one-launch apply (the full form, the cell layout)
MAX_TILE = 1024       # a restrict block covers whole chunks of at most this many cells
MAX_SMEM = 232448     # dynamic shared memory bytes a block can have: the
                      # solve's 3 x the largest deflation group, restrict's
                      # tile of r and live list, prolong's live list
DEFAULT_SMEM = 48 * 1024   # above this a kernel's limit is raised once
RESTRICT_LOADS = 32   # field values a restrict thread loads per batch
RESTRICT_SLICES = 3   # at most this many restrict blocks share a tile's fields


class Coarse(NamedTuple):
    """Kernel operands of frozen two-level data, with a leading system axis
    on the coarse matrices; the deflation groups (None when absent) are
    shared by the systems.  Three-level data (``d1inv``) has its dense
    matrices on n2 super-chunks of k2 chunks each, n_agg <= n2 k2."""
    agg: int
    inv: torch.Tensor                  # (m, n2, n2); n2 = n_agg when two-level
    s: torch.Tensor                    # (m, n2)
    As: Optional[torch.Tensor]         # (m, n2, n2) or None
    OH: Optional[torch.Tensor]         # (n_comp, nc)
    comp: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]   # inv, s, As
    W: Optional[torch.Tensor]          # (nw, nd, nc)
    mom: Optional[Tuple[torch.Tensor, torch.Tensor]]                  # inv, s
    Wr: Optional[torch.Tensor]         # (nr, nd, nc)
    ritz: Optional[Tuple[torch.Tensor, torch.Tensor]]                 # inv, s
    batched: bool                      # K7 (counted apart from K6)
    d1inv: Optional[torch.Tensor] = None   # (m, n_agg): three-level, else None
    work: Optional["CoarseWork"] = None    # built by operands()

    @property
    def sizes(self):
        """(n_comp, nw, nr)."""
        return tuple(0 if t is None else t.shape[0] for t in (self.OH, self.W, self.Wr))

    @property
    def levels(self):
        """(n_agg, n2, k2): the chunks, the dense system's rows and the
        chunks a row sums (k2 = 1, n2 = n_agg when two-level)."""
        n2 = self.inv.shape[-1]
        if self.d1inv is None:
            return n2, n2, 1
        n_agg = self.d1inv.shape[-1]
        return n_agg, n2, -(-n_agg // n2)


def operands(data, agg: int, batched: bool) -> Coarse:
    """Pack two-level ``data`` (build_two_level plus the deflation entries)
    for the kernels: contiguous, the coarse matrices with a system axis
    (``batched`` data already has one), checked once, with the workspace
    of the solve's applies (:func:`work`)."""
    def c(t):
        return None if t is None else t.contiguous()

    def sys_axis(t):
        return None if t is None else (t if batched else t[None]).contiguous()

    def group(*keys):
        return tuple(c(data[k]) for k in keys) if keys[0] in data else None

    co = Coarse(agg=agg, inv=sys_axis(data["inv"]), s=sys_axis(data["s"]),
                As=sys_axis(data.get("As")), OH=c(data.get("comp_onehot")),
                comp=group("comp_inv", "comp_s", "comp_As"), W=c(data.get("mom_W")),
                mom=group("mom_inv", "mom_s"), Wr=c(data.get("ritz_W")),
                ritz=group("ritz_inv", "ritz_s"), batched=batched,
                d1inv=sys_axis(data.get("d1inv")))
    return co._replace(work=work(co))


def _name(entry, co: Coarse):
    """The launch counter of an entry: the three-level solve and one-launch
    apply count apart ("_three"; restrict and prolong_add are the same
    kernels at both depths)."""
    three = co.d1inv is not None and entry in ("solve", "coarse")
    return f"two_level_{entry}" + ("_three" if three else "") + (
        "_batched" if co.batched else "")


def _nd_name(name, nd):
    """The launch counter of restrict or prolong_add at r's nd."""
    return name if nd != 3 else name + "_nd3"


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def restrict_plain(co: Coarse, r):
    """(rc (m, n_agg), proj (m, nf)) of r (m, nd, nc)."""
    m, _, nc = r.shape
    n_agg = co.levels[0]
    rs = r.sum(dim=1)                                            # (m, nc)
    rp = torch.nn.functional.pad(rs, (0, n_agg * co.agg - nc))
    rc = rp.reshape(m, n_agg, co.agg).sum(dim=-1)
    parts = []
    if co.OH is not None:
        parts.append(torch.einsum("pc,mc->mp", co.OH, rs))
    if co.W is not None:
        parts.append(torch.einsum("wic,mic->mw", co.W, r))
    if co.Wr is not None:
        parts.append(torch.einsum("vic,mic->mv", co.Wr, r))
    proj = torch.cat(parts, dim=1) if parts else r.new_zeros((m, 0))
    return rc, proj


def _mv(A, x):
    """Batched matrix-vector product (m, n, n) x (m, n)."""
    return torch.einsum("mij,mj->mi", A, x)


def _super_sums(co: Coarse, rc, ordered=False):
    """rc2 (m, n2): the sums of rc (m, n_agg) over each super-chunk's k2
    chunks (zeros past n_agg); ``ordered``: in ascending order from the
    first, as the kernels add them."""
    n_agg, n2, k2 = co.levels
    rcp = torch.nn.functional.pad(rc, (0, n2 * k2 - n_agg)).reshape(rc.shape[0], n2, k2)
    if not ordered:
        return rcp.sum(dim=-1)
    acc = rcp[..., 0]
    for j in range(1, k2):
        acc = acc + rcp[..., j]
    return acc


def _prolong_levels(co: Coarse, rc, z2):
    """zc (m, n_agg) of the three-level solve: the level-1 Jacobi sweep
    rc d1inv plus each chunk's super-chunk value z2 (m, n2)."""
    n_agg, _, k2 = co.levels
    return rc * co.d1inv + z2.repeat_interleave(k2, dim=1)[:, :n_agg]


def solve_plain(co: Coarse, rc, proj):
    """(zc (m, n_agg), coef (m, nf)): the coarse values to prolong and the
    deflation coefficients (three-level data: the dense solve on the
    super-chunk sums, then :func:`_prolong_levels`)."""
    three = co.d1inv is not None
    rs = co.s * (_super_sums(co, rc) if three else rc)
    z = _mv(co.inv, rs)
    if co.As is not None:
        z = z + _mv(co.inv, rs - _mv(co.As, z))
    zc = co.s * z
    if three:
        zc = _prolong_levels(co, rc, zc)
    n_comp, nw, nr = co.sizes
    coefs = []
    if co.comp is not None:
        # one refinement sweep: the compartment system is the float32-fragile
        # piece (tiny membrane-scale eigenvalues)
        invc, sc, Asc = co.comp
        x = sc * proj[:, :n_comp]
        y = x @ invc.T
        y = y + (x - y @ Asc.T) @ invc.T
        coefs.append(sc * y)
    for grp, a, b in ((co.mom, n_comp, n_comp + nw), (co.ritz, n_comp + nw, n_comp + nw + nr)):
        if grp is not None:
            inv_g, s_g = grp
            coefs.append(s_g * ((s_g * proj[:, a:b]) @ inv_g.T))
    coef = torch.cat(coefs, dim=1) if coefs else proj.new_zeros((rc.shape[0], 0))
    return zc, coef


def prolong_add_plain(co: Coarse, out, zc, coef, mask=None):
    """out (m, nd, nc) += the prolonged coarse and deflation corrections, in
    place, then out *= ``mask`` (nd, nc) where given; returns out."""
    m, nd, nc = out.shape
    n_comp, nw, nr = co.sizes
    z = zc[:, :, None].expand(m, zc.shape[1], co.agg).reshape(m, -1)[:, :nc]
    if co.OH is not None:
        z = z + coef[:, :n_comp] @ co.OH
    v = z[:, None, :].expand(m, nd, nc)
    if co.W is not None:
        v = v + torch.einsum("mw,wic->mic", coef[:, n_comp:n_comp + nw], co.W)
    if co.Wr is not None:
        v = v + torch.einsum("mv,vic->mic", coef[:, n_comp + nw:], co.Wr)
    out.add_(v)
    return out if mask is None else out.mul_(mask)


def coarse_apply_plain(co: Coarse, out, r, mask=None):
    """The plain versions in turn: restrict, solve, prolong_add (masked
    where ``mask`` is given), into ``out`` in place; returns out."""
    return prolong_add_plain(co, out, *solve_plain(co, *restrict_plain(co, r)), mask)


# ---------------------------------------------------------------------------
# the three-level forms' twins in the kernels' order of operations
# ---------------------------------------------------------------------------

def _warp_mv(A, x):
    """A (m, n, k) x (m, k) -> (m, n), each row summed as a kernel's warp
    sums it (csrc/two_level.cu tl_row, small_matvec): lane l adds the
    products A[i, j] x[j], j = l mod 32, in increasing j from zero, then
    the xor-shuffle tree (16, 8, 4, 2, 1); every product rounded apart."""
    m, n, k = A.shape
    kp = -(-k // 32) * 32
    prod = torch.nn.functional.pad(A * x[:, None, :], (0, kp - k)).reshape(m, n, kp // 32, 32)
    acc = torch.zeros((m, n, 32), dtype=A.dtype, device=A.device)
    for u in range(kp // 32):
        acc = acc + prod[:, :, u]
    lane = torch.arange(32, device=A.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ o]
    return acc[..., 0]


def solve_ordered_plain(co: Coarse, rc, proj):
    """:func:`solve_plain` of three-level operands in the three-level solve
    kernel's order of operations, so that it equals the kernel to the last
    bit: the k2-sums ascending, x2 = s rc2, each dense and small product a
    warp's (:func:`_warp_mv`), z1 = inv x2, t = x2 - As z1, z2 = s (z1 +
    inv t) (without As z2 = s (inv x2)), zc = rc d1inv + z2; the small
    solves as the kernel's blocks run them.  For the tests and
    chip_smoke.py; the wrappers' CPU path keeps :func:`solve_plain`."""
    if co.d1inv is None:
        raise ValueError("solve_ordered_plain: the twin of the three-level solve only")
    x2 = co.s * _super_sums(co, rc, ordered=True)
    z1 = _warp_mv(co.inv, x2)
    if co.As is not None:
        z2 = co.s * (z1 + _warp_mv(co.inv, x2 - _warp_mv(co.As, z1)))
    else:
        z2 = co.s * z1
    zc = _prolong_levels(co, rc, z2)
    n_comp, nw, nr = co.sizes
    m = rc.shape[0]
    coefs = []
    if co.comp is not None:
        invc, sc, Asc = (t[None].expand(m, *t.shape) for t in co.comp)
        x = sc * proj[:, :n_comp]
        y = _warp_mv(invc, x)
        y = y + _warp_mv(invc, x - _warp_mv(Asc, y))
        coefs.append(sc * y)
    for grp, a, b in ((co.mom, n_comp, n_comp + nw), (co.ritz, n_comp + nw, n_comp + nw + nr)):
        if grp is not None:
            inv_g, s_g = grp
            coefs.append(s_g * _warp_mv(inv_g[None].expand(m, *inv_g.shape), s_g * proj[:, a:b]))
    coef = torch.cat(coefs, dim=1) if coefs else proj.new_zeros((m, 0))
    return zc, coef


def coarse_apply_ordered_plain(co: Coarse, out, r, mask=None):
    """The three-level one-launch apply (operands without fields or As) in
    the kernel's order: the chunk sums (each cell's sum over nd in order,
    then each chunk's in cell order, the last chunk's pad cells adding +0),
    :func:`solve_ordered_plain`, then out = (out + zc[c / agg]) (* mask),
    in place; returns out.  The folded apply's out is kernel B's apply."""
    if co.d1inv is None or co.As is not None or any(co.sizes):
        raise ValueError("coarse_apply_ordered_plain: the twin of the three-level one-launch "
                         "apply (no fields, no As) only")
    m, nd, nc = r.shape
    rs = r[:, 0]
    for i in range(1, nd):
        rs = rs + r[:, i]
    n_agg = co.levels[0]
    rp = torch.nn.functional.pad(rs, (0, n_agg * co.agg - nc)).reshape(m, n_agg, co.agg)
    rc = rp[..., 0]
    for j in range(1, co.agg):
        rc = rc + rp[..., j]
    zc, _ = solve_ordered_plain(co, rc, r.new_zeros((m, 0)))
    z = zc.repeat_interleave(co.agg, dim=1)[:, None, :nc]
    out.add_(z)
    return out if mask is None else out.mul_(mask)


# ---------------------------------------------------------------------------
# the fields' spans, once per field tensor
# ---------------------------------------------------------------------------

def field_spans(F):
    """int32 (k, 2) [lo, hi) per field of F (k, nc) or (k, nd, nc): the
    first and one-past-last cell at which any of the field's values is
    nonzero (NaN counts as nonzero); (0, 0) for an all-zero field.  On F's
    device, without a host read."""
    nz = F != 0
    if nz.dim() == 3:
        nz = nz.any(dim=1)
    nc = nz.shape[-1]
    cells = torch.arange(nc, device=F.device)
    lo = torch.where(nz, cells, nc).amin(dim=1)
    hi = torch.where(nz, cells + 1, 0).amax(dim=1)
    live = hi > lo
    return torch.stack([torch.where(live, lo, 0), torch.where(live, hi, 0)],
                       dim=1).to(torch.int32)


_SPANS = WeakIdKeyDictionary()     # field tensor -> (its version, its spans)
_TABLES = WeakIdKeyDictionary()    # first field -> (the fields' spans, their table)


def _spans_of(F):
    """field_spans(F), computed once per tensor and in-place version."""
    hit = _SPANS.get(F)
    if hit is None or hit[0] != F._version:
        hit = _SPANS[F] = (F._version, field_spans(F))
    return hit[1]


def _span_table(fields):
    """The (nf, 2) span table of the fields in order (one-hots, W, Wr),
    concatenated once for the same field tensors."""
    parts = [_spans_of(t) for t in fields]
    hit = _TABLES.get(fields[0])
    if hit is None or len(hit[0]) != len(parts) or any(
            a is not b for a, b in zip(hit[0], parts)):
        hit = _TABLES[fields[0]] = (parts, torch.cat(parts))
    return hit[1]


# ---------------------------------------------------------------------------
# the workspace, built once per solve
# ---------------------------------------------------------------------------

_SOLVE_PTRS = ("inv", "s", "As", "z1", "t", "zc", "coef", "invc", "sc", "Asc", "inv_m",
               "s_m", "inv_r", "s_r", "d1inv")


class _SolveParams(ctypes.Structure):
    """``TlSolve<T>`` of ``csrc/two_level.cu``, field for field."""
    _fields_ = [(k, ctypes.c_void_p) for k in _SOLVE_PTRS] + [
        (k, ctypes.c_int) for k in ("m", "n", "n_comp", "nw", "nr", "grid", "smem", "n1",
                                    "k2", "pad")]


class CoarseWork(NamedTuple):
    """What one solve's coarse applies need besides r and out (built by
    :func:`work`): the frozen operands it was checked on (kept alive, as
    the launch parameters hold their addresses), their sizes, the output
    buffers of restrict and solve, and the kernels' fixed arguments."""
    ops: Coarse                        # the operands, without work
    m: int                             # systems
    n: int                             # chunks (n_agg)
    n2: int                            # the dense system's rows (n_agg when two-level)
    nd: Optional[int]                  # the fields' dofs and cells (None without fields)
    nc: Optional[int]
    rc: torch.Tensor                   # (m, n)   restrict
    proj: torch.Tensor                 # (m, nf)  restrict
    partial: torch.Tensor              # (m, nf, blocks) restrict's block sums
    zc: torch.Tensor                   # (m, n)   solve
    coef: torch.Tensor                 # (m, nf)  solve
    z1: Optional[torch.Tensor]         # (m, n2)  solve's refinement (with As)
    t: Optional[torch.Tensor]
    spans: Optional[torch.Tensor]      # (nf, 2) int32 [lo, hi) of OH, W, Wr rows
    names: Tuple[str, str, str]        # launch counters of restrict, solve, prolong
    fields: tuple                      # addresses of OH, W, Wr, spans (None when absent)
    restrict_tail: tuple               # agg, n, chunks per block, n_comp, nw, nr, slices
    prolong_tail: tuple                # agg, n, n_comp, nw, nr
    params: Optional[_SolveParams]     # the solve kernel's, on the card only
    params_ptr: Optional[int]
    cpt: int                           # chunks a restrict tile
    fused: Optional[Tuple[str, int, int, int]]  # the one-launch apply's launch counter
                                                # and grids (nd = 4, nd = 8, nd = 4 with
                                                # the block-Jacobi apply folded in), on
                                                # the card without fields or As


def _ptr(t):
    return None if t is None else t.data_ptr()


def work(co: Coarse) -> CoarseWork:
    """Check the frozen operands once -- one device, one float dtype,
    contiguous, consistent shapes, the deflation groups matching their
    fields -- and allocate the buffers that restrict and solve write; take
    the fields' span table (computed once per field tensor).  On the card
    also the solve kernel's launch parameters, its grid sized once to the
    co-resident limit, and the kernels' limits.  Three-level operands
    (``d1inv``) have n = n_agg chunks and a dense system of n2 rows."""
    inv = co.inv
    dt, dev = inv.dtype, inv.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"two_level operands: expected float32/float64, got {dt}")
    if inv.dim() != 3 or inv.shape[1] != inv.shape[2]:
        raise ValueError("two_level operands: inv must be (m, n2, n2)")
    m, n2 = inv.shape[0], inv.shape[1]
    n = n2 if co.d1inv is None else co.d1inv.shape[-1]

    def need(name, t, shape):
        if t.device != dev:
            raise ValueError(f"two_level operands: {name} is on {t.device}, inv on {dev}")
        if t.dtype != dt:
            raise TypeError(f"two_level operands: {name} is {t.dtype}, inv {dt}")
        if not t.is_contiguous():
            raise ValueError(f"two_level operands: {name} is not contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"two_level operands: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")

    need("inv", inv, (m, n2, n2))
    need("s", co.s, (m, n2))
    if co.As is not None:
        need("As", co.As, (m, n2, n2))
    k2 = 1
    if co.d1inv is not None:
        need("d1inv", co.d1inv, (m, n))
        k2 = -(-n // n2)
        if n2 * k2 - n >= k2:
            raise ValueError(f"two_level operands: {n} chunks do not fill {n2} super-chunks "
                             f"of {k2}")
    n_comp, nw, nr = co.sizes
    fields = [("comp_onehot", co.OH), ("mom_W", co.W), ("ritz_W", co.Wr)]
    nc = next((t.shape[-1] for _, t in fields if t is not None), None)
    nd = next((t.shape[1] for _, t in fields[1:] if t is not None and t.dim() == 3), None)
    for name, t in fields:
        if t is not None:
            need(name, t, (t.shape[0], nc) if t is co.OH else (t.shape[0], nd, nc))
    if nc is not None and n != -(-nc // co.agg):
        raise ValueError("two_level operands: coarse size does not match the chunks")
    for name, grp, k in (("comp", co.comp, n_comp), ("mom", co.mom, nw),
                         ("ritz", co.ritz, nr)):
        if (grp is None) != (k == 0):
            raise ValueError(f"two_level operands: {name} fields and Galerkin data disagree")
        for i, t in enumerate(grp or ()):
            need(f"{name}[{i}]", t, (k,) if t.dim() == 1 else (k, k))
    if inv.is_cuda and co.agg > MAX_TILE:
        raise NotImplementedError(
            f"two_level restrict: chunks above {MAX_TILE} cells are not supported")
    nf = n_comp + nw + nr
    cpt = max(1, 256 // co.agg)                  # chunks per restrict block
    tile, elt = cpt * co.agg, inv.element_size()
    nd_r = nd or max(COARSE_ND)                  # r's nd is known by then (one-hots only)
    # the three-level solve stages the m systems' x2 = s rc2 in each block
    stage = m * n2 * elt if co.d1inv is not None else 0
    smem = {"solve": 3 * max(n_comp, nw, nr) * elt + stage, "coarse": stage,
            "restrict": tile * elt + ((nd_r * tile * elt + 4 * nf) if nf else 0),
            "prolong": 4 * (nw + nr)}
    for entry, need_b in smem.items():
        if inv.is_cuda and need_b > MAX_SMEM:
            raise NotImplementedError(
                f"two_level {entry}: the fields or chunks are too large for a block's "
                f"shared memory")
    # restrict slices per tile: the batches of the fields live in a tile of
    # one compartment (its one-hot, its moment fields, every Ritz field), at
    # most RESTRICT_SLICES (the fastest of 1-8 at both layouts' main path)
    per_comp = nw // n_comp if n_comp else nw
    live = min(n_comp, 1) + per_comp + nr
    batch = RESTRICT_LOADS // nd_r
    zs = max(1, min(RESTRICT_SLICES, -(-live // batch))) if nf else 1
    spans = _span_table([t for t in (co.OH, co.W, co.Wr) if t is not None]) if nf else None

    def buf(*shape):
        return torch.empty(shape, dtype=dt, device=dev)

    refine = co.As is not None
    ops = co._replace(work=None)
    wk = CoarseWork(
        ops=ops, m=m, n=n, n2=n2, nd=nd, nc=nc, rc=buf(m, n), proj=buf(m, nf),
        partial=buf(m, nf, -(-n // cpt)), zc=buf(m, n), coef=buf(m, nf),
        z1=buf(m, n2) if refine else None, t=buf(m, n2) if refine else None, spans=spans,
        names=tuple(_name(e, co) for e in ("restrict", "solve", "prolong")),
        fields=(_ptr(co.OH), _ptr(co.W), _ptr(co.Wr), _ptr(spans)),
        restrict_tail=(co.agg, n, cpt, n_comp, nw, nr, zs),
        prolong_tail=(co.agg, n, n_comp, nw, nr), params=None, params_ptr=None, cpt=cpt,
        fused=None)
    if not inv.is_cuda:
        return wk
    if max(smem["restrict"], smem["prolong"]) > DEFAULT_SMEM:
        with torch.cuda.device(dev):
            _cuda.call("knp_tl_fields_prepare", dt, max(smem["restrict"], smem["prolong"]))
    groups = (co.comp or (None,) * 3) + (co.mom or (None,) * 2) + (co.ritz or (None,) * 2)
    params = _SolveParams(*(_ptr(t) for t in (inv, co.s, co.As, wk.z1, wk.t, wk.zc, wk.coef)
                            + groups + (co.d1inv,)), m, n2, n_comp, nw, nr, 0, 0, n, k2, 0)
    fused = None
    with torch.cuda.device(dev):
        _cuda.call("knp_tl_solve_prepare", dt, ctypes.addressof(params))
        if nf == 0 and not refine:
            grids = (ctypes.c_int * 3)()
            _cuda.call("knp_tl_coarse_prepare", dt, ctypes.addressof(params), co.agg, cpt,
                       grids)
            fused = (_name("coarse", co), *grids)
    return wk._replace(params=params, params_ptr=ctypes.addressof(params), fused=fused)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _work(co: Coarse, entry: str) -> CoarseWork:
    wk = co.work
    if wk is None or wk.params is None:
        raise ValueError(f"two_level {entry}: the operands carry no workspace on the card; "
                         f"build them with coarse.operands from CUDA tensors")
    if wk.proj.shape[1] and (wk.spans is None or not wk.spans.is_cuda):
        raise ValueError(f"two_level {entry}: the workspace carries no span table on the "
                         f"card; build it with coarse.operands")
    return wk


def _check_cells(entry, wk: CoarseWork, name, x, agg):
    """x (m, nd, nc) handed to restrict or prolong_add: on the card, the
    operands' dtype, contiguous, shaped as the operands' fields and chunks.
    Returns (m, nd, nc)."""
    _cuda.check(name, x, wk.rc.dtype)
    if x.dim() != 3 or x.shape[0] != wk.m:
        raise ValueError(f"two_level {entry}: expected {name} of shape ({wk.m}, nd, nc)")
    m, nd, nc = x.shape
    if nd not in COARSE_ND:
        raise NotImplementedError(
            f"two_level {entry}: CUDA kernel built for nd in {COARSE_ND}, got nd = {nd}")
    if wk.nd is not None and (nd, nc) != (wk.nd, wk.nc):
        raise ValueError(f"two_level {entry}: {name} does not match the deflation fields")
    if wk.n != -(-nc // agg):
        raise ValueError(f"two_level {entry}: coarse size does not match the chunks")
    return m, nd, nc


def restrict(co: Coarse, r):
    """Chunk sums and field projections (the restrict kernel on a CUDA
    tensor): (rc (m, n_agg), proj (m, nf)); on the card the workspace's
    buffers."""
    if not r.is_cuda:
        return restrict_plain(co, r)
    wk = _work(co, "restrict")
    m, nd, nc = _check_cells("restrict", wk, "r", r, co.agg)
    _cuda.launch(_nd_name(wk.names[0], nd), "knp_tl_restrict", r.dtype, r.data_ptr(),
                 *wk.fields, wk.rc.data_ptr(), wk.proj.data_ptr(), wk.partial.data_ptr(), m,
                 nd, nc, *wk.restrict_tail)
    return wk.rc, wk.proj


def solve(co: Coarse, rc, proj):
    """Dense coarse and small deflation solves (one launch of the solve
    kernel on a CUDA tensor): (zc (m, n_agg), coef (m, nf)); on the card the
    workspace's buffers.  restrict's own outputs need no check."""
    if not rc.is_cuda:
        return solve_plain(co, rc, proj)
    wk = _work(co, "solve")
    if rc is not wk.rc or proj is not wk.proj:
        _cuda.check("rc", rc, wk.rc.dtype, wk.rc.shape)
        _cuda.check("proj", proj, wk.rc.dtype, wk.proj.shape)
    _cuda.launch(wk.names[1], "knp_tl_solve", rc.dtype, wk.params_ptr, rc.data_ptr(),
                 proj.data_ptr())
    return wk.zc, wk.coef


_MASKS = WeakIdKeyDictionary()     # live mask -> (dtype, nd, nc) it was checked for


def _mask_ptr(mask, dtype, nd, nc):
    """The live mask's address (None without one), the mask checked once per
    tensor: on the card, contiguous, of the output's dtype, (nd, nc)."""
    if mask is None:
        return None
    if _MASKS.get(mask) != (dtype, nd, nc):
        _cuda.check("mask", mask, dtype, (nd, nc))
        _MASKS[mask] = (dtype, nd, nc)
    return mask.data_ptr()


def _bj_ptrs(bj, r, m, nd, nc):
    """(Pinv, r) addresses of the folded apply, the operands checked
    against r (m, nd, nc): the full form of m systems' (nd, nd, nc) blocks
    (one system's without a leading axis) in r's dtype on the card."""
    if bj.halves or bj.tail[:3] != (m, nd, nc) or bj.Pinv.dtype != r.dtype:
        raise ValueError(f"two_level: block-Jacobi operands of shape {tuple(bj.Pinv.shape)} "
                         f"and form halves={bj.halves} do not fold into an apply to r of "
                         f"shape {tuple(r.shape)}, {r.dtype}")
    return bj.Pinv.data_ptr(), r.data_ptr()


def prolong_add(co: Coarse, out, zc, coef, mask=None, bj=None, r=None):
    """out += the prolonged corrections, in place, then out *= ``mask``
    (nd, nc) where given (the prolong kernel on a CUDA tensor); returns
    out.  With the block-Jacobi operands ``bj`` and r: out is not read but
    set to bj's apply to r plus the corrections (on the card the folded
    kernel, nd = 4 and the full form only)."""
    if not out.is_cuda:
        if bj is not None:
            block_jacobi_apply(bj, r, out=out)
        return prolong_add_plain(co, out, zc, coef, mask)
    wk = _work(co, "prolong_add")
    m, nd, nc = _check_cells("prolong_add", wk, "out", out, co.agg)
    if zc is not wk.zc or coef is not wk.coef:
        _cuda.check("zc", zc, out.dtype, wk.zc.shape)
        _cuda.check("coef", coef, out.dtype, wk.coef.shape)
    fold = (None, None)
    if bj is not None:
        if nd not in FOLD_ND:
            raise NotImplementedError(f"two_level prolong_add: the folded block-Jacobi "
                                      f"apply is built for nd in {FOLD_ND}, got nd = {nd}")
        _cuda.check("r", r, out.dtype, out.shape)
        fold = _bj_ptrs(bj, r, m, nd, nc)
    _cuda.launch(_nd_name(wk.names[2], nd), "knp_tl_prolong", out.dtype, out.data_ptr(),
                 zc.data_ptr(), coef.data_ptr(), *wk.fields, _mask_ptr(mask, out.dtype, nd, nc),
                 *fold, m, nd, nc, *wk.prolong_tail)
    return out


def coarse_add(co: Coarse, out, r, mask=None, bj=None):
    """out (m, nd, nc) += the coarse and deflation part of the two-level
    apply to r (m, nd, nc), in place, then out *= ``mask`` (nd, nc) where
    given; returns out.  With the block-Jacobi operands ``bj`` of the
    apply's smoother (one system's without a leading axis, or m systems'):
    out is not read but set to the whole additive apply, bj's apply to r
    plus the coarse part (times the mask).  Dispatched by operand: on the
    card, operands without deflation fields or As (the KNP apply, K7) take
    one cooperative launch of the chunk sums, the coarse solve and the
    prolong-add (with the mask), a grid barrier between each, at nd = 4
    and 8; the others (K6), and every apply at nd = 3, restrict, solve and
    prolong_add, three launches.  At nd = 4 a full-form ``bj`` folds into
    the one-launch apply or the prolong-add (no launch of its own); other
    forms and sizes launch kernel B's apply into out first.  On the CPU
    the plain versions in turn."""
    if r.is_cuda:
        wk = _work(co, "coarse_add")
        fold = bj is not None and r.dim() == 3 and r.shape[1] in FOLD_ND
        if wk.fused is not None and r.dim() == 3 and r.shape[1] in FUSED_ND:
            m, nd, nc = _check_cells("coarse_add", wk, "r", r, co.agg)
            if out is not r:
                _cuda.check("out", out, r.dtype, r.shape)
            pinv = None
            if fold:
                pinv = _bj_ptrs(bj, r, m, nd, nc)[0]
            elif bj is not None:
                block_jacobi_apply(bj, r, out=out)
            _cuda.launch(wk.fused[0], "knp_tl_coarse", r.dtype, wk.params_ptr, r.data_ptr(),
                         out.data_ptr(), _mask_ptr(mask, r.dtype, nd, nc), wk.rc.data_ptr(),
                         pinv, nd, nc, co.agg, wk.cpt,
                         wk.fused[3] if fold else wk.fused[1 + (nd == 8)])
            return out
        if bj is not None and not fold:
            block_jacobi_apply(bj, r, out=out)
            bj = None
    rc, proj = restrict(co, r)
    zc, coef = solve(co, rc, proj)
    return prolong_add(co, out, zc, coef, mask, bj, r)
