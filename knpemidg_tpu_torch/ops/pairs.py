"""Pair-block operator layout (torch port of knpemidg_tpu/ops/pairs.py):
2-cell macro rows for the Krylov path.

Face-adjacent cells of one compartment are matched into pairs, and the
operator is stored as a (2nd x 2nd) pair diagonal block plus S = 2d
external slots of (2nd x nd) blocks per pair, gathered through ``ext_col``.
Fields and right-hand sides stay cell-indexed; each solve converts its
vectors once.  Unmatched cells become self-pairs whose second half is dead:
identity diagonal, zero rhs and iterate.

With the interleaved cell numbering (:func:`interleave_pair_maps`, the only
form the device functions take) pair p occupies cell slots (2p, 2p+1), so
the cell<->pair conversions are relayouts without an index map.

Kernels (CUDA tensors; plain torch ``*_plain`` for CPU tensors, no
fallback between the two):

* K3 ``csrc/pair_matvec.cu``: :func:`pair_matvec`, :func:`pair_matvec_multi`;
* K4 ``csrc/pair_relayout.cu``: :func:`to_pair`, :func:`from_pair`;
* K12 ``csrc/pair_emit.cu``: :func:`gather_blocks_pair` (with ``reg`` also
  the EMI preconditioner diagonal), :func:`gather_blocks_pair_multi` (with
  ``add`` the static KNP operator added in the same launch); the maps as
  one packed table (:func:`emit_table`, built once per maps), only the
  owner halves of ``pe`` written (``out=`` buffers of :func:`emit_buffers`
  keep their zero halves from call to call).

The setup-only helpers (fan matvec, value sums, the pair neighbour table,
the cell-ELL conversion) and the block embedding are plain torch on every
device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _cuda


# ---------------------------------------------------------------------------
# host-side maps (numpy)
# ---------------------------------------------------------------------------

def build_pair_maps(geom, block: np.ndarray | None = None
                    ) -> Dict[str, np.ndarray]:
    """Host-side pair maps from a fem.tabulation.Geometry (numpy, cells
    first).  Ship them to a device with :func:`pair_maps_to_device`.

    ``block`` (nc,) optional group ids: matching is additionally restricted
    to same-block neighbours, so pairs never straddle blocks.

    Keys:
      cop      (2, npair) int32   cells of pair (self-pair: both equal)
      pid      (nc,)      int32   pair id of cell
      pos      (nc,)      int32   half index of cell within its pair
      live1    (npair,)   bool    second half is a real cell
      int_f    (npair,)   int32   internal facet id (dummy nf for self)
      int_p0   (npair,)   bool    cell0 is the PLUS side of int_f
      int_l    (2, npair) int32   local facet index of int_f per half
      ext_f    (S, npair) int32   external facet ids (dummy nf), S = 2d
      ext_isp  (S, npair) bool    owner cell is the PLUS side
      ext_h    (S, npair) int32   owner half (0/1)
      ext_l    (S, npair) int32   owner's local facet index
      ext_col  (S, npair) int32   gather column pos*npair + pid of the
                                  external cell (dummy -> own pair)
      cell_col (nc,)      int32   pos*npair + pid of each cell
      nf       int32              dummy facet index
    """
    nbr = np.asarray(geom.nbr)                     # (nc, d+2), col 0 = self
    cf = np.asarray(geom.cf_idx)                   # (nc, d+1)
    isp = np.asarray(geom.cf_is_plus)              # (nc, d+1)
    tag = np.asarray(geom.cell_tag)
    nc, K1 = cf.shape                              # K1 = d+1 local facets
    nf = int(np.asarray(geom.f_cp).shape[0]) - 1   # dummy facet index
    if block is not None:
        # fold the block constraint into the tag comparison
        tag = tag.astype(np.int64) + np.asarray(block, dtype=np.int64) * (
            int(tag.max()) + 1)

    # --- greedy same-tag matching over the (Morton) cell order ----------
    mate = np.full(nc, -1, dtype=np.int64)
    order_nbr = nbr[:, 1:]                         # (nc, d+1)
    for c in range(nc):
        if mate[c] >= 0:
            continue
        tc = tag[c]
        for o in order_nbr[c]:
            if o != c and o > c and mate[o] < 0 and tag[o] == tc:
                mate[c] = o
                mate[o] = c
                break
        else:
            mate[c] = c                            # self-pair

    first = np.flatnonzero(mate >= np.arange(nc))  # representative cells
    c0 = first
    c1 = mate[first]
    npair = len(first)
    cop = np.stack([c0, c1]).astype(np.int32)
    live1 = c1 != c0
    pid = np.empty(nc, dtype=np.int32)
    pos = np.empty(nc, dtype=np.int32)
    # c1 first, c0 second: a self-pair (c1 == c0) must end at pos 0
    pid[c1] = np.arange(npair)
    pos[c1] = 1
    pid[c0] = np.arange(npair)
    pos[c0] = 0

    # --- internal facet of each matched pair -----------------------------
    int_f = np.full(npair, nf, dtype=np.int32)
    int_p0 = np.zeros(npair, dtype=bool)
    for l in range(K1):
        hit = live1 & (order_nbr[c0, l] == c1) & (int_f == nf)
        int_f[hit] = cf[c0[hit], l]
        int_p0[hit] = isp[c0[hit], l]

    # internal local-facet index per half (for cell-ELL -> pair conversion)
    int_l = np.zeros((2, npair), dtype=np.int32)
    for l in range(K1):
        hit0 = live1 & (order_nbr[c0, l] == c1)
        int_l[0][hit0] = l
        hit1 = live1 & (order_nbr[c1, l] == c0)
        int_l[1][hit1] = l

    # --- external slots: fixed (h, l) scan order, compacted per pair -----
    d = K1 - 1
    S = 2 * d
    ext_f = np.full((S, npair), nf, dtype=np.int32)
    ext_isp = np.zeros((S, npair), dtype=bool)
    ext_h = np.zeros((S, npair), dtype=np.int32)
    ext_l = np.zeros((S, npair), dtype=np.int32)
    ext_other = np.tile(c0, (S, 1))                # dummy -> own cell
    fill = np.zeros(npair, dtype=np.int64)
    for h, ch in enumerate((c0, c1)):
        hlive = live1 if h == 1 else np.ones(npair, dtype=bool)
        for l in range(K1):
            f = cf[ch, l]
            other = order_nbr[ch, l]
            real = hlive & (f != nf) & (other != ch) & (other != (c1 if h == 0 else c0))
            idx = np.flatnonzero(real)
            s = fill[idx]
            if s.max(initial=0) >= S:
                raise ValueError("more external facets than slots")
            ext_f[s, idx] = f[idx]
            ext_isp[s, idx] = isp[ch[idx], l]
            ext_h[s, idx] = h
            ext_l[s, idx] = l
            ext_other[s, idx] = other[idx]
            fill[idx] += 1

    ext_col = (pos[ext_other].astype(np.int64) * npair
               + pid[ext_other]).astype(np.int32)
    cell_col = (pos.astype(np.int64) * npair + pid).astype(np.int32)

    return {
        "cop": cop, "pid": pid, "pos": pos, "live1": live1,
        "int_f": int_f, "int_p0": int_p0, "int_l": int_l,
        "ext_f": ext_f, "ext_isp": ext_isp, "ext_h": ext_h,
        "ext_l": ext_l, "ext_col": ext_col, "cell_col": cell_col,
        "nf": np.int32(nf),
    }


def interleave_pair_maps(pm: Dict[str, np.ndarray], nc: int,
                         n_shards: int = 1, shard_size: int | None = None,
                         align: int = 64):
    """Rewrite pair maps for the INTERLEAVED cell order: pair p occupies
    cell slots (2p, 2p+1), with fresh inert pad cells (ids nc..) as the
    dead second halves of self-pairs.  The cell<->pair conversions become
    relayouts, and the preconditioner's contiguous pair chunks (agg_size/2
    pairs) cover the same contiguous (compartment, Morton) cell ranges as
    the cell layout's chunks.

    ``n_shards > 1`` (cells already in shard-blocked order of block size
    ``shard_size``, the matching built with the matching ``block``): every
    shard's pair range is padded to a common P (a multiple of ``align``)
    with fully inert pad pairs, and the maps carry ``live0`` beside
    ``live1``.

    Returns ``(new_maps, perm)``: maps in the new numbering without
    ``cell_col`` (its absence marks the interleaved form), and the
    permutation ``perm`` (new slot -> old cell id, pad ids >= nc) to apply
    to every cell-indexed solver array."""
    cop, live1 = pm["cop"], pm["live1"]
    npair = cop.shape[1]
    nf = int(pm["nf"])
    S = pm["ext_f"].shape[0]

    if n_shards == 1:
        P = npair
        dst = np.arange(npair)
    else:
        shard_of = cop[0] // shard_size
        if not np.array_equal(shard_of, cop[1] // shard_size):
            raise ValueError("pairs straddle shards: build_pair_maps needs "
                             "the block argument")
        counts = np.bincount(shard_of, minlength=n_shards)
        P = max(align, -(-int(counts.max()) // align) * align)
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        # pairs arrive sorted by c0, hence shard-major
        dst = shard_of * P + (np.arange(npair) - starts[shard_of])
    npair_t = n_shards * P

    # --- the cell permutation: new slot -> old id (pads >= nc) ----------
    perm = np.full(2 * npair_t, -1, dtype=np.int64)
    perm[2 * dst] = cop[0]
    perm[2 * dst + 1] = np.where(live1, cop[1], -1)
    need = np.flatnonzero(perm < 0)
    perm[need] = nc + np.arange(len(need))

    def place(old, fill, dtype=None):
        out = np.full((*old.shape[:-1], npair_t), fill,
                      dtype=dtype or old.dtype)
        out[..., dst] = old
        return out

    new = {
        "cop": np.stack([np.arange(0, 2 * npair_t, 2, dtype=np.int32),
                         np.arange(1, 2 * npair_t, 2, dtype=np.int32)]),
        "pid": (np.arange(2 * npair_t, dtype=np.int32) // 2),
        "pos": (np.arange(2 * npair_t, dtype=np.int32) % 2),
        "live1": place(live1, False),
        "int_f": place(pm["int_f"], nf),
        "int_p0": place(pm["int_p0"], False),
        "int_l": place(pm["int_l"], 0),
        "ext_f": place(pm["ext_f"], nf),
        "ext_isp": place(pm["ext_isp"], False),
        "ext_h": place(pm["ext_h"], 0),
        "ext_l": place(pm["ext_l"], 0),
        "nf": pm["nf"],
    }
    if n_shards > 1:
        live0 = np.zeros(npair_t, dtype=bool)
        live0[dst] = True
        new["live0"] = live0

    # external gather columns: (h * npair + pid) -> (h * npair_t + dst);
    # dummy slots keep pointing at the own pair (their blocks are zero)
    h_old = pm["ext_col"] // npair
    p_old = pm["ext_col"] % npair
    ecol = (h_old * npair_t + dst[p_old]).astype(np.int32)
    self_col = np.broadcast_to(np.arange(npair_t, dtype=np.int32),
                               (S, npair_t))
    new["ext_col"] = place(ecol, 0)
    pad_pairs = np.ones(npair_t, dtype=bool)
    pad_pairs[dst] = False
    new["ext_col"][:, pad_pairs] = self_col[:, pad_pairs]
    return new, perm


def owner_half_mask(ext_h: np.ndarray) -> np.ndarray:
    """(npair,) uint8 owner halves of the external slots, one bit a slot:
    bit t of pair p is ext_h[t, p] (S <= 8 slots)."""
    ext_h = np.asarray(ext_h)
    if ext_h.shape[0] > 8:
        raise NotImplementedError("owner_half_mask: more than 8 external slots")
    bits = ext_h.astype(np.uint8) << np.arange(ext_h.shape[0], dtype=np.uint8)[:, None]
    return np.bitwise_or.reduce(bits, axis=0).astype(np.uint8)


def pair_maps_to_device(pm: Dict[str, np.ndarray], device) -> Dict[str, object]:
    """Torch copies of the host maps on ``device``: bool arrays stay bool,
    integer arrays become int32, the scalar ``nf`` a Python int.  Adds
    ``ext_hmask`` (npair,) uint8, :func:`owner_half_mask` of ``ext_h``,
    which the pair matvec kernel reads."""
    out = {}
    for k, v in pm.items():
        if np.ndim(v) == 0:
            out[k] = int(v)
        elif v.dtype == bool:
            out[k] = torch.as_tensor(v, device=device)
        else:
            out[k] = torch.as_tensor(np.asarray(v, dtype=np.int32), device=device)
    out["ext_hmask"] = torch.as_tensor(owner_half_mask(pm["ext_h"]), device=device)
    return out


def _interleaved_only(pm, name):
    if "cell_col" in pm:
        raise NotImplementedError(
            f"{name}: the non-interleaved (cell_col) pair maps are not "
            f"ported; use interleave_pair_maps")


def _no_live0(pm, name):
    if "live0" in pm:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes single-device maps (no live0)")


# ---------------------------------------------------------------------------
# K4: vector conversions (once per solve)
# ---------------------------------------------------------------------------

def to_pair_plain(pm, x):
    """(..., nd, 2 npair) -> (..., 2nd, npair), dead halves zeroed; a
    sequence of same-shaped tensors is converted as their stack."""
    if not isinstance(x, torch.Tensor):
        x = torch.stack(list(x))
    _interleaved_only(pm, "to_pair")
    *lead, nd, nc2 = x.shape
    npair = nc2 // 2
    xr = torch.movedim(x.reshape(*lead, nd, npair, 2), -1, -3)
    out = xr.reshape(*lead, 2 * nd, npair)
    live1 = pm["live1"].to(x.dtype)
    live0 = (pm["live0"].to(x.dtype) if "live0" in pm
             else torch.ones((), dtype=x.dtype, device=x.device))
    mask = torch.cat([live0.expand(nd, npair), live1.expand(nd, npair)])
    return out * mask


def _from_pair_operands(xp, add, base):
    """The output shape of from_pair(xp); refuses both add and base, or
    either of another shape than it is added at."""
    *lead, nd2, npair = xp.shape
    oshape = (*lead, nd2 // 2, 2 * npair)
    if add is not None and base is not None:
        raise ValueError("from_pair: give add (pair form) or base (cell form), not both")
    if add is not None and tuple(add.shape) != tuple(xp.shape):
        raise ValueError(f"from_pair: add of shape {tuple(add.shape)} for a pair vector of "
                         f"shape {tuple(xp.shape)}")
    if base is not None and tuple(base.shape) != oshape:
        raise ValueError(f"from_pair: base of shape {tuple(base.shape)} for a cell result of "
                         f"shape {oshape}")
    return oshape


def from_pair_plain(pm, xp, add=None, base=None):
    """(..., 2nd, npair) -> (..., nd, 2 npair); dead halves land on the pad
    cells.  With ``add`` (pair form, xp's shape) the relayout of xp + add;
    with ``base`` (cell form, the result's shape) base + the relayout of xp."""
    _interleaved_only(pm, "from_pair")
    _from_pair_operands(xp, add, base)
    if add is not None:
        xp = xp + add
    *lead, nd2, npair = xp.shape
    nd = nd2 // 2
    a = torch.movedim(xp.reshape(*lead, 2, nd, npair), -3, -1)
    out = a.reshape(*lead, nd, 2 * npair)
    return out if base is None else base + out


TO_PAIR_SOURCES = 4       # tensors the to_pair kernel reads in one launch


def to_pair(pm, x, out=None):
    """Cell -> pair relayout (kernel K4 on CUDA tensors), any number of
    leading stacked vectors.  ``x`` is one tensor (..., nd, 2 npair) or a
    sequence of up to TO_PAIR_SOURCES same-shaped ones, converted as their
    stack (k, ..., 2nd, npair) without forming it.  ``out`` optionally
    receives the result."""
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    x0 = xs[0]
    if not x0.is_cuda:
        res = to_pair_plain(pm, x if single else xs)
        return res if out is None else out.copy_(res)
    if "cell_col" in pm or "live0" in pm:
        _interleaved_only(pm, "to_pair")
        _no_live0(pm, "to_pair")
    shape, dt = x0.shape, x0.dtype
    *lead, nd, nc2 = shape
    npair = nc2 // 2
    lv = x0.numel() // (nd * nc2) if nc2 else 0
    live1 = pm["live1"]
    # one pass over the sources, a plain loop (a call's host time is most
    # of its cost); the slow path names what is wrong
    align = 2 * x0.element_size()
    ptrs = []
    ok = (not nc2 % 2 and len(xs) <= TO_PAIR_SOURCES and lv * nd <= 65535
          and live1.is_cuda and live1.dtype == torch.bool and live1.shape == (npair,)
          and live1.is_contiguous())
    for t in xs:
        p = t.data_ptr()
        ok = (ok and t.is_cuda and t.dtype == dt and t.shape == shape and t.is_contiguous()
              and not p % align)
        ptrs.append(p)
    if not ok:
        _to_pair_refusal(xs, live1, npair, lv * nd)
    oshape = (*(() if single else (len(xs),)), *lead, 2 * nd, npair)
    if out is None:
        out = torch.empty(oshape, dtype=dt, device=x0.device)
    elif not (out.is_cuda and out.dtype == dt and out.shape == oshape and out.is_contiguous()):
        _cuda.check("out", out, dt, oshape)
    ptrs += [None] * (TO_PAIR_SOURCES - len(xs))
    _cuda.launch("to_pair", "knp_to_pair", dt, *ptrs, live1.data_ptr(), out.data_ptr(),
                 len(xs), lv, nd, npair)
    return out


def _to_pair_refusal(xs, live1, npair, rows):
    """Raise the reason to_pair's kernel cannot take these sources."""
    x0 = xs[0]
    if x0.shape[-1] % 2:
        raise ValueError("to_pair: the interleaved cell axis must be even")
    if len(xs) > TO_PAIR_SOURCES:
        raise NotImplementedError(f"to_pair: at most {TO_PAIR_SOURCES} source tensors")
    if rows > 65535:
        raise NotImplementedError("to_pair: more than 65,535 rows per source")
    for t in xs:
        _cuda.check("x", t, x0.dtype, x0.shape)
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError("to_pair: a source must start at an even element (pair loads)")
    _cuda.check("live1", live1, torch.bool, (npair,))


def from_pair(pm, xp, add=None, base=None, out=None):
    """Pair -> cell relayout (kernel K4 on a CUDA tensor), any number of
    leading stacked vectors, with at most one add in the same pass: ``add``
    (pair form, xp's shape) converts xp + add, ``base`` (cell form, the
    result's shape) gives base + the relayout of xp.  ``out`` optionally
    receives the result (on the card it is used as given, no allocation)."""
    if not xp.is_cuda:
        res = from_pair_plain(pm, xp, add=add, base=base)
        return res if out is None else out.copy_(res)
    if "cell_col" in pm:
        _interleaved_only(pm, "from_pair")
    shape, dt = xp.shape, xp.dtype
    *lead, nd2, npair = shape
    nd = nd2 // 2
    oshape = (*lead, nd, 2 * npair)
    L = xp.numel() // (nd2 * npair) if nd2 * npair else 0
    # one pass of checks (a call's host time is most of its cost); the slow
    # path names what is wrong.  base and out are read and written a pair
    # (8 or 16 bytes) at a time
    align = 2 * xp.element_size()
    ok = (xp.is_contiguous() and not nd2 % 2 and 1 <= L * nd <= 65535
          and (add is None or base is None))
    if add is not None:
        ok = (ok and add.is_cuda and add.dtype == dt and add.shape == shape
              and add.is_contiguous())
    if base is not None:
        ok = (ok and base.is_cuda and base.dtype == dt and base.shape == oshape
              and base.is_contiguous() and not base.data_ptr() % align)
    if out is None:
        if ok:
            out = torch.empty(oshape, dtype=dt, device=xp.device)
    else:
        ok = (ok and out.is_cuda and out.dtype == dt and out.shape == oshape
              and out.is_contiguous() and not out.data_ptr() % align)
    if not ok:
        _from_pair_refusal(xp, add, base, out, oshape, L * nd)
    _cuda.launch("from_pair", "knp_from_pair", dt, xp.data_ptr(),
                 None if add is None else add.data_ptr(),
                 None if base is None else base.data_ptr(), out.data_ptr(), L, nd, npair)
    return out


def _from_pair_refusal(xp, add, base, out, oshape, rows):
    """Raise the reason from_pair's kernel cannot take these operands."""
    if xp.shape[-2] % 2:
        raise ValueError("from_pair: expected (..., 2nd, npair)")
    _from_pair_operands(xp, add, base)
    _cuda.check("xp", xp)
    if not 1 <= rows <= 65535:
        raise NotImplementedError("from_pair: 1 to 65,535 (vector, dof) rows")
    for name, t, shape in (("add", add, xp.shape), ("base", base, oshape),
                           ("out", out, oshape)):
        if t is not None:
            _cuda.check(name, t, xp.dtype, shape)
            if name != "add" and t.data_ptr() % (2 * t.element_size()):
                raise ValueError(f"from_pair: {name} must start at an even element "
                                 f"(pair stores)")
    raise ValueError("from_pair: operands the kernel cannot take")


def to_pair_host(pmh, x):
    """Numpy mirror of :func:`to_pair` on the host maps."""
    _interleaved_only(pmh, "to_pair_host")
    x = np.asarray(x)
    *lead, nd, nc2 = x.shape
    npair = nc2 // 2
    xr = np.moveaxis(x.reshape(*lead, nd, npair, 2), -1, -3)
    out = xr.reshape(*lead, 2 * nd, npair)
    live1 = np.asarray(pmh["live1"], dtype=x.dtype)
    live0 = (np.asarray(pmh["live0"], dtype=x.dtype) if "live0" in pmh
             else np.ones((), dtype=x.dtype))
    mask = np.concatenate([np.broadcast_to(live0, (nd, npair)),
                           np.broadcast_to(live1, (nd, npair))])
    return out * mask


def from_pair_host(pmh, xp, add=None, base=None):
    """Numpy mirror of :func:`from_pair` on the host maps."""
    _interleaved_only(pmh, "from_pair_host")
    xp = np.asarray(xp)
    _from_pair_operands(xp, add, base)
    if add is not None:
        xp = xp + np.asarray(add)
    *lead, nd2, npair = xp.shape
    nd = nd2 // 2
    a = np.moveaxis(xp.reshape(*lead, 2, nd, npair), -3, -1)
    out = a.reshape(*lead, nd, 2 * npair)
    return out if base is None else np.asarray(base) + out


# ---------------------------------------------------------------------------
# K3: pair matvecs
# ---------------------------------------------------------------------------

def pair_matvec_plain(pd, pe, pm, xp):
    """y = A_pair xp.  pd (2nd, 2nd, npair); pe (S, 2nd, nd, npair);
    xp (2nd, npair).  The diagonal term first, then the external slots."""
    nd = pe.shape[2]
    y = torch.einsum("ijp,jp->ip", pd, xp)
    xv = torch.cat([xp[:nd], xp[nd:]], dim=1)             # (nd, 2 npair)
    xe = xv[:, pm["ext_col"]]                               # (nd, S, npair)
    return y + torch.einsum("sijp,jsp->ip", pe, xe)


def pair_matvec_multi_plain(pd, pe, pm, xp):
    """m systems sharing one external gather: pd (m, 2nd, 2nd, npair);
    pe (m, S, 2nd, nd, npair); xp (m, 2nd, npair)."""
    m, nd2, npair = xp.shape
    nd = nd2 // 2
    y = torch.einsum("mijp,mjp->mip", pd, xp)
    xv = torch.cat([xp[:, :nd], xp[:, nd:]], dim=2).reshape(m * nd, 2 * npair)
    xe = xv[:, pm["ext_col"]].reshape(m, nd, *pm["ext_col"].shape)
    return y + torch.einsum("msijp,mjsp->mip", pe, xe)


def _pair_matvec_cuda(pd, pe, pm, xp, m):
    nd2, npair = xp.shape[-2], xp.shape[-1]
    nd = nd2 // 2
    S = pm["ext_col"].shape[0]
    if nd > 4 or S > 8:
        raise NotImplementedError(
            f"pair_matvec: CUDA kernel built for nd <= 4 and S <= 8, got nd = {nd}, S = {S}")
    lead = (m,) if xp.dim() == 3 else ()
    _cuda.check("xp", xp)
    _cuda.check("pd", pd, xp.dtype, lead + (nd2, nd2, npair))
    _cuda.check("pe", pe, xp.dtype, lead + (S, nd2, nd, npair))
    _cuda.check("ext_col", pm["ext_col"], torch.int32, (S, npair))
    _cuda.check("ext_hmask", pm["ext_hmask"], torch.uint8, (npair,))
    y = torch.empty_like(xp)
    _cuda.launch("pair_matvec", "knp_pair_matvec", xp.dtype, pd.data_ptr(),
                 pe.data_ptr(), pm["ext_col"].data_ptr(), pm["ext_hmask"].data_ptr(),
                 xp.data_ptr(), y.data_ptr(), m, nd, S, npair)
    return y


def owner_half_rows(pm, nd):
    """(S, 2nd, 1, npair) bool, decoded from ``pm["ext_hmask"]``: the rows
    of each external slot's block in its owner half, the only rows of
    ``pe`` that are not zero and the only ones the pair matvec kernel
    reads."""
    S = pm["ext_col"].shape[0]
    bits = pm["ext_hmask"].to(torch.int32)
    dev = bits.device
    h = (bits[None, :] >> torch.arange(S, dtype=torch.int32, device=dev)[:, None]) & 1
    half = torch.arange(2 * nd, dtype=torch.int32, device=dev) // nd
    return half[None, :, None, None] == h[:, None, None, :]


def pair_matvec(pd, pe, pm, xp):
    """Single-system pair matvec (kernel K3 on a CUDA tensor).  The kernel
    reads only the owner half's rows of each external slot (``pm``'s
    ``ext_hmask``): ``pe`` must be exactly zero in the other half, as the
    emitters and :func:`cell_bell_to_pair` write it."""
    if not xp.is_cuda:
        return pair_matvec_plain(pd, pe, pm, xp)
    if xp.dim() != 2:
        raise ValueError("pair_matvec: xp must be (2nd, npair)")
    return _pair_matvec_cuda(pd, pe, pm, xp, 1)


def pair_matvec_multi(pd, pe, pm, xp):
    """Ion-batched pair matvec (kernel K3 with m systems on a CUDA tensor):
    one launch for all m operators sharing ``ext_col``; ``pe`` zero outside
    the owner halves, as for :func:`pair_matvec`."""
    if not xp.is_cuda:
        return pair_matvec_multi_plain(pd, pe, pm, xp)
    if xp.dim() != 3:
        raise ValueError("pair_matvec_multi: xp must be (m, 2nd, npair)")
    return _pair_matvec_cuda(pd, pe, pm, xp, xp.shape[0])


def pair_matvec_fan(pd, pe, pm, X):
    """One operator applied to m vectors (the moment-deflation Galerkin
    build): X (m, 2nd, npair) -> (m, 2nd, npair), one shared external
    gather.  Setup only, so plain torch on every device."""
    m, nd2, npair = X.shape
    nd = nd2 // 2
    y = torch.einsum("ijp,mjp->mip", pd, X)
    xv = torch.cat([X[:, :nd], X[:, nd:]], dim=2).reshape(m * nd, 2 * npair)
    xe = xv[:, pm["ext_col"]].reshape(m, nd, *pm["ext_col"].shape)
    return y + torch.einsum("sijp,mjsp->mip", pe, xe)


# ---------------------------------------------------------------------------
# K12: pair-ELL assembly emitters (mirror ops.assembly.gather_blocks)
# ---------------------------------------------------------------------------

def gather_blocks_pair_multi_plain(g, pm, A_cell, Mpp, Mpm, Mmp, Mmm,
                                   dead_identity: float = 1.0, add=None):
    """Pair-block operator of m systems from per-facet blocks: A_cell
    (m, nd, nd, nc), M** (m, nd, nd, nf+1) -> pd (m, 2nd, 2nd, npair),
    pe (m, S, 2nd, nd, npair).  ``dead_identity`` goes on the dead half's
    diagonal of self-pairs (keeps the block-Jacobi inverse nonsingular;
    the dead rows and rhs are zero, so the Krylov iterates stay zero
    there).  ``add``: a static pair operator (pd, pe) added last.  ``g`` is
    unused; it keeps the JAX signature."""
    m, nd = A_cell.shape[0], A_cell.shape[1]
    nf1 = Mpp.shape[-1]
    npair = pm["int_f"].shape[0]
    M = torch.stack([Mpp, Mmm, Mpm, Mmp], dim=1).reshape(m * 4 * nd * nd, nf1)

    live1 = pm["live1"].to(A_cell.dtype)
    live0 = pm["live0"].to(A_cell.dtype) if "live0" in pm else None
    A2 = A_cell.reshape(m * nd * nd, -1)
    Ah = A2[:, pm["cop"]].reshape(m, nd, nd, 2, npair)
    B00 = Ah[..., 0, :]
    B11 = Ah[..., 1, :] * live1
    if live0 is not None:                          # fully inert pad pairs
        B00 = B00 * live0

    gi = M[:, pm["int_f"]].reshape(m, 4, nd, nd, npair)
    p0 = pm["int_p0"][None, None, None, :]
    B00 = B00 + torch.where(p0, gi[:, 0], gi[:, 1])
    B11 = B11 + torch.where(p0, gi[:, 1], gi[:, 0])
    B01 = torch.where(p0, gi[:, 2], gi[:, 3])
    B10 = torch.where(p0, gi[:, 3], gi[:, 2])

    pes = []
    for s in range(pm["ext_f"].shape[0]):
        gs = M[:, pm["ext_f"][s]].reshape(m, 4, nd, nd, npair)
        sel = pm["ext_isp"][s][None, None, None, :]
        dg = torch.where(sel, gs[:, 0], gs[:, 1])
        off = torch.where(sel, gs[:, 2], gs[:, 3])
        h0 = (pm["ext_h"][s] == 0)[None, None, None, :]
        B00 = B00 + torch.where(h0, dg, 0.0)
        B11 = B11 + torch.where(h0, 0.0, dg)
        pes.append(torch.cat([torch.where(h0, off, 0.0),
                              torch.where(h0, 0.0, off)], dim=1))

    eye = torch.eye(nd, dtype=A_cell.dtype, device=A_cell.device)[None, :, :, None]
    B11 = B11 + eye * (dead_identity * (1.0 - live1))
    if live0 is not None:
        B00 = B00 + eye * (dead_identity * (1.0 - live0))
    pd = torch.cat([torch.cat([B00, B01], dim=2),
                    torch.cat([B10, B11], dim=2)], dim=1)
    pe = torch.stack(pes, dim=1)
    if add is not None:
        pd, pe = pd + add[0], pe + add[1]
    return pd, pe


def gather_blocks_pair_plain(g, pm, A_cell, Mpp, Mpm, Mmp, Mmm,
                             dead_identity: float = 1.0, reg=None):
    """Single-system emitter: A_cell (nd, nd, nc), M** (nd, nd, nf+1) ->
    (pd (2nd, 2nd, npair), pe (S, 2nd, nd, npair)).  With per-cell blocks
    ``reg`` (nd, nd, nc) a third output pd + their pair-diagonal embedding
    (the EMI preconditioner diagonal)."""
    pd, pe = gather_blocks_pair_multi_plain(
        g, pm, A_cell[None], Mpp[None], Mpm[None], Mmp[None], Mmm[None],
        dead_identity)
    if reg is None:
        return pd[0], pe[0]
    return pd[0], pe[0], pd[0] + pair_block_diag_embed(pm, reg)


# the pair emit kernel's build: nd = 4 blocks, S = 2 d = 6 external slots
EMIT_ND, EMIT_S = 4, 6
_EMIT_F_BITS = 30         # facet index bits of a packed word; bits 30, 31 the flags
_EMIT_MAPS = ("cop", "live1", "int_f", "int_p0", "ext_f", "ext_isp", "ext_h")
_EMIT_TABLES = WeakIdKeyDictionary()   # pm["ext_f"] -> (the other maps, the table)
_ZERO_HALVES = WeakIdKeyDictionary()   # pe (or its base) -> (version, address, size)


def _pack(low, bit30, bit31):
    """int32 words low | bit30 << 30 | bit31 << 31 (two's complement)."""
    w = low.to(torch.int64) | (bit30.to(torch.int64) << 30) | (bit31.to(torch.int64) << 31)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def emit_table(pm):
    """The pair emit's maps packed into one int32 table (S + 1, npair),
    pairs fastest, on the maps' device: row 0 the interior word (int_f,
    live1 in bit 30, int_p0 in bit 31), row 1 + t slot t's word (ext_f,
    ext_isp in bit 30, ext_h in bit 31).  The interleaved maps put pair p
    at cells (2p, 2p + 1), so cop is not stored.  Built once per maps (a
    cache keyed on the map tensors): the maps are checked here, not per
    emit (on the card: contiguous, int32 / bool, their shapes; the facet
    indices within 30 bits; cop the interleaved one).  The words are
    unsigned 32-bit in the kernel: read back in int64, w & (2**32 - 1)."""
    src = tuple(pm[k] for k in _EMIT_MAPS if k != "ext_f")
    hit = _EMIT_TABLES.get(pm["ext_f"])
    if hit is not None and all(a is b for a, b in zip(hit[0], src)):
        return hit[1]
    S, npair = pm["ext_f"].shape
    shapes = {"cop": (torch.int32, (2, npair)), "live1": (torch.bool, (npair,)),
              "int_f": (torch.int32, (npair,)), "int_p0": (torch.bool, (npair,)),
              "ext_f": (torch.int32, (S, npair)), "ext_isp": (torch.bool, (S, npair)),
              "ext_h": (torch.int32, (S, npair))}
    for key, (dt, shape) in shapes.items():
        t = pm[key]
        if t.is_cuda:
            _cuda.check(key, t, dt, shape)
        elif t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"emit_table: {key} must be {dt} of shape {shape}")
    pairs_ = torch.arange(npair, dtype=torch.int32, device=pm["cop"].device)
    if not bool((pm["cop"] == torch.stack([2 * pairs_, 2 * pairs_ + 1])).all()):
        raise NotImplementedError(
            "emit_table: the pair emit takes the interleaved maps (pair p at cells 2p, 2p + 1)")
    facets = torch.cat([pm["int_f"][None], pm["ext_f"]])
    if not bool(((facets >= 0) & (facets < 2 ** _EMIT_F_BITS)).all()):
        raise ValueError("emit_table: facet indices outside [0, 2**30)")
    if not bool(((pm["ext_h"] == 0) | (pm["ext_h"] == 1)).all()):
        raise ValueError("emit_table: ext_h must be 0 or 1")
    tab = torch.cat([_pack(pm["int_f"], pm["live1"], pm["int_p0"])[None],
                     _pack(pm["ext_f"], pm["ext_isp"], pm["ext_h"])]).contiguous()
    _EMIT_TABLES[pm["ext_f"]] = (src, tab)
    return tab


def _zero_halves(pm, pe, name):
    """Raise unless ``pe`` (..., S, 2nd, nd, npair) is exactly zero outside
    each slot's owner half; checked once per tensor (its base for a view)
    and in-place version, then taken from the cache."""
    base = pe if pe._base is None else pe._base
    key = (pe._version, pe.data_ptr(), pe.numel())
    if _ZERO_HALVES.get(base) == key:
        return
    own = owner_half_rows(pm, pe.shape[-2])
    if bool(((pe != 0) & ~own).any()):
        raise ValueError(f"gather_blocks_pair: {name} is not zero outside the owner halves")
    _ZERO_HALVES[base] = key


def emit_buffers(pm, nd, dtype, device, m=None, diag=False):
    """Output buffers of the pair emit for a caller that emits into the same
    operator again and again (the solver's step): pd, pe and with ``diag``
    pdiag, shaped as :func:`gather_blocks_pair` (``m`` None) or
    :func:`gather_blocks_pair_multi` (``m`` systems) returns them.  pe is
    made zero here, once: the emit writes only the owner halves, so the
    other halves stay zero from call to call."""
    S, npair = pm["ext_f"].shape
    lead = () if m is None else (m,)
    pd = torch.empty(lead + (2 * nd, 2 * nd, npair), dtype=dtype, device=device)
    pe = torch.zeros(lead + (S, 2 * nd, nd, npair), dtype=dtype, device=device)
    _ZERO_HALVES[pe] = (pe._version, pe.data_ptr(), pe.numel())
    return (pd, pe, torch.empty_like(pd)) if diag else (pd, pe)


def _copy_out(res, out):
    """The plain path with ``out``: the results copied into the buffers."""
    if out is None:
        return res
    for dst, src in zip(out, res):
        dst.copy_(src)
    return tuple(out[:len(res)])


def _gather_blocks_pair_cuda(pm, A_cell, Mpp, Mpm, Mmp, Mmm, dead_identity,
                             add=None, reg=None, out=None):
    """A_cell (m, nd, nd, nc), M** (m, nd, nd, nf+1) on the card, or one
    system's without the leading axis (then so are the outputs); ``add``
    a (pd, pe) pair operator added last (its pe zero outside the owner
    halves), ``reg`` shaped as A_cell for the third output pd + embedded
    reg; ``out`` the (pd, pe[, pdiag]) buffers to write (pe zero outside
    the owner halves, as :func:`emit_buffers` makes it), else new ones."""
    _no_live0(pm, "gather_blocks_pair")
    tab = emit_table(pm)
    lead = tuple(A_cell.shape[:-3])
    m, (nd, _, nc) = (lead[0] if lead else 1), A_cell.shape[-3:]
    S, npair = tab.shape[0] - 1, tab.shape[1]
    if nd != EMIT_ND or S != EMIT_S:
        raise NotImplementedError(
            f"gather_blocks_pair: CUDA kernel built for nd = {EMIT_ND}, S = {EMIT_S}, got "
            f"nd = {nd}, S = {S}")
    dt, nf1 = A_cell.dtype, Mpp.shape[-1]
    if "nf" in pm and nf1 != int(pm["nf"]) + 1:
        raise ValueError(f"gather_blocks_pair: {nf1} facet blocks for maps of "
                         f"{int(pm['nf']) + 1} facets")
    _cuda.check("A_cell", A_cell, None, lead + (nd, nd, 2 * npair))
    for name, M in (("Mpp", Mpp), ("Mpm", Mpm), ("Mmp", Mmp), ("Mmm", Mmm)):
        _cuda.check(name, M, dt, lead + (nd, nd, nf1))
    pair_vec = 2 * A_cell.element_size()      # a pair's two cells are one vector load
    shape_d, shape_e = lead + (2 * nd, 2 * nd, npair), lead + (S, 2 * nd, nd, npair)
    if out is None:
        pd = torch.empty(shape_d, dtype=dt, device=A_cell.device)
        pe = torch.zeros(shape_e, dtype=dt, device=A_cell.device)
        pdiag = None if reg is None else torch.empty_like(pd)
    else:
        pd, pe = out[0], out[1]
        pdiag = None if reg is None else out[2]
        _cuda.check("out pd", pd, dt, shape_d)
        _cuda.check("out pe", pe, dt, shape_e)
        if pdiag is not None:
            _cuda.check("out pdiag", pdiag, dt, shape_d)
        _zero_halves(pm, pe, "out pe")
    add_ptrs = (None, None)
    if add is not None:
        _cuda.check("add pd", add[0], dt, shape_d)
        _cuda.check("add pe", add[1], dt, shape_e)
        _zero_halves(pm, add[1], "add pe")
        add_ptrs = (add[0].data_ptr(), add[1].data_ptr())
    if reg is not None:
        _cuda.check("reg", reg, dt, A_cell.shape)
    if A_cell.data_ptr() % pair_vec or (reg is not None and reg.data_ptr() % pair_vec):
        raise ValueError("gather_blocks_pair: A_cell and reg must start at an even element")
    _cuda.launch("gather_blocks_pair", "knp_pair_emit", dt,
                 A_cell.data_ptr(), Mpp.data_ptr(), Mpm.data_ptr(),
                 Mmp.data_ptr(), Mmm.data_ptr(), tab.data_ptr(),
                 pd.data_ptr(), pe.data_ptr(), *add_ptrs,
                 None if reg is None else reg.data_ptr(),
                 None if reg is None else pdiag.data_ptr(),
                 m, nd, S, nf1, npair, float(dead_identity))
    return pd, pe, pdiag


def gather_blocks_pair(g, pm, A_cell, Mpp, Mpm, Mmp, Mmm,
                       dead_identity: float = 1.0, reg=None, out=None):
    """Pair-block operator from per-facet blocks (kernel K12 on a CUDA
    tensor): (pd (2nd, 2nd, npair), pe (S, 2nd, nd, npair)); with ``reg``
    (nd, nd, nc) also pd + the pair-diagonal embedding of reg, from the same
    launch.  ``out``: buffers of :func:`emit_buffers` to write and return
    (on the CPU the plain results are copied into them); without it new
    tensors."""
    if not A_cell.is_cuda:
        return _copy_out(gather_blocks_pair_plain(g, pm, A_cell, Mpp, Mpm, Mmp, Mmm,
                                                  dead_identity, reg), out)
    pd, pe, pdiag = _gather_blocks_pair_cuda(pm, A_cell, Mpp, Mpm, Mmp, Mmm, dead_identity,
                                             reg=reg, out=out)
    return (pd, pe) if reg is None else (pd, pe, pdiag)


def gather_blocks_pair_multi(g, pm, A_cell, Mpp, Mpm, Mmp, Mmm,
                             dead_identity: float = 1.0, add=None, out=None):
    """Batched emitter, one launch for all m systems (kernel K12 on a CUDA
    tensor): pd (m, 2nd, 2nd, npair), pe (m, S, 2nd, nd, npair).  ``add``:
    a static pair operator (pd, pe) added last, in the same launch; on the
    card its pe must be zero outside the owner halves (checked once per
    tensor).  ``out`` as for :func:`gather_blocks_pair`."""
    if not A_cell.is_cuda:
        return _copy_out(gather_blocks_pair_multi_plain(g, pm, A_cell, Mpp, Mpm, Mmp,
                                                        Mmm, dead_identity, add), out)
    return _gather_blocks_pair_cuda(pm, A_cell, Mpp, Mpm, Mmp, Mmm,
                                    dead_identity, add=add, out=out)[:2]


# ---------------------------------------------------------------------------
# setup-only helpers (plain torch on every device)
# ---------------------------------------------------------------------------

def pair_block_diag_embed(pm, D_cell, dead_identity: float = 0.0):
    """Embed per-cell (nd, nd, nc) diagonal blocks into the pair diagonal
    (2nd, 2nd, npair) with zero off-halves (the EMI mass regularisation of
    the preconditioner diagonal)."""
    nd = D_cell.shape[0]
    npair = pm["int_f"].shape[0]
    live1 = pm["live1"].to(D_cell.dtype)
    A2 = D_cell.reshape(nd * nd, -1)
    Ah = A2[:, pm["cop"]]
    B00 = Ah[:, 0].reshape(nd, nd, npair)
    B11 = Ah[:, 1].reshape(nd, nd, npair) * live1
    eye = torch.eye(nd, dtype=D_cell.dtype, device=D_cell.device)[:, :, None]
    B11 = B11 + eye * (dead_identity * (1.0 - live1))
    if "live0" in pm:                              # fully inert pad pairs
        live0 = pm["live0"].to(D_cell.dtype)
        B00 = B00 * live0 + eye * (dead_identity * (1.0 - live0))
    z = torch.zeros_like(B00)
    return torch.cat([torch.cat([B00, z], dim=1),
                      torch.cat([z, B11], dim=1)], dim=0)


def pair_v_sums(pd, pe):
    """Block value sums in the (K, n) convention build_two_level reads:
    slot 0 = pair diagonal, slots 1.. = external.  Returns (1+S, npair)."""
    v0 = pd.sum(dim=(0, 1))
    vs = pe.sum(dim=(1, 2))
    return torch.cat([v0[None], vs], dim=0)


def pair_nbr(pm):
    """(1+S, npair) neighbour-pair table (slot 0 = self) for
    build_two_level's chunk-crossing detection."""
    npair = pm["int_f"].shape[0]
    self_row = torch.arange(npair, dtype=torch.int32,
                            device=pm["int_f"].device)[None]
    ext_pid = pm["ext_col"] % npair
    return torch.cat([self_row, ext_pid], dim=0)


def cell_bell_to_pair(pm, blocks, dead_identity: float = 0.0):
    """One-time cell block-ELL -> pair conversion (the cached static KNP
    operator at setup; the per-step assemblies emit pair blocks directly).
    blocks (..., K, nd, nd, nc) with slot l+1 = local facet l; leading axes
    broadcast."""
    *lead, K, nd, _, nc = blocks.shape
    npair = pm["int_f"].shape[0]
    live1 = pm["live1"].to(blocks.dtype)
    live0 = pm["live0"].to(blocks.dtype) if "live0" in pm else None
    c0, c1 = pm["cop"][0], pm["cop"][1]

    B00 = blocks[..., 0, :, :, :][..., c0]
    B11 = blocks[..., 0, :, :, :][..., c1] * live1
    if live0 is not None:                          # fully inert pad pairs
        B00 = B00 * live0

    # flatten (K, nc) into one gather axis: column = l * nc + c
    Bf = torch.movedim(blocks, -4, -1)              # (..., nd, nd, nc, K)
    Bf = torch.swapaxes(Bf, -1, -2)                 # (..., nd, nd, K, nc)
    Bf = Bf.reshape(*lead, nd, nd, K * nc)

    def slot_at(l_arr, cells):                      # l_arr, cells (npair,)
        col = (l_arr.to(torch.int64) + 1) * nc + cells.to(torch.int64)
        return Bf[..., col]                         # (..., nd, nd, npair)

    B01 = slot_at(pm["int_l"][0], c0) * live1
    B10 = slot_at(pm["int_l"][1], c1) * live1
    eye = torch.eye(nd, dtype=blocks.dtype, device=blocks.device)[:, :, None]
    B11 = B11 + eye * (dead_identity * (1.0 - live1))
    if live0 is not None:
        B00 = B00 + eye * (dead_identity * (1.0 - live0))
    pd = torch.cat([torch.cat([B00, B01], dim=-2),
                    torch.cat([B10, B11], dim=-2)], dim=-3)

    pes = []
    z = torch.zeros((*lead, nd, nd, npair), dtype=blocks.dtype,
                    device=blocks.device)
    for s in range(pm["ext_f"].shape[0]):
        owner = torch.where(pm["ext_h"][s] == 0, c0, c1)
        blk = slot_at(pm["ext_l"][s], owner)
        # dummy slots point at the owner's own local facet 0 -- mask them
        mask = (pm["ext_f"][s] != pm["nf"]).to(blocks.dtype)
        blk = blk * mask
        h0 = pm["ext_h"][s] == 0
        top = torch.where(h0, blk, z)
        bot = torch.where(h0, z, blk)
        pes.append(torch.cat([top, bot], dim=-3))   # row halves
    return pd, torch.stack(pes, dim=-4)


def mass_to_pair(pm, mass):
    """(nc,) per-cell scalar -> (npair,) per-pair sum over live halves."""
    c0, c1 = pm["cop"][0], pm["cop"][1]
    return mass[c0] + mass[c1] * pm["live1"].to(mass.dtype)


def onehot_to_pair(pm, onehot):
    """(n_comp, nc) compartment indicator -> (n_comp, npair).  Pairs are
    same-tag, hence same-compartment: take cell0's column."""
    return onehot[:, pm["cop"][0]]
