"""Batched DG assembly, cells-last layout (torch port of
knpemidg_tpu/ops/assembly.py, degree 1; cell or pair operator layout).

Shapes:

    dof fields        u      (nd, nc)
    gradients         G      (nd, d, nc)
    facet traces      f_R*   (nq, nd, nf+1)
    block operator    B      (K, nd, nd, nc), K = d+2, slot 0 = diagonal
    neighbour table   nbr    (K, nc)

The operator is block-ELL: the Krylov matvec is a gather and a small
contraction only.  Given pair maps (``pm``) the emitters write the pair
layout instead (ops/pairs.py, kernel K12 on the card).

Kernels (CUDA tensors; the plain torch ``*_plain`` version for CPU tensors,
no fallback between the two), for nd <= 4 and d <= 3:

* K10 ``csrc/assemble_emi.cu``: :func:`emi_cell`, :func:`emi_facet`,
  :func:`emi_emit_cell`, the three launches of :func:`assemble_emi`;
* K11 ``csrc/assemble_knp.cu``: :func:`alpha_sum`, :func:`knp_cell`,
  :func:`knp_facet`, :func:`knp_membrane_emit` (the membrane rhs
  :func:`knp_membrane_rhs_plain` and the emit :func:`knp_emit_cell_plain`
  in one call), the launches of :func:`assemble_knp_all`;
* K14 ``csrc/membrane_trace.cu``: :func:`membrane_traces_m` (a step's
  ODE-input traces of every field in one launch), :func:`membrane_avg_m`,
  :func:`nernst_potential_m`, :func:`jump_phi_M_m` (one kernel: any fields,
  any set of quantities) and :func:`eliminated_concentration`.

The plain versions take ``neg``, the sign of every subtracted term (-1.0).
With +1.0 and absolute-valued inputs they return each output's sum of
|terms|, the scale the kernels' rounding is measured against.

The setup-only functions (:func:`precompute_static`,
:func:`assemble_knp_static`) are plain torch on every device.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import _cuda
from .pairs import _pack, gather_blocks_pair, gather_blocks_pair_multi

MAX_ND, MAX_D = 4, 3      # the kernels' register arrays (DG1 in 2D and 3D)
MAX_NQ = 12               # emi_facet's shared tile, knp_membrane_emit's per-point jump:
                          # every facet rule of fem/quadrature


def _degree1(g):
    if int(g.get("degree", 1)) != 1:
        raise NotImplementedError("knpemidg_tpu_torch assembles degree 1 only")


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def _wsum_outer(w, coef, R_v, R_u):
    """sum_q w[q] * coef[q, f] * R_v[q, i, f] * R_u[q, j, f] -> (nd, nd, nf),
    accumulated over the small quadrature axis in order."""
    acc = None
    for q in range(R_v.shape[0]):
        c = w[q] if coef is None else (w[q] * coef[q])[None, None, :]
        t = c * (R_v[q][:, None, :] * R_u[q][None, :, :])
        acc = t if acc is None else acc + t
    return acc


def _wsum_vec(w, coef, R_v):
    """sum_q w[q] * coef[q, f] * R_v[q, i, f] -> (nd, nf)."""
    acc = None
    for q in range(R_v.shape[0]):
        t = (w[q] * coef[q])[None, :] * R_v[q]
        acc = t if acc is None else acc + t
    return acc


def precompute_static(g):
    """Extend the geometry dict with mesh-static assembly tensors:

      GG   (nd, nd, nc)  grad(phi_i).grad(phi_j) per cell
      gnp/gnm (nd, nf+1) n . grad(basis) per facet side
      E_pp/E_pm/E_mp/E_mm (nd, nd, nf+1) = sum_q w_q R_v[q,i] R_u[q,j]
      M0 (nd, nd), phibar (nd,) reference-cell mass factors
      e_groups  the exterior facets in groups that repeat no cell
    """
    _degree1(g)
    g = dict(g)
    g["GG"] = torch.einsum("idc,jdc->ijc", g["G"], g["G"])
    g["gnp"] = torch.einsum("df,idf->if", g["f_n"], g["G"][:, :, g["f_cp"]])
    g["gnm"] = torch.einsum("df,idf->if", g["f_n"], g["G"][:, :, g["f_cm"]])
    w, Rp, Rm = g["w_f"], g["f_Rp"], g["f_Rm"]
    g["E_pp"] = _wsum_outer(w, None, Rp, Rp)
    g["E_pm"] = _wsum_outer(w, None, Rp, Rm)
    g["E_mp"] = _wsum_outer(w, None, Rm, Rp)
    g["E_mm"] = _wsum_outer(w, None, Rm, Rm)
    g["M0"] = torch.einsum("q,qi,qj->ij", g["w_c"], g["Phi_c"], g["Phi_c"])
    g["phibar"] = torch.einsum("q,qj->j", g["w_c"], g["Phi_c"])
    g["e_groups"] = exterior_groups(g["e_c"])
    # an einsum may return a permuted memory order; the kernels read rows
    for key in ("GG", "gnp", "gnm", "E_pp", "E_pm", "E_mp", "E_mm", "M0", "phibar"):
        g[key] = g[key].contiguous()
    return g


def facet_trace(g, u, side: str):
    """Trace of DG1 field u (nd, nc) at facet quad points -> (nq, nf+1)."""
    R = g["f_Rp"] if side == "p" else g["f_Rm"]           # (nq, nd, nf)
    c = g["f_cp"] if side == "p" else g["f_cm"]
    return torch.einsum("qif,if->qf", R, u[:, c])


def cell_grad(g, u):
    """Gradient of DG1 field (constant per cell) -> (d, nc)."""
    return torch.einsum("idc,ic->dc", g["G"], u)


def gather_blocks(g, A_cell, Mpp, Mpm, Mmp, Mmm):
    """Assemble the block-ELL operator from per-facet blocks (nd,nd,nf+1):
    blocks (K, nd, nd, nc), slot 0 = diagonal.  Padded cell-facet slots
    point at the dummy facet nf, whose blocks are zero."""
    cf = g["cf_idx"]                     # (d+1, nc)
    isp = g["cf_is_plus"]                # (d+1, nc)
    nd = A_cell.shape[0]
    nf1 = Mpp.shape[-1]
    M = torch.stack([Mpp, Mmm, Mpm, Mmp]).reshape(4 * nd * nd, nf1)
    diag = A_cell
    offs = []
    for l in range(cf.shape[0]):
        sel = isp[l][None, None, :]
        got = M[:, cf[l]].reshape(4, nd, nd, -1)
        diag = diag + torch.where(sel, got[0], got[1])
        offs.append(torch.where(sel, got[2], got[3]))
    return torch.stack([diag] + offs)      # (K, nd, nd, nc)


def gather_rhs(g, b_cell, b_p, b_m):
    """Assemble rhs (nd, nc) from the cell part and per-facet side parts
    (b_p/b_m: (nd, nf+1))."""
    cf = g["cf_idx"]
    isp = g["cf_is_plus"]
    nd = b_cell.shape[0]
    bpm = torch.cat([b_p, b_m])          # (2*nd, nf+1)
    b = b_cell
    for l in range(cf.shape[0]):
        got = bpm[:, cf[l]]
        b = b + torch.where(isp[l][None, :], got[:nd], got[nd:])
    return b


def _sip_blocks(g, kp, km, gnp, gnm, tau_over_h, sip_mask, pen_p=None, pen_m=None,
                neg=-1.0):
    """Symmetric interior penalty blocks for kappa grad(u).grad(v).

    kp/km   : (nq, nf+1) diffusion coefficient traces per side
    gnp/gnm : (nd, nf+1) = n . grad(basis) per side
    tau_over_h: (nf+1,) penalty scale tau/avg(h)
    pen_p/pen_m: (nq, nf+1) penalty coefficient per side (default avg kappa)
    Returns Mpp, Mpm, Mmp, Mmm, each (nd, nd, nf+1), masked by sip_mask.
    """
    w = g["w_f"]
    area = g["f_area"]
    Rp, Rm = g["f_Rp"], g["f_Rm"]

    # -<avg(k grad u).n, [v]>
    def term1(sign_v, R_v, k_u, gn_u):
        s = _wsum_vec(w, k_u, R_v)                           # (nd, nf)
        return sign_v * (neg * 0.5) * area * s[:, None, :] * gn_u[None, :, :]

    t1_pp = term1(+1.0, Rp, kp, gnp)
    t1_pm = term1(+1.0, Rp, km, gnm)
    t1_mp = term1(neg, Rm, kp, gnp)
    t1_mm = term1(neg, Rm, km, gnm)

    # symmetric term: transpose blocks with sides swapped
    T = lambda M: torch.swapaxes(M, 0, 1)
    t2_pp, t2_pm, t2_mp, t2_mm = T(t1_pp), T(t1_mp), T(t1_pm), T(t1_mm)

    if pen_p is None:
        pen_p = 0.5 * (kp + km)
        pen_m = pen_p
    scale = tau_over_h * area

    def pen(R_v, sv, R_u, su, coef):
        return (sv * su) * scale * _wsum_outer(w, coef, R_v, R_u)

    t3_pp = pen(Rp, +1, Rp, +1, pen_p)
    t3_pm = pen(Rp, +1, Rm, neg, pen_m)
    t3_mp = pen(Rm, neg, Rp, +1, pen_p)
    t3_mm = pen(Rm, neg, Rm, neg, pen_m)

    m = sip_mask[None, None, :]
    return (
        torch.where(m, t1_pp + t2_pp + t3_pp, 0.0),
        torch.where(m, t1_pm + t2_pm + t3_pm, 0.0),
        torch.where(m, t1_mp + t2_mp + t3_mp, 0.0),
        torch.where(m, t1_mm + t2_mm + t3_mm, 0.0),
    )


def _jump_jump_blocks(g, coef, mask, neg=-1.0):
    """coef * <[u],[v]> blocks on masked facets; coef (nf+1,), a broadcast
    over the static facet mass tensors E_vu (precompute_static)."""
    s = torch.where(mask, coef * g["f_area"], 0.0)[None, None, :]
    return (s * g["E_pp"], neg * s * g["E_pm"], neg * s * g["E_mp"], s * g["E_mm"])


def _test_integrals(g, vals_p, vals_m):
    """rhs side contributions: int_f vals_side * v_side.
    vals_* (nq, nf+1) -> b_p, b_m (nd, nf+1).  The caller encodes signs."""
    w = g["w_f"]
    b_p = g["f_area"] * _wsum_vec(w, vals_p, g["f_Rp"])
    b_m = g["f_area"] * _wsum_vec(w, vals_m, g["f_Rm"])
    return b_p, b_m


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------

def _dims(g):
    """(nq, nd, d, nc, nf+1) of a geometry dict; raises on a CUDA tensor
    outside the kernels' register arrays."""
    nq, nd, nf1 = g["f_Rp"].shape
    d, nc = g["G"].shape[1], g["G"].shape[2]
    if nd > MAX_ND or d > MAX_D:
        raise NotImplementedError(
            f"assembly: CUDA kernels built for nd <= {MAX_ND}, d <= {MAX_D}, "
            f"got nd = {nd}, d = {d}")
    return nq, nd, d, nc, nf1


def _tables(src, keys, dtype):
    """Device pointers of the static tables ``src[key]``: checked to be
    contiguous CUDA tensors of ``dtype`` (floats), int32 or bool."""
    out = []
    for key in keys:
        t = src[key]
        _cuda.check(key, t, dtype if t.is_floating_point() else None)
        if not t.is_floating_point() and t.dtype not in (torch.int32, torch.bool):
            raise TypeError(f"{key}: expected int32 or bool, got {t.dtype}")
        out.append(t.data_ptr())
    return out


def _ptr(name, t, dtype, shape):
    """The device pointer of a per-call input, checked with its shape (a
    contiguous CUDA tensor of ``dtype``; else _cuda.check raises why)."""
    if not (t.is_cuda and t.dtype == dtype and t.shape == shape and t.is_contiguous()):
        _cuda.check(name, t, dtype, shape)
    return t.data_ptr()


def _inputs(dtype, **tensors):
    """Device pointers of per-call inputs, each checked by :func:`_ptr`."""
    return [_ptr(name, t, dtype, shape) for name, (t, shape) in tensors.items()]


def _facet_blocks(lead, nd, nf1, like):
    return [torch.empty(lead + (nd, nd, nf1), dtype=like.dtype, device=like.device)
            for _ in range(4)]


# ---------------------------------------------------------------------------
# the per-cell kernels' static tables (K10 emi_cell, K11 knp_cell and
# alpha_sum, K14 eliminated_concentration)
# ---------------------------------------------------------------------------

CELL_MAX_IONS = 6         # the ion counts the cell kernels are built for: 1..6
NODE_ND = (2, 3, 4)       # the nd alpha_sum and eliminated_concentration are built for


class _CellTablesC(ctypes.Structure):
    """The C struct KnpCellTables of csrc/common.cuh (same order)."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("G", "vol", "D", "rho")] + [
        (k, ctypes.c_int) for k in ("nd", "d", "nc", "n_ions")] + [
        ("z", ctypes.c_double * CELL_MAX_IONS), ("zz", ctypes.c_double * CELL_MAX_IONS),
        ("phibar", ctypes.c_double * MAX_ND), ("M0", ctypes.c_double * (MAX_ND * MAX_ND))]


class CellTables(NamedTuple):
    """The static tables of :func:`emi_cell`, :func:`knp_cell` and the
    step's routes of :func:`alpha_sum` and :func:`eliminated_concentration`."""
    dims: tuple                  # nd, d, nc, n_ions (0 without z)
    dtype: torch.dtype
    z: Optional[torch.Tensor]    # the charges the tables hold (emi_cell's), or None
    D: Optional[torch.Tensor]    # the diffusion fields (n_ions, nc) alpha_sum reads, or None
    rho: Optional[torch.Tensor]  # the background charge (nc,) eliminated_concentration reads
    c_struct: Optional[_CellTablesC]   # on the card: the kernels' tables and constants
    ptr: int                     # its address (0 on the CPU)
    sources: tuple               # G, vol: the tensors c_struct points to
    buffers: dict                # (id(out), rows) -> (out, the pointers of its cell part):
                                 # the step's buffers checked once (_buffer_ptrs)


def _buffer_ptrs(tables, out, rows, named):
    """The pointers of the buffers ``named`` {name: (tensor, shape)}, fields
    of the step's buffers ``out`` holding ``rows`` ions ("alpha": alpha_sum's
    buffer), checked against the tables' dtype and the shapes, kept in the
    tables under (id(out), rows)
    with ``out`` (whose id stays its own while it is kept): the step's
    route checks its buffers the first time they meet the tables, and
    later calls read the pointers from there."""
    ptrs = _inputs(tables.dtype, **named)
    tables.buffers[(id(out), rows)] = (out, ptrs)
    return ptrs


def cell_tables(g, z=None, D=None, rho=None) -> CellTables:
    """The per-cell kernels' static tables of a geometry and the ions'
    charges ``z`` (n_ions,), which emi_cell reads (knp_cell none), and, for
    the step's routes of alpha_sum and eliminated_concentration, the
    solver's diffusion fields ``D`` (n_ions, nc) and background charge
    ``rho`` (nc,) (both need z).  On the card G, vol, phibar, M0, z, D and
    rho are checked here, not per call (contiguous, G's dtype, their
    shapes), the shapes against the built kernels (nd = d + 1 <= 4, at most
    CELL_MAX_IONS ions: NotImplementedError), and z, z * z (rounded in that
    dtype), phibar and M0 are read to the host once: the launches pass them
    by value.  A caller that assembles again and again builds them once
    (Solver._cell_tables) and passes them as ``tables=``; a call without
    them builds its own."""
    G, vol = g["G"], g["vol"]
    fdt, n_ions = G.dtype, 0 if z is None else z.shape[0]
    if z is None and (D is not None or rho is not None):
        raise ValueError("cell_tables: D and rho need the charges z")
    if not G.is_cuda:
        return CellTables(tuple(G.shape) + (n_ions,), fdt, z, D, rho, None, 0,
                          (G, vol, D, rho), {})
    _, nd, d, nc, _ = _dims(g)
    if nd != d + 1 or n_ions > CELL_MAX_IONS:
        raise NotImplementedError(
            f"emi_cell / knp_cell: CUDA kernels built for nd = d + 1 and at most "
            f"{CELL_MAX_IONS} ions, got nd = {nd}, d = {d}, {n_ions} ions")
    if fdt not in (torch.float32, torch.float64):
        raise TypeError(f"cell_tables: float32/float64 tables, got {fdt}")
    named = {"G": (G, (nd, d, nc)), "vol": (vol, (nc,)), "phibar": (g["phibar"], (nd,)),
             "M0": (g["M0"], (nd, nd))}
    if z is not None:
        named["z"] = (z, (n_ions,))
    if D is not None:
        named["D"] = (D, (n_ions, nc))
    if rho is not None:
        named["rho"] = (rho, (nc,))
    for key, (t, shape) in named.items():
        _cuda.check(key, t, fdt, shape)
    host = torch.cat([g["phibar"], g["M0"].reshape(-1)]
                     + ([] if z is None else [z])).tolist()      # one read
    phibar, M0, zs = host[:nd], host[nd:nd + nd * nd], host[nd + nd * nd:]
    ptr = lambda t: 0 if t is None else t.data_ptr()
    st = _cell_tables_c(fdt, (G.data_ptr(), vol.data_ptr(), ptr(D), ptr(rho)),
                        (nd, d, nc), zs, phibar, M0)
    return CellTables((nd, d, nc, n_ions), fdt, z, D, rho, st, ctypes.addressof(st),
                      (G, vol, D, rho), {})


def _cell_tables_c(fdt, ptrs, dims, zs, phibar=(), M0=()):
    """The C struct of :func:`cell_tables` from the pointers (G, vol, D,
    rho; 0 for none), (nd, d, nc), the charges ``zs`` (host floats) with
    their squares rounded in ``fdt``, phibar and M0 (host floats)."""
    rnd = np.float32 if fdt == torch.float32 else np.float64
    zz = [float(rnd(v) * rnd(v)) for v in zs]
    pad = lambda v, n: list(v) + [0.0] * (n - len(v))
    return _CellTablesC(*ptrs, *dims, len(zs),
                        (ctypes.c_double * CELL_MAX_IONS)(*pad(zs, CELL_MAX_IONS)),
                        (ctypes.c_double * CELL_MAX_IONS)(*pad(zz, CELL_MAX_IONS)),
                        (ctypes.c_double * MAX_ND)(*pad(phibar, MAX_ND)),
                        (ctypes.c_double * (MAX_ND * MAX_ND))(*pad(M0, MAX_ND * MAX_ND)))


# ---------------------------------------------------------------------------
# K10: EMI system (potential)
# ---------------------------------------------------------------------------

def emi_cell_plain(g, z, D, c, F, psi, neg=-1.0):
    """Per-cell part of the EMI assembly: kappa = F psi sum_k z_k^2 D_k c_k
    (nd, nc), its cell mean kbar (nc,), flux = sum_k z_k D_k grad(c_k)
    (d, nc) and the rhs cell part -F vol flux . grad(basis) (nd, nc)."""
    kappa = F * psi * torch.einsum("k,kc,kic->ic", z * z, D, c)
    kbar = torch.einsum("i,ic->c", g["phibar"], kappa)
    gradc = torch.einsum("idc,kic->kdc", g["G"], c)           # (n_ions, d, nc)
    flux = torch.einsum("k,kc,kdc->dc", z, D, gradc)          # (d, nc)
    b_cell = neg * F * g["vol"] * torch.einsum("dc,idc->ic", flux, g["G"])
    # an einsum may return a permuted memory order; the kernels never do
    return tuple(t.contiguous() for t in (kappa, kbar, flux, b_cell))


def emi_cell(g, z, D, c, F, psi, out=None, tables=None):
    """:func:`emi_cell_plain`, kernel K10 ``emi_cell`` on a CUDA tensor: one
    launch, a thread a cell.  ``tables``: :func:`cell_tables` of ``g`` and
    this ``z`` (checked when they were built); without them they are built
    here.  ``out``: buffers of :func:`emi_emit_buffers` (checked the first
    time they meet the tables), whose kappa, kbar, flux and b_cell are
    written and returned (on the CPU the plain results are copied into
    them); without it new tensors."""
    if not c.is_cuda:
        res = emi_cell_plain(g, z, D, c, F, psi)
        if out is None:
            return res
        dst = (out.kappa, out.kbar, out.flux, out.b_cell)
        for a, b in zip(dst, res):
            a.copy_(b)
        return dst
    if tables is None:
        tables = cell_tables(g, z)
    elif tables.z is not z:
        raise ValueError("emi_cell: tables built for other charges z")
    nd, d, nc, n_ions = tables.dims
    dt_ = tables.dtype
    ins = (_ptr("D", D, dt_, (n_ions, nc)), _ptr("c", c, dt_, (n_ions, nd, nc)))
    if out is None:
        new = lambda *shape: torch.empty(shape, dtype=dt_, device=c.device)
        res = (new(nd, nc), new(nc), new(d, nc), new(nd, nc))
        outs = [t.data_ptr() for t in res]
    else:
        res = (out.kappa, out.kbar, out.flux, out.b_cell)
        hit = tables.buffers.get((id(out), n_ions))
        outs = hit[1] if hit else _buffer_ptrs(tables, out, n_ions, {
            "out_kappa": (res[0], (nd, nc)), "out_kbar": (res[1], (nc,)),
            "out_flux": (res[2], (d, nc)), "out_b_cell": (res[3], (nd, nc))})
    _cuda.launch("emi_cell", "knp_emi_cell", dt_, tables.ptr, *ins, *outs, float(F * psi),
                 float(-F))
    return res


_EMI_FACET_TABLES = ("f_cp", "f_cm", "f_n", "f_area", "f_havg", "f_Rp", "f_Rm", "gnp",
                     "gnm", "E_pp", "E_pm", "E_mp", "E_mm", "w_f")


def emi_facet_plain(g, masks, kappa, flux, gr, mem_t, F, C_phi, tau, neg=-1.0):
    """Per-facet part of the EMI assembly: the SIP + penalty blocks plus
    C_phi <[u],[v]> on membrane facets, Mpp, Mpm, Mmp, Mmm (nd, nd, nf+1),
    and the facet rhs parts b_p, b_m (nd, nf+1): the flux average on SIP
    facets and the Robin source C_phi gr JUMP(v) on membrane facets (``gr``
    (n_mem+1,) on the membrane axis)."""
    kp = facet_trace(g, kappa, "p")                          # (nq, nf+1)
    km = facet_trace(g, kappa, "m")
    sip = masks["f_sip"]
    mem = masks["f_mem"]
    Mpp, Mpm, Mmp, Mmm = _sip_blocks(g, kp, km, g["gnp"], g["gnm"],
                                     tau / g["f_havg"], sip, neg=neg)
    # membrane coupling: + C_phi <[u],[v]> on membrane facets
    cphi = torch.full_like(g["f_area"], C_phi)
    Cpp, Cpm, Cmp, Cmm = _jump_jump_blocks(g, cphi, mem, neg=neg)
    blocks = [(M + C).contiguous() for M, C in
              ((Mpp, Cpp), (Mpm, Cpm), (Mmp, Cmp), (Mmm, Cmm))]

    ones = torch.ones_like(g["f_Rp"][:, 0, :])                # (nq, nf+1)
    fp = torch.einsum("df,df->f", flux[:, g["f_cp"]], g["f_n"])
    fm = torch.einsum("df,df->f", flux[:, g["f_cm"]], g["f_n"])
    favg_q = (0.5 * F * (fp + fm) * sip)[None, :] * ones      # (nq, nf+1)
    b_p, b_m = _test_integrals(g, favg_q, neg * favg_q)
    nm = mem_t["cp"].shape[0]
    fidx = mem_t["fidx"]
    src = C_phi * gr[:nm] * g["f_area"][fidx]                  # (nm,)
    w_f = g["w_f"]
    b_p = b_p.index_add(1, fidx, neg * src * torch.einsum("q,qim->im", w_f, mem_t["Rp"]))
    b_m = b_m.index_add(1, fidx, src * torch.einsum("q,qim->im", w_f, mem_t["Rm"]))
    return (*blocks, b_p.contiguous(), b_m.contiguous())


def emi_facet(g, masks, kappa, flux, gr, mem_t, F, C_phi, tau):
    """:func:`emi_facet_plain`, kernel K10 ``emi_facet`` on a CUDA tensor;
    the membrane source is read through the inverse membrane map
    ``mem_t["inv"]`` (nf+1,), a gather."""
    if not kappa.is_cuda:
        return emi_facet_plain(g, masks, kappa, flux, gr, mem_t, F, C_phi, tau)
    nq, nd, d, nc, nf1 = _dims(g)
    if nq > MAX_NQ:
        raise NotImplementedError(
            f"emi_facet: CUDA kernel built for nq <= {MAX_NQ} facet quadrature points, "
            f"got {nq}")
    dt_ = kappa.dtype
    nm = mem_t["cp"].shape[0]
    ins = _inputs(dt_, kappa=(kappa, (nd, nc)), flux=(flux, (d, nc)), gr=(gr, (nm + 1,)))
    _cuda.check("inv", mem_t["inv"], torch.int32, (nf1,))
    blocks = _facet_blocks((), nd, nf1, kappa)
    b_p = torch.empty((nd, nf1), dtype=dt_, device=kappa.device)
    b_m = torch.empty_like(b_p)
    _cuda.launch("emi_facet", "knp_emi_facet", dt_, *ins, mem_t["inv"].data_ptr(),
                 *_tables(g, _EMI_FACET_TABLES, dt_),
                 *_tables(masks, ("f_sip", "f_mem"), dt_),
                 *(M.data_ptr() for M in blocks), b_p.data_ptr(), b_m.data_ptr(),
                 nq, nd, d, nc, nf1, float(tau), float(C_phi), float(F))
    return (*blocks, b_p, b_m)


def emi_emit_cell_plain(g, kbar, Mpp, Mpm, Mmp, Mmm, b_cell, b_p, b_m, inv_Lp2,
                        pair=False):
    """Per-cell emit of the EMI assembly: A_cell = vol kbar GG plus the
    gathered facet blocks -> (blocks (K, nd, nd, nc), rhs (nd, nc), P_diag
    (nd, nd, nc)) with P_diag = blocks[0] + reg, reg = vol kbar / Lp^2 M0.
    ``pair``: (A_cell, rhs, reg) for the pair emit (ops.pairs)."""
    vk = g["vol"] * kbar
    A_cell = vk * g["GG"]
    reg = (vk * inv_Lp2) * g["M0"][:, :, None]
    rhs = gather_rhs(g, b_cell, b_p, b_m).contiguous()
    if pair:
        return A_cell, rhs, reg
    blocks = gather_blocks(g, A_cell, Mpp, Mpm, Mmp, Mmm)
    return blocks, rhs, (blocks[0] + reg).contiguous()


class EmiEmitOut(NamedTuple):
    """The buffers of the step's EMI assembly: what :func:`emi_emit_cell`
    writes, then what :func:`emi_cell` writes."""
    blocks: torch.Tensor       # (K, nd, nd, nc); pair layout: A_cell (nd, nd, nc)
    rhs: torch.Tensor          # (nd, nc)
    second: torch.Tensor       # P_diag (nd, nd, nc); pair layout: reg (nd, nd, nc)
    kappa: torch.Tensor        # (nd, nc)
    kbar: torch.Tensor         # (nc,)
    flux: torch.Tensor         # (d, nc)
    b_cell: torch.Tensor       # (nd, nc)


def emi_emit_buffers(g, dtype, device, pair=False) -> EmiEmitOut:
    """Output buffers of :func:`emi_emit_cell` and :func:`emi_cell` for a
    caller that assembles the same operator again and again (the solver's
    step)."""
    nfac, nc = g["cf_idx"].shape
    nd, d = g["GG"].shape[0], g["G"].shape[1]
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    return EmiEmitOut(new(nd, nd, nc) if pair else new(nfac + 1, nd, nd, nc), new(nd, nc),
                      new(nd, nd, nc), new(nd, nc), new(nc), new(d, nc), new(nd, nc))


def emi_emit_cell(g, kbar, Mpp, Mpm, Mmp, Mmm, b_cell, b_p, b_m, inv_Lp2, pair=False,
                  out=None, tables=None):
    """:func:`emi_emit_cell_plain`, kernel K10 ``emi_emit_cell`` on a CUDA
    tensor (equal to it exactly): one launch, a thread a block entry and
    cell.  The cell-facet slots are read from the packed slot words that
    K11's membrane emit reads too: ``tables`` (:func:`knp_emit_tables`,
    built once by the solver; only its ``slots`` are read), else the words
    are packed in the call (:func:`slot_words`).  ``out``: buffers of
    :func:`emi_emit_buffers` to write and return (on the CPU the plain
    results are copied into them); without it new tensors."""
    if not kbar.is_cuda:
        res = emi_emit_cell_plain(g, kbar, Mpp, Mpm, Mmp, Mmm, b_cell, b_p, b_m, inv_Lp2,
                                  pair)
        if out is None:
            return res
        for dst, src in zip(out[:3], res):
            dst.copy_(src)
        return tuple(out[:3])
    _, nd, d, nc, nf1 = _dims(g)
    if nd != d + 1:
        raise NotImplementedError(
            f"emi_emit_cell: CUDA kernel built for nd = d + 1 (degree 1 on simplices), "
            f"got nd = {nd}, d = {d}")
    if tables is None:
        slots = slot_words(g)
    elif tables.dims[2:5] == (d + 1, nc, nf1) and tables.slots.device == kbar.device:
        slots = tables.slots
    else:
        raise ValueError(f"emi_emit_cell: tables of {tables.dims[2:5]} (cell facets, cells, "
                         f"facets) on {tables.slots.device}, the geometry has "
                         f"{(d + 1, nc, nf1)} on {kbar.device}")
    dt_ = kbar.dtype
    if out is None:
        out = emi_emit_buffers(g, dt_, kbar.device, pair)
    fb, sq = (nd, nd, nf1), (nd, nd, nc)
    ins = _inputs(dt_, kbar=(kbar, (nc,)), vol=(g["vol"], (nc,)), GG=(g["GG"], sq),
                  M0=(g["M0"], (nd, nd)), Mpp=(Mpp, fb), Mpm=(Mpm, fb), Mmp=(Mmp, fb),
                  Mmm=(Mmm, fb), b_cell=(b_cell, (nd, nc)), b_p=(b_p, (nd, nf1)),
                  b_m=(b_m, (nd, nf1)))
    outs = _inputs(dt_, out_blocks=(out.blocks, sq if pair else (d + 2,) + sq),
                   out_rhs=(out.rhs, (nd, nc)), out_second=(out.second, sq))
    _cuda.launch("emi_emit_cell", "knp_emi_emit_cell", dt_, *ins, slots.data_ptr(), *outs, nd,
                 d + 1, nc, nf1, int(pair), float(inv_Lp2))
    return tuple(out[:3])


def assemble_emi(
    g: Dict[str, Any],
    masks: Dict[str, Any],
    ions: Dict[str, Any],        # z (n_ions,), D (n_ions, nc), c (n_ions, nd, nc)
    phys: Dict[str, Any],        # F, psi, C_phi, tau_emi, Lp
    phi_M: torch.Tensor,         # (n_mem+1,) padded
    I_ch_tot: torch.Tensor,      # (n_mem+1,) padded
    *,
    mem_t: Dict[str, Any],
    splitting: bool = True,
    mms=None,
    t=None,
    pm: Optional[Dict[str, Any]] = None,
    out=None,
    buffers=None,
    tables=None,
    cell_tables=None,
):
    """EMI block-ELL operator, rhs and block-Jacobi preconditioner diagonal
    (the regularised B operator), in three steps (kernel K10 on the card):
    :func:`emi_cell`, :func:`emi_facet`, :func:`emi_emit_cell`.  ``mem_t``:
    membrane-presliced tables; the Robin membrane source lives on the n_mem
    axis.

    Returns (blocks (K,nd,nd,nc), rhs (nd,nc), P_diag (nd,nd,nc)); with
    pair maps ``pm``, ((pd, pe), rhs, P_diag_pair), where the pair
    diagonal of P_diag includes the intra-pair coupling; ``out`` (pairs
    only): the pair emit's (pd, pe, P_diag_pair) buffers
    (ops.pairs.emit_buffers), written and returned; ``buffers``: the EMI
    emit's and the cell part's (:func:`emi_emit_buffers`, made for this
    layout), written (on the cell layout the emit's returned); ``tables``:
    the packed slot words' tables (:func:`knp_emit_tables`), packed in the
    call without them; ``cell_tables``: :func:`emi_cell`'s
    (:func:`cell_tables` of ``g`` and ``ions["z"]``), built in the call
    without them.

    ``mms`` (an MMSProblem, cell layout only): the manufactured problem's
    interface data on the membrane (wall) facets replace the Robin source,
    and its volume source and exterior Neumann flux at time ``t`` are added
    to the rhs (:func:`emi_mms_facet`, :func:`emi_mms_rhs`)."""
    _degree1(g)
    if mms is not None and pm is not None:
        raise NotImplementedError("MMS verification runs on the cell layout only")
    F, psi, C_phi, tau = phys["F"], phys["psi"], phys["C_phi"], phys["tau_emi"]

    kappa, kbar, flux, b_cell = emi_cell(g, ions["z"], ions["D"], ions["c"], F, psi,
                                         out=buffers, tables=cell_tables)
    # Robin data: splitting -> phi_M; passive -> phi_M - I_ch/C_phi; MMS ->
    # none here (a zero source), its interface data below.
    # Term: + C_phi g JUMP(v) = g C_phi (v_i - v_e)
    if mms is not None:
        gr = torch.zeros_like(phi_M)
    else:
        gr = phi_M if splitting else phi_M - I_ch_tot / C_phi
    *M, b_p, b_m = emi_facet(g, masks, kappa, flux, gr, mem_t, F, C_phi, tau)
    if mms is not None:
        b_p, b_m = emi_mms_facet(g, masks, mms, t, C_phi, b_p, b_m)
    # preconditioner: diag blocks of B = A + kappa/Lp^2 mass
    inv_Lp2 = 1.0 / phys["Lp"] ** 2
    if pm is not None:
        A_cell, rhs, reg = emi_emit_cell(g, kbar, *M, b_cell, b_p, b_m, inv_Lp2, pair=True,
                                         out=buffers, tables=tables)
        pd, pe, P_diag = gather_blocks_pair(g, pm, A_cell, *M, reg=reg, out=out)
        return (pd, pe), rhs, P_diag
    blocks, rhs, P_diag = emi_emit_cell(g, kbar, *M, b_cell, b_p, b_m, inv_Lp2, out=buffers,
                                        tables=tables)
    if mms is not None:
        rhs = emi_mms_rhs(g, mms, ions["z"], F, t, rhs)
    return blocks, rhs, P_diag


# ---------------------------------------------------------------------------
# MMS verification terms: torch ops outside the kernels, as the JAX package
# computes them with jnp outside its kernels
# ---------------------------------------------------------------------------

def _wall_data(g, funcs, wall_tags, t):
    """sum over the walls of (f_stag == wall) funcs[wall](f_qp, t) -> (nq, nf+1)."""
    xq, stag = g["f_qp"], g["f_stag"]
    out = torch.zeros_like(xq[:, 0, :])
    for wall in wall_tags:
        out = out + (stag == wall)[None, :] * funcs[wall](xq, t)
    return out


def _volume_source(g, f_sub, t):
    """int_cell f v with f = f_sub[cell tag](x, t), tags 0 and 1 -> (nd, nc)."""
    xq = g["cell_qp"]                                          # (nq, d, nc)
    fsrc = torch.where(g["cell_tag"][None, :] == 1, f_sub[1](xq, t), f_sub[0](xq, t))
    return g["vol"] * torch.einsum("q,qc,qi->ic", g["w_c"], fsrc, g["Phi_c"])


def exterior_groups(e_c):
    """The exterior facets in groups that repeat no cell, as facet index
    tensors: a cell's k-th exterior facet (in facet order) in group k.  A
    renumbering of the cells keeps the groups."""
    ec = e_c.cpu().numpy()
    order = np.argsort(ec, kind="stable")
    first = np.searchsorted(ec[order], ec[order])      # the cell's first slot
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order)) - first
    return tuple(torch.as_tensor(np.flatnonzero(rank == k), device=e_c.device)
                 for k in range(int(rank.max()) + 1 if len(rank) else 0))


def _add_exterior(g, rhs, bdry, scale):
    """rhs + scale int_ds bdry v over the exterior facets, bdry (nq, ne).
    A cell with several exterior facets (a corner) adds them in facet
    order, one index_add per group of g["e_groups"] (:func:`exterior_groups`):
    a card's index_add adds repeated indices by atomics, in no fixed order,
    so one index_add over all facets would not repeat to the last bit."""
    be = scale * g["e_area"] * torch.einsum("q,qf,qif->if", g["w_f"], bdry, g["e_R"])
    for sel in g["e_groups"]:
        rhs = rhs.index_add(1, g["e_c"][sel], be[:, sel])
    return rhs


def emi_mms_facet(g, masks, mms, t, C_phi, b_p, b_m):
    """The EMI facet rhs parts b_p, b_m (nd, nf+1) plus the MMS interface
    data on the membrane facets: the Robin data C_phi g_phi JUMP(v) and the
    flux-jump defect g_J_phi on the plus side."""
    gphi = _wall_data(g, mms.g_phi, mms.wall_tags, t)
    gJ = _wall_data(g, mms.g_J_phi, mms.wall_tags, t)
    mem = masks["f_mem"][None, :]
    bg_p, bg_m = _test_integrals(g, -C_phi * gphi, C_phi * gphi)
    bj_p, _ = _test_integrals(g, gJ, torch.zeros_like(gJ))
    return b_p + (bg_p + bj_p) * mem, b_m + bg_m * mem


def emi_mms_rhs(g, mms, z, F, t, rhs):
    """The EMI rhs (nd, nc) plus the MMS volume source f_phi and the
    exterior Neumann term -F sum_k z_k (J_k . n) v."""
    rhs = rhs + _volume_source(g, mms.f_phi, t)
    bdry = torch.zeros_like(g["e_qp"][:, 0, :])
    for k in range(len(mms.neumann)):
        Jk = mms.neumann[k](g["e_qp"], t)                     # (nq, d, ne)
        bdry = bdry + z[k] * torch.einsum("qdf,df->qf", Jk, g["e_n"])
    return _add_exterior(g, rhs, bdry, -F)


def knp_mms_facet(g, masks, mms, k, t, phi, C_e, C_i):
    """The MMS membrane rhs parts b_p, b_m (nd, nf+1) of solved ion k: the
    Robin data C_i g_1 v_i - C_e g_2 v_e with the constant couplings C_sub
    and the coupling -[phi][C] avg(v) - [phi] avg(C) [v]."""
    g1 = _wall_data(g, mms.g_robin_1[k], mms.wall_tags, t)
    g2 = _wall_data(g, mms.g_robin_2[k], mms.wall_tags, t)
    mem = masks["f_mem"][None, :]
    br_p, br_m = _test_integrals(g, -C_e * g2 * mem, C_i * g1 * mem)
    jphi = facet_trace(g, phi, "p") - facet_trace(g, phi, "m")
    jC = C_e - C_i                # [C] = C_plus - C_minus
    aC = 0.5 * (C_e + C_i)
    val_p = (-jphi * jC * 0.5 - jphi * aC) * mem
    val_m = (-jphi * jC * 0.5 + jphi * aC) * mem
    bc_p, bc_m = _test_integrals(g, val_p, val_m)
    return br_p + bc_p, br_m + bc_m


def knp_mms_rhs(g, masks, mms, k, t, phi, C_e, C_i, rhs):
    """The KNP rhs of solved ion k from its cell part ``rhs`` (nd, nc): the
    MMS membrane parts gathered in, the volume source f_c[k] and the
    exterior Neumann term -(J_k . n) v."""
    b_p, b_m = knp_mms_facet(g, masks, mms, k, t, phi, C_e, C_i)
    rhs = gather_rhs(g, rhs, b_p, b_m) + _volume_source(g, mms.f_c[k], t)
    bdry = torch.einsum("qdf,df->qf", mms.neumann[k](g["e_qp"], t), g["e_n"])
    return _add_exterior(g, rhs, bdry, -1.0)


# ---------------------------------------------------------------------------
# KNP system
# ---------------------------------------------------------------------------

def assemble_knp_static(g, masks, ion, phys):
    """Time-independent part of the KNP operator for one ion: mass/dt +
    stiffness + SIP + penalty (D is a static P0 field).  Setup only."""
    _degree1(g)
    z, D = ion["z"], ion["D"]
    dt, tau = phys["dt"], phys["tau_knp"]
    A_cell = (g["vol"] / dt) * g["M0"][:, :, None] + (g["vol"] * D) * g["GG"]
    sip = masks["f_sip"]
    ones = torch.ones_like(g["f_Rp"][:, 0, :])
    Dp = D[g["f_cp"]][None, :] * ones
    Dm = D[g["f_cm"]][None, :] * ones
    # penalty uses jump(D u): coefficient D per side
    Mpp, Mpm, Mmp, Mmm = _sip_blocks(
        g, Dp, Dm, g["gnp"], g["gnm"], tau / g["f_havg"], sip, pen_p=Dp, pen_m=Dm
    )
    return gather_blocks(g, A_cell, Mpp, Mpm, Mmp, Mmm)


def alpha_sum_plain(z, D, c):
    """sum_k z_k^2 D_k c_k over all ions: z (n,), D (n, nc), c (n, nd, nc)
    -> (nd, nc)."""
    return torch.einsum("k,kc,kic->ic", z * z, D, c).contiguous()


def alpha_sum_ordered_plain(z, D, c, c_elim):
    """:func:`alpha_sum_plain` summed in the kernel's order, from ``c`` the
    solved ions' (n - 1, nd, nc) and ``c_elim`` (nd, nc), the last term:
    acc = acc + (zz_k D_k) c_k from zero, zz = z * z in the dtype, each
    product and sum rounded apart (the kernel builds without contraction),
    so on the card the kernel equals it to the last bit."""
    zz = z * z
    acc = torch.zeros_like(c_elim)
    for k, ck in enumerate(list(c) + [c_elim]):
        acc = acc + (zz[k] * D[k]) * ck
    return acc


def alpha_sum(z, D, c, c_elim=None, out=None, tables=None):
    """:func:`alpha_sum_plain`, kernel K11 ``alpha_sum`` on a CUDA tensor:
    one launch, a thread one node, for nd in NODE_ND and 1 to
    CELL_MAX_IONS ions (NotImplementedError otherwise).  Two routes:

    * the public one, ``alpha_sum(z, D, c)``: z, D and c (n, nd, nc) checked
      each call, z read to the host (z * z comes by value), a new tensor;
    * the step's, ``alpha_sum(z, D, c, c_elim, out=None, tables=)``:
      ``tables`` :func:`cell_tables` of these ``z`` and ``D`` (checked when
      they were built), ``c`` the solved ions' (n - 1, nd, nc) and
      ``c_elim`` the eliminated ion's (nd, nc), the last ion, read in place
      with no concatenation (on the CPU the plain version runs on their
      concatenation); only c, c_elim and, the first time they meet the
      tables, the buffers are checked.  ``out``: buffers of
      :func:`knp_emit_buffers` whose alpha is written and returned (on the
      CPU the plain result is copied into it); without it a new tensor.

    ``c_elim`` and ``out`` go only with ``tables`` (ValueError)."""
    if (tables is None) != (c_elim is None) or (out is not None and tables is None):
        raise ValueError("alpha_sum: c_elim and out go with tables (the step's route), "
                         "which reads c_elim apart")
    if tables is not None and (tables.D is None or tables.z is not z or tables.D is not D):
        raise ValueError("alpha_sum: tables built without D, or for other charges z "
                         "or fields D")
    if not c.is_cuda:
        res = alpha_sum_plain(z, D, c if c_elim is None else torch.cat([c, c_elim[None]]))
        if out is None:
            return res
        out.alpha.copy_(res)
        return out.alpha
    if tables is None:
        n, nd, nc = c.shape
        dt_ = c.dtype
    else:
        nd, _, nc, n = tables.dims
        dt_ = tables.dtype
    if not (1 <= n <= CELL_MAX_IONS and nd in NODE_ND):
        raise NotImplementedError(
            f"alpha_sum: CUDA kernel built for nd in {NODE_ND} and 1 to {CELL_MAX_IONS} "
            f"ions, got nd = {nd}, {n} ions")
    if tables is None:
        cp = _ptr("c", c, dt_, (n, nd, nc))
        ce = cp + (n - 1) * nd * nc * c.element_size()
        _, dp = _inputs(dt_, z=(z, (n,)), D=(D, (n, nc)))
        st = _cell_tables_c(dt_, (0, 0, dp, 0), (nd, nd - 1, nc), z.tolist())
        res = torch.empty((nd, nc), dtype=dt_, device=c.device)
        _cuda.launch("alpha_sum", "knp_alpha_sum", dt_, ctypes.addressof(st), cp, ce,
                     res.data_ptr())
        return res
    cp, ce = _ptr("c", c, dt_, (n - 1, nd, nc)), _ptr("c_elim", c_elim, dt_, (nd, nc))
    if out is None:
        res = torch.empty((nd, nc), dtype=dt_, device=c.device)
        optr = res.data_ptr()
    else:
        res = out.alpha
        hit = tables.buffers.get((id(out), "alpha"))
        optr = hit[1][0] if hit else _buffer_ptrs(tables, out, "alpha", {
            "out_alpha": (res, (nd, nc))})[0]
    _cuda.launch("alpha_sum", "knp_alpha_sum", dt_, tables.ptr, cp, ce, optr)
    return res


def knp_cell_plain(g, phi, c_n, dt):
    """Per-cell part of the KNP assembly: grad(phi) (d, nc), the drift
    G . grad(phi) (nd, nc), and the mass rhs (vol/dt) M0 c_n (m, nd, nc)."""
    gphi = cell_grad(g, phi)
    drift = torch.einsum("idc,dc->ic", g["G"], gphi)
    b_cell = (g["vol"] / dt) * torch.einsum("ij,kjc->kic", g["M0"], c_n)
    return gphi.contiguous(), drift.contiguous(), b_cell.contiguous()


def knp_cell(g, phi, c_n, dt, out=None, tables=None):
    """:func:`knp_cell_plain`, kernel K11 ``knp_cell`` on a CUDA tensor: one
    launch, a thread a cell.  ``tables``: :func:`cell_tables` of ``g``
    (checked when they were built); without them they are built here.
    ``out``: buffers of :func:`knp_emit_buffers` (checked the first time
    they meet the tables for this many ions), whose gphi, drift and b_cell
    are written and returned (on the CPU the plain results are copied into
    them); without it new tensors."""
    if not phi.is_cuda:
        res = knp_cell_plain(g, phi, c_n, dt)
        if out is None:
            return res
        dst = (out.gphi, out.drift, out.b_cell)
        for a, b in zip(dst, res):
            a.copy_(b)
        return dst
    tab = tables if tables is not None else cell_tables(g)
    nd, d, nc, _ = tab.dims
    m, dt_ = c_n.shape[0], tab.dtype
    if not 1 <= m <= CELL_MAX_IONS:
        raise NotImplementedError(
            f"knp_cell: CUDA kernel built for 1 to {CELL_MAX_IONS} solved ions, got {m}")
    ins = (_ptr("phi", phi, dt_, (nd, nc)), _ptr("c_n", c_n, dt_, (m, nd, nc)))
    if out is None:
        new = lambda *shape: torch.empty(shape, dtype=dt_, device=phi.device)
        res = (new(d, nc), new(nd, nc), new(m, nd, nc))
        outs = [t.data_ptr() for t in res]
    else:
        res = (out.gphi, out.drift, out.b_cell)
        hit = tab.buffers.get((id(out), m))
        outs = hit[1] if hit else _buffer_ptrs(tab, out, m, {
            "out_gphi": (res[0], (d, nc)), "out_drift": (res[1], (nd, nc)),
            "out_b_cell": (res[2], (m, nd, nc))})
    _cuda.launch("knp_cell", "knp_ion_cell", dt_, tab.ptr, *ins, *outs, m, float(dt))
    return res


def knp_facet_plain(g, masks, z, D, gphi, psi, neg=-1.0):
    """The m ions' upwind facet blocks Mpp, Mpm, Mmp, Mmm (m, nd, nd, nf+1)
    with the switch u_p = max(grad(phi)_plus . n, 0), u_m = max(-grad(phi)_minus
    . n, 0) shared by the ions."""
    d = gphi.shape[0]
    # one stacked gather per side: [gphi | D_all]
    stackA = torch.cat([gphi, D], dim=0)             # (d+m, nc)
    SP = stackA[:, g["f_cp"]]
    SM = stackA[:, g["f_cm"]]
    u_p = torch.clamp(torch.einsum("df,df->f", SP[:d], g["f_n"]), min=0.0)
    u_m = torch.clamp(neg * torch.einsum("df,df->f", SM[:d], g["f_n"]), min=0.0)
    D_p, D_m = SP[d:], SM[d:]                        # (m, nf+1)
    scale = (neg * psi) * z[:, None] * (g["f_area"] * masks["f_sip"])[None, :]
    sp_ = (scale * D_p * u_p[None, :])[:, None, None, :]
    sm_ = (scale * D_m * u_m[None, :])[:, None, None, :]
    # the broadcast products may come out in a permuted memory order
    return tuple(M.contiguous() for M in (
        sp_ * g["E_pp"][None], neg * sm_ * g["E_pm"][None],
        neg * sp_ * g["E_mp"][None], sm_ * g["E_mm"][None]))


def knp_facet_ordered_plain(g, masks, z, D, gphi, psi):
    """:func:`knp_facet_plain` with each facet's normal products summed in
    kernel K11's order (from zero, e ascending), so the kernel equals it to
    the last bit; the card tests hold it so."""
    d = gphi.shape[0]
    SP, SM = gphi[:, g["f_cp"]], gphi[:, g["f_cm"]]
    unp, unm = torch.zeros_like(g["f_area"]), torch.zeros_like(g["f_area"])
    for e in range(d):
        unp = unp + SP[e] * g["f_n"][e]
        unm = unm + SM[e] * g["f_n"][e]
    u_p, u_m = torch.clamp(unp, min=0.0), torch.clamp(-unm, min=0.0)
    scale = -psi * z[:, None] * (g["f_area"] * masks["f_sip"])[None, :]
    sp_ = (scale * D[:, g["f_cp"]] * u_p[None, :])[:, None, None, :]
    sm_ = (scale * D[:, g["f_cm"]] * u_m[None, :])[:, None, None, :]
    return tuple(M.contiguous() for M in (
        sp_ * g["E_pp"][None], -sm_ * g["E_pm"][None],
        -sp_ * g["E_mp"][None], sm_ * g["E_mm"][None]))


def knp_facet(g, masks, z, D, gphi, psi):
    """:func:`knp_facet_plain`, kernel K11 ``knp_facet`` on a CUDA tensor."""
    if not gphi.is_cuda:
        return knp_facet_plain(g, masks, z, D, gphi, psi)
    _, nd, d, nc, nf1 = _dims(g)
    m = z.shape[0]
    dt_ = gphi.dtype
    ins = _inputs(dt_, gphi=(gphi, (d, nc)), D=(D, (m, nc)), z=(z, (m,)))
    blocks = _facet_blocks((m,), nd, nf1, gphi)
    # each facet's 2m upwind scalars, computed once a facet by the first
    # of the launch's two kernels and read by the second
    scalars = torch.empty((2 * m, nf1), dtype=dt_, device=gphi.device)
    _cuda.launch("knp_facet", "knp_ion_facet", dt_, *ins,
                 *_tables(g, ("f_cp", "f_cm", "f_n", "f_area"), dt_),
                 masks["f_sip"].data_ptr(),
                 *_tables(g, ("E_pp", "E_pm", "E_mp", "E_mm"), dt_),
                 *(M.data_ptr() for M in blocks), scalars.data_ptr(), m, nd, d, nc, nf1,
                 float(-psi))
    return tuple(blocks)


def knp_membrane_rhs_plain(g, mem_t, z, D, c_k, alpha_sum, phi, phi_M, I_ch, I_ch_tot,
                           F, C_M, dt, splitting=True, neg=-1.0):
    """Membrane rhs of the m solved ions on the n_mem axis (every facet
    here IS membrane, so no masks; phi_M / I_ch are slot-ordered): b_p, b_m
    (m, nd, n_mem)."""
    m, nd = c_k.shape[0], c_k.shape[1]
    w = g["w_f"]
    alpha = (D[:, None, :] * (z * z)[:, None, None]) * c_k / alpha_sum[None]
    AU = alpha.reshape(m * nd, -1)
    Cfac = (C_M / (F * dt)) / z                                  # (m,)
    inv_Fz = (1.0 / (F * z))[:, None, None]
    nm = mem_t["cp"].shape[0]
    Rp_m, Rm_m = mem_t["Rp"], mem_t["Rm"]                # (nq, nd, nm)
    stackM = torch.cat([AU, phi], dim=0)                 # (m*nd+nd, nc)
    MPm = stackM[:, mem_t["cp"]]
    MMm = stackM[:, mem_t["cm"]]
    AUp = MPm[:m * nd].reshape(m, nd, nm)
    AUm = MMm[:m * nd].reshape(m, nd, nm)
    jphi_m = torch.einsum("qim,im->qm", Rp_m, MPm[m * nd:]) \
        + neg * torch.einsum("qim,im->qm", Rm_m, MMm[m * nd:])  # (nq, nm)
    a_p = torch.einsum("qim,kim->kqm", Rp_m, AUp)
    a_m = torch.einsum("qim,kim->kqm", Rm_m, AUm)
    C_p = a_p * Cfac[:, None, None]
    C_m = a_m * Cfac[:, None, None]
    phiM_f = phi_M[:nm][None, None, :]
    Itot_f = I_ch_tot[:nm]
    Ik_f = I_ch[:, :nm][:, None, :]                      # (m,1,nm)
    s_extra_p = (a_p * Itot_f[None, None, :] * inv_Fz) if splitting else 0.0
    s_extra_m = (a_m * Itot_f[None, None, :] * inv_Fz) if splitting else 0.0
    s_e = C_p * phiM_f + neg * (Ik_f * inv_Fz) + s_extra_p       # (m, nq, nm)
    s_i = C_m * phiM_f + neg * (Ik_f * inv_Fz) + s_extra_m
    jC = C_p + neg * C_m
    aC = 0.5 * (C_p + C_m)
    jphi_b = jphi_m[None]
    val_p = neg * s_e + (neg * jphi_b * jC * 0.5 + neg * (jphi_b * aC))
    val_m = s_i + (neg * jphi_b * jC * 0.5 + jphi_b * aC)
    area_m = g["f_area"][mem_t["fidx"]]
    b_p = area_m * torch.einsum("q,kqm,qim->kim", w, val_p, Rp_m)
    b_m = area_m * torch.einsum("q,kqm,qim->kim", w, val_m, Rm_m)
    return b_p.contiguous(), b_m.contiguous()


def knp_emit_cell_plain(g, mem_t, z, D, psi, drift, Mpp, Mpm, Mmp, Mmm, b_cell, b_p,
                        b_m, static_blocks=None, pair=False):
    """Per-cell emit of the KNP assembly: the drift cell block, the
    gathered upwind blocks (one stacked gather per cell-facet slot), the
    static operator added last -> blocks (m, K, nd, nd, nc); and the rhs
    (m, nd, nc) = b_cell + the membrane parts b_p, b_m (m, nd, n_mem) of
    each cell's facets.  ``pair``: (A_cell (m, nd, nd, nc), rhs) for the
    pair emit (ops.pairs), which adds the static part itself."""
    m, nd = b_cell.shape[0], b_cell.shape[1]
    nf1 = g["f_area"].shape[0]
    cf = g["cf_idx"]
    isp = g["cf_is_plus"]
    A_cell = ((z * psi)[:, None, None, None]
              * (g["vol"] * D)[:, None, None, :]
              * drift[None, :, None, :] * g["phibar"][None, None, :, None])

    nm = mem_t["cp"].shape[0]
    bpm = torch.zeros((m * 2 * nd, nf1), dtype=b_cell.dtype, device=b_cell.device)
    bpm[:, mem_t["fidx"]] = torch.cat([b_p, b_m], dim=1).reshape(m * 2 * nd, nm)
    rhs = b_cell
    for l in range(cf.shape[0]):
        got = bpm[:, cf[l]].reshape(m, 2, nd, -1)
        rhs = rhs + torch.where(isp[l][None, None, :], got[:, 0], got[:, 1])
    if pair:
        return A_cell.contiguous(), rhs.contiguous()

    Mstk = torch.stack([Mpp, Mmm, Mpm, Mmp], dim=1).reshape(m * 4 * nd * nd, nf1)
    diag = A_cell
    offs = []
    for l in range(cf.shape[0]):
        sel = isp[l][None, None, None, :]
        got = Mstk[:, cf[l]].reshape(m, 4, nd, nd, -1)
        diag = diag + torch.where(sel, got[:, 0], got[:, 1])
        offs.append(torch.where(sel, got[:, 2], got[:, 3]))
    blocks = torch.stack([diag] + offs, dim=1)       # (m, K, nd, nd, nc)
    if static_blocks is not None:
        blocks = blocks + static_blocks
    return blocks, rhs.contiguous()


# ---------------------------------------------------------------------------
# K11's membrane rhs and emit in one call: static tables made once, the
# step's buffers
# ---------------------------------------------------------------------------

_IDX_BITS = 30            # index bits of a packed word; bit 30 "membrane", bit 31 cf_is_plus


class _TablesC(ctypes.Structure):
    """The C struct KnpEmitTables of csrc/assemble_knp.cu (same order)."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("Rp", "Rm", "w_f", "vol", "phibar", "area",
                                               "slots", "cells", "mcell")] + [
        (k, ctypes.c_int) for k in ("nq", "nd", "nfac", "nc", "nf1", "nm", "ncm")]


class KnpEmitTables(NamedTuple):
    """The static tables of :func:`knp_membrane_emit`, on the geometry's
    device.  The words are unsigned 32-bit in the kernel (read back in
    int64: w & (2**32 - 1)): index in bits 0-29, bit 30 "membrane", bit 31
    cf_is_plus."""
    slots: torch.Tensor        # int32 (nfac, nc): the facet cf_idx[l, c] | membrane | isp
    cells: torch.Tensor        # int32 (1 + nfac, ncm): row 0 the cells with a membrane
                               # slot (ascending), row 1 + l: inv[cf_idx[l, c]] | membrane | isp
    mcell: torch.Tensor        # int32 (2, nm): the membrane facets' cells cp, cm
    area: torch.Tensor         # (nm,) f_area[fidx]
    dims: tuple                # nq, nd, nfac, nc, nf1, nm, ncm
    c_struct: Optional[_TablesC]   # on the card: the kernels' table of pointers
    sources: tuple             # the other tensors c_struct points to: Rp, Rm, w_f, vol,
                               # phibar (held here, so the pointers outlive no tensor)


def slot_words(g, inv=None):
    """The packed cell-facet slot words of a geometry, int32 (nfac, nc): the
    facet cf_idx[l, c] in bits 0-29, bit 30 "a membrane facet" (from the
    inverse membrane map ``inv`` (nf+1,), -1 off the membranes; 0 without
    it), bit 31 cf_is_plus -- one load in place of cf_idx and cf_is_plus.
    The one packing both emits read (K10's :func:`emi_emit_cell`, K11's
    :func:`knp_membrane_emit`, which reads the membrane bit); the solver
    builds it once, in :func:`knp_emit_tables`.  cf_idx and cf_is_plus are
    checked here (on the card: contiguous, int32 / bool, their shapes; the
    indices within the facets and 30 bits)."""
    cf, isp = g["cf_idx"], g["cf_is_plus"]
    nfac, nc = cf.shape
    nf1 = g["f_area"].shape[0]
    for key, t, dt in (("cf_idx", cf, torch.int32), ("cf_is_plus", isp, torch.bool)):
        if t.is_cuda:
            _cuda.check(key, t, dt, (nfac, nc))
        elif t.dtype != dt or tuple(t.shape) != (nfac, nc):
            raise ValueError(f"slot_words: {key} must be {dt} of shape {(nfac, nc)}")
    if nf1 > 2 ** _IDX_BITS:
        raise ValueError("slot_words: facet indices outside [0, 2**30)")
    if nc and not bool(((cf >= 0) & (cf < nf1)).all()):
        raise ValueError("slot_words: cf_idx outside the facets")
    mem = torch.zeros_like(isp) if inv is None else inv[cf.long()] >= 0
    return _pack(cf, mem, isp).contiguous()


def knp_emit_tables(g, mem_t) -> KnpEmitTables:
    """The membrane emit's static tables of a geometry and its membrane
    tables: the per-cell slot words (:func:`slot_words`, which the EMI emit
    reads too), the compact list of the cells with a membrane slot with
    their words, the membrane facets' cells and areas.  The sources are
    checked here, not per call (on the card: contiguous, their dtypes and
    shapes; the indices within 30 bits).  A caller that emits again and
    again builds them once (Solver._membrane_emit_tables) and passes them
    to :func:`knp_membrane_emit` and :func:`emi_emit_cell`."""
    f_area, cf, isp, inv = g["f_area"], g["cf_idx"], g["cf_is_plus"], mem_t["inv"]
    nq, nd, nm = mem_t["Rp"].shape
    nfac, nc = cf.shape
    nf1 = f_area.shape[0]
    fdt = f_area.dtype
    if f_area.is_cuda and (nd > MAX_ND or nfac > MAX_D + 1 or nq > MAX_NQ):
        raise NotImplementedError(
            f"knp_membrane_emit: CUDA kernel built for nd <= {MAX_ND}, {MAX_D + 1} cell "
            f"facets and nq <= {MAX_NQ}, got nd = {nd}, {nfac} facets, nq = {nq}")
    shapes = {"vol": (fdt, (nc,)), "phibar": (fdt, (nd,)), "w_f": (fdt, (nq,)),
              "inv": (torch.int32, (nf1,)), "fidx": (torch.int32, (nm,)),
              "cp": (torch.int32, (nm,)), "cm": (torch.int32, (nm,)),
              "Rp": (fdt, (nq, nd, nm)), "Rm": (fdt, (nq, nd, nm)), "f_area": (fdt, (nf1,))}
    for key, (dt, shape) in shapes.items():
        t = mem_t[key] if key in mem_t else g[key]
        if t.is_cuda:
            _cuda.check(key, t, dt, shape)
        elif t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"knp_emit_tables: {key} must be {dt} of shape {shape}")
    if nm + 1 > 2 ** _IDX_BITS:
        raise ValueError("knp_emit_tables: membrane indices outside [0, 2**30)")
    slots = slot_words(g, inv)
    mi = inv[cf.long()]                                  # (nfac, nc), -1 off the membranes
    mem = mi >= 0
    cells = mem.any(dim=0).nonzero().flatten().to(torch.int32)
    words = _pack(torch.where(mem, mi, 0)[:, cells], mem[:, cells], isp[:, cells])
    cells = torch.cat([cells[None], words]).contiguous()
    mcell = torch.stack([mem_t["cp"], mem_t["cm"]]).contiguous()
    area = f_area[mem_t["fidx"].long()].contiguous()
    dims = (nq, nd, nfac, nc, nf1, nm, cells.shape[1])
    sources = (mem_t["Rp"], mem_t["Rm"], g["w_f"], g["vol"], g["phibar"])
    c_struct = None
    if f_area.is_cuda:
        if fdt not in (torch.float32, torch.float64):
            raise TypeError(f"knp_emit_tables: float32/float64 tables, got {fdt}")
        c_struct = _TablesC(*(t.data_ptr() for t in sources + (area, slots, cells, mcell)),
                            *dims)
    return KnpEmitTables(slots, cells, mcell, area, dims, c_struct, sources)


class KnpEmitOut(NamedTuple):
    """The buffers of the step's KNP assembly: what
    :func:`knp_membrane_emit` writes, then what :func:`knp_cell` and
    :func:`alpha_sum` write."""
    blocks: torch.Tensor       # (m, K, nd, nd, nc); pair layout: the drift blocks (m, nd, nd, nc)
    rhs: torch.Tensor          # (m, nd, nc)
    b_p: torch.Tensor          # (m, nd, n_mem) the membrane rhs
    b_m: torch.Tensor
    gphi: torch.Tensor         # (d, nc)
    drift: torch.Tensor        # (nd, nc)
    b_cell: torch.Tensor       # (m, nd, nc)
    alpha: torch.Tensor        # (nd, nc) alpha_sum, which the membrane emit reads


def knp_emit_buffers(g, mem_t, m, dtype, device, pair=False) -> KnpEmitOut:
    """Output buffers of :func:`knp_membrane_emit`, :func:`knp_cell` and
    :func:`alpha_sum` for a caller that assembles the same operators again
    and again (the solver's step)."""
    nd, nc, nm = mem_t["Rp"].shape[1], g["cf_idx"].shape[1], mem_t["Rp"].shape[2]
    K, d = g["cf_idx"].shape[0] + 1, g["G"].shape[1]
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    return KnpEmitOut(new(m, nd, nd, nc) if pair else new(m, K, nd, nd, nc), new(m, nd, nc),
                      new(m, nd, nm), new(m, nd, nm), new(d, nc), new(nd, nc),
                      new(m, nd, nc), new(nd, nc))


def knp_membrane_emit_plain(g, mem_t, z, D, c_k, alpha_sum, phi, phi_M, I_ch, I_ch_tot, F,
                            C_M, dt, psi, drift, M, b_cell, static_blocks=None,
                            splitting=True, pair=False):
    """:func:`knp_membrane_rhs_plain`, then :func:`knp_emit_cell_plain` on
    its b_p, b_m -> (blocks, rhs, b_p, b_m).  ``M`` (Mpp, Mpm, Mmp, Mmm),
    unused on the pair layout (None there)."""
    b_p, b_m = knp_membrane_rhs_plain(g, mem_t, z, D, c_k, alpha_sum, phi, phi_M, I_ch,
                                      I_ch_tot, F, C_M, dt, splitting)
    blocks, rhs = knp_emit_cell_plain(g, mem_t, z, D, psi, drift, *(M or (None,) * 4),
                                      b_cell, b_p, b_m, static_blocks, pair)
    return blocks, rhs, b_p, b_m


def knp_membrane_emit(g, mem_t, z, D, c_k, alpha_sum, phi, phi_M, I_ch, I_ch_tot, F, C_M,
                      dt, psi, drift, M, b_cell, static_blocks=None, splitting=True,
                      pair=False, out=None, tables=None):
    """:func:`knp_membrane_emit_plain`, kernel K11 ``knp_membrane_emit`` on a
    CUDA tensor: the membrane rhs and the emit in one call of two launches
    (the membrane facets beside the emit rows, then the membrane cells' rhs
    rows), the emit equal to :func:`knp_emit_cell_plain` exactly and b_p,
    b_m within round-off of :func:`knp_membrane_rhs_plain`'s.  ``tables``:
    the static tables of :func:`knp_emit_tables` (checked when they were
    built); without them they are built here.  ``out``: buffers of
    :func:`knp_emit_buffers` to write and return (on the CPU the plain
    results are copied into them); without it new tensors."""
    if not drift.is_cuda:
        res = knp_membrane_emit_plain(g, mem_t, z, D, c_k, alpha_sum, phi, phi_M, I_ch,
                                      I_ch_tot, F, C_M, dt, psi, drift, M, b_cell,
                                      static_blocks, splitting, pair)
        if out is None:
            return res
        for dst, src in zip(out[:4], res):
            dst.copy_(src)
        return tuple(out[:4])
    tab = tables if tables is not None else knp_emit_tables(g, mem_t)
    _, nd, nfac, nc, nf1, nm, _ = tab.dims
    m, dt_ = z.shape[0], drift.dtype
    if tab.area.dtype != dt_:
        raise TypeError(f"knp_membrane_emit: tables in {tab.area.dtype}, inputs in {dt_}")
    blk = (m, nd, nd, nc) if pair else (m, nfac + 1, nd, nd, nc)
    if out is None:
        out = knp_emit_buffers(g, mem_t, m, dt_, drift.device, pair)
    ins = _inputs(dt_, z=(z, (m,)), D=(D, (m, nc)), c_k=(c_k, (m, nd, nc)),
                  alpha_sum=(alpha_sum, (nd, nc)), phi=(phi, (nd, nc)),
                  phi_M=(phi_M, (nm + 1,)), I_ch=(I_ch, (m, nm + 1)),
                  I_ch_tot=(I_ch_tot, (nm + 1,)), drift=(drift, (nd, nc)))
    # the facet blocks and the static operator: the cell layout's emit only
    Ms = [None] * 4 if pair else _inputs(
        dt_, **{k: (t, (m, nd, nd, nf1)) for k, t in zip(("Mpp", "Mpm", "Mmp", "Mmm"), M)})
    bc = _inputs(dt_, b_cell=(b_cell, (m, nd, nc)))
    st = [None] if pair or static_blocks is None else _inputs(
        dt_, static_blocks=(static_blocks, blk))
    outs = _inputs(dt_, out_b_p=(out.b_p, (m, nd, nm)), out_b_m=(out.b_m, (m, nd, nm)),
                   out_blocks=(out.blocks, blk), out_rhs=(out.rhs, (m, nd, nc)))
    _cuda.launch("knp_membrane_emit", "knp_membrane_emit", dt_, *ins, *Ms, *bc, *st, *outs,
                 ctypes.addressof(tab.c_struct), m, int(bool(splitting)), int(pair),
                 float(F), float(C_M / (F * dt)), float(psi))
    return tuple(out[:4])


def assemble_knp_all(
    g: Dict[str, Any],
    masks: Dict[str, Any],
    ions: Dict[str, Any],       # z (m,), D (m,nc), c_n (m,nd,nc), c_k (m,nd,nc)
    phys: Dict[str, Any],
    phi: torch.Tensor,          # (nd, nc)
    alpha_sum: torch.Tensor,    # (nd, nc)
    phi_M: torch.Tensor,        # (n_mem+1,)
    I_ch: torch.Tensor,         # (m, n_mem+1)
    I_ch_tot: torch.Tensor,     # (n_mem+1,)
    *,
    mem_t: Dict[str, Any],
    static_blocks: Optional[torch.Tensor] = None,   # (m, K, nd, nd, nc)
    splitting: bool = True,
    pm: Optional[Dict[str, Any]] = None,
    out=None,
    buffers=None,
    tables=None,
    cell_tables=None,
):
    """All solved ions' KNP operators + rhs in one pass with shared facet
    and membrane gathers, in three steps (kernel K11 on the card):
    :func:`knp_cell`, :func:`knp_facet`, :func:`knp_membrane_emit` (the
    membrane rhs and the emit in one call).  ``max(D*un, 0) ==
    D*max(un, 0)`` since D > 0, so the upwind switch is shared by the ions.
    ``mem_t``: membrane-presliced tables; the whole membrane rhs is computed
    on the n_mem facet axis.

    Returns (blocks (m,K,nd,nd,nc), rhs (m,nd,nc)); with pair maps ``pm``
    ((pdK, peK), rhs), and ``static_blocks`` must be in pair form too
    (ops.pairs.cell_bell_to_pair); ``out`` (pairs only): the pair emit's
    (pdK, peK) buffers (ops.pairs.emit_buffers), written and returned;
    ``buffers``: the membrane emit's and the cell part's
    (:func:`knp_emit_buffers`, made for this layout), written, the emit's
    blocks (the drift blocks on pairs) and rhs returned; ``tables``: its
    static tables (:func:`knp_emit_tables`), ``cell_tables``
    :func:`knp_cell`'s (:func:`cell_tables`), each built in the call
    without them."""
    _degree1(g)
    z, D = ions["z"], ions["D"]                      # (m,), (m, nc)
    c_n, c_k = ions["c_n"], ions["c_k"]              # (m, nd, nc)
    F, psi, C_M, dt = phys["F"], phys["psi"], phys["C_M"], phys["dt"]

    gphi, drift, b_cell = knp_cell(g, phi, c_n, dt, out=buffers, tables=cell_tables)
    M = knp_facet(g, masks, z, D, gphi, psi)
    pair = pm is not None
    blocks, rhs, _, _ = knp_membrane_emit(
        g, mem_t, z, D, c_k, alpha_sum, phi, phi_M, I_ch, I_ch_tot, F, C_M, dt, psi, drift,
        None if pair else M, b_cell, None if pair else static_blocks, splitting, pair,
        out=buffers, tables=tables)
    if pair:
        return gather_blocks_pair_multi(g, pm, blocks, *M, add=static_blocks, out=out), rhs
    return blocks, rhs


def assemble_knp_mms(
    g: Dict[str, Any],
    masks: Dict[str, Any],
    ions: Dict[str, Any],       # z (m,), D (m,nc), c_n (m,nd,nc), c_k (m,nd,nc), C_sub
    phys: Dict[str, Any],
    phi: torch.Tensor,          # (nd, nc)
    *,
    mem_t: Dict[str, Any],
    mms,
    t,
    static_blocks: torch.Tensor,  # (m, K, nd, nd, nc)
    sources: Optional[torch.Tensor] = None,   # (m, nd, nc) ion source rows, or None
    tables=None,
    cell_tables=None,
):
    """The m solved ions' KNP operators and rhs of an MMS problem (cell
    layout): the operator as :func:`assemble_knp_all` builds it (kernel K11
    on the card); the rhs the mass term (vol/dt) M0 c_n, the ion
    ``sources``, and per ion k (:func:`knp_mms_rhs`) the MMS membrane data
    with the constant couplings ``ions["C_sub"][k]`` = (C_e, C_i), the
    volume source and the exterior Neumann flux at time ``t``.

    The MMS membrane rhs replaces the alpha-based one, so the membrane emit
    (:func:`knp_membrane_emit`, one call with the operator's emit) runs on
    zero membrane data -- phi, phi_M and the channel currents zero, alpha's
    denominator one -- which makes its membrane part exactly zero; the MMS
    parts go in through the (linear) rhs gather afterwards.

    Returns (blocks (m,K,nd,nd,nc), rhs (m,nd,nc))."""
    _degree1(g)
    z, D = ions["z"], ions["D"]
    c_n, c_k = ions["c_n"], ions["c_k"]
    F, psi, C_M, dt = phys["F"], phys["psi"], phys["C_M"], phys["dt"]
    m, nd, nc = c_k.shape
    nm = mem_t["cp"].shape[0]
    new = lambda fill, *shape: torch.full(shape, fill, dtype=phi.dtype, device=phi.device)

    gphi, drift, b_cell = knp_cell(g, phi, c_n, dt, tables=cell_tables)
    if sources is not None:
        b_cell = (b_cell + sources).contiguous()
    M = knp_facet(g, masks, z, D, gphi, psi)
    blocks, rhs, _, _ = knp_membrane_emit(
        g, mem_t, z, D, c_k, new(1.0, nd, nc), new(0.0, nd, nc), new(0.0, nm + 1),
        new(0.0, m, nm + 1), new(0.0, nm + 1), F, C_M, dt, psi, drift, M, b_cell,
        static_blocks, False, tables=tables)
    rhs = torch.stack([knp_mms_rhs(g, masks, mms, k, t, phi, *ions["C_sub"][k], rhs[k])
                       for k in range(m)])
    return blocks, rhs


def ion_source_rows(g, f_sources, t):
    """int_ECS f_k v of the solved ions' sources ``f_sources`` (callables
    f(x, t) -> (nq, nc) at the cells-last quadrature points, or None) ->
    (m, nd, nc), or None when no ion has one."""
    if all(f is None for f in f_sources):
        return None
    ecs = (g["cell_tag"] == 0)[None, :]
    rows = []
    for f in f_sources:
        if f is None:
            rows.append(torch.zeros_like(g["G"][:, 0, :]))
        else:
            fq = f(g["cell_qp"], t)
            rows.append(g["vol"] * torch.einsum("q,qc,qi->ic", g["w_c"], fq * ecs,
                                                g["Phi_c"]))
    return torch.stack(rows).contiguous()


# ---------------------------------------------------------------------------
# K14: membrane traces and updates (the presliced n_mem-axis helpers)
# ---------------------------------------------------------------------------

def _mem_trace(g, mem, u, side: str):
    """Membrane-presliced facet trace -> (nq, n_mem)."""
    R = mem["Rp" if side == "p" else "Rm"]           # (nq, nd, n_mem)
    c = mem["cp" if side == "p" else "cm"]           # (n_mem,)
    return torch.einsum("qim,im->qm", R, u[:, c])


# output bits of the trace kernel (csrc/membrane_trace.cu), written in this
# order: the plus and minus facet averages, the jump, the Nernst potential
TRACE_PLUS, TRACE_MINUS, TRACE_JUMP, TRACE_NERNST = 1, 2, 4, 8
MAX_TRACE_FIELDS = 4      # fields of one trace launch


def _membrane_trace_cuda(g, mem, fields, coefs, mask):
    """Kernel K14 ``membrane_trace``: the quantities of ``mask`` (in bit
    order) of every field over n_mem -> (n_quantities, n_fields, n_mem);
    one launch for up to MAX_TRACE_FIELDS fields, the table columns read
    once for all of them."""
    nq, nd, nm = mem["Rp"].shape
    if nd > MAX_ND:
        raise NotImplementedError(
            f"membrane_trace: CUDA kernel built for nd <= {MAX_ND}, got nd = {nd}")
    u0 = fields[0]
    for u in fields:
        _cuda.check("u", u, u0.dtype, (nd, u0.shape[-1]))
    nf, nout = len(fields), bin(mask).count("1")
    out = torch.empty((nout, nf, nm), dtype=u0.dtype, device=u0.device)
    tables = (*_tables(mem, ("Rp", "Rm", "cp", "cm"), u0.dtype),
              *_tables(g, ("w_f",), u0.dtype))
    row = nm * out.element_size()                    # bytes of one field's output
    for f0 in range(0, nf if nm else 0, MAX_TRACE_FIELDS):
        part = fields[f0:f0 + MAX_TRACE_FIELDS]
        pad = MAX_TRACE_FIELDS - len(part)
        _cuda.launch("membrane_trace", "knp_membrane_trace", u0.dtype,
                     *[u.data_ptr() for u in part], *[None] * pad,
                     *[float(c) for c in coefs[f0:f0 + len(part)]], *[0.0] * pad,
                     len(part), *tables, out.data_ptr() + f0 * row, nf * nm, nq, nd,
                     u0.shape[-1], nm, mask)
    return out


def membrane_avg_m_plain(g, mem, u, side: str):
    """Facet-average membrane trace -> (n_mem,)."""
    return torch.einsum("q,qm->m", g["w_f"], _mem_trace(g, mem, u, side))


def membrane_avg_m(g, mem, u, side: str):
    """Facet-average membrane trace -> (n_mem,) (kernel K14 on a CUDA
    tensor)."""
    if not u.is_cuda:
        return membrane_avg_m_plain(g, mem, u, side)
    return _membrane_trace_cuda(g, mem, [u], [1.0],
                                TRACE_PLUS if side == "p" else TRACE_MINUS).view(-1)


def _nernst_plain(g, mem, c, coef):
    """coef * facet-avg ln(c_plus / c_minus)."""
    cp = _mem_trace(g, mem, c, "p")
    cm = _mem_trace(g, mem, c, "m")
    return coef * torch.einsum("q,qm->m", g["w_f"], torch.log(cp / cm))


def nernst_coef(z, F, R, T):
    """RT/(zF), the Nernst potential's factor, as nernst_potential_m forms it."""
    return R * T / (F * z)


def nernst_potential_m_plain(g, mem, c, z, F, R, T):
    """E = RT/(zF) * facet-avg ln(c_plus / c_minus)."""
    return _nernst_plain(g, mem, c, nernst_coef(z, F, R, T))


def nernst_potential_m(g, mem, c, z, F, R, T):
    """E = RT/(zF) * facet-avg ln(c_plus / c_minus) (kernel K14 on a CUDA
    tensor)."""
    if not c.is_cuda:
        return nernst_potential_m_plain(g, mem, c, z, F, R, T)
    return _membrane_trace_cuda(g, mem, [c], [nernst_coef(z, F, R, T)],
                                TRACE_NERNST).view(-1)


def jump_phi_M_m_plain(g, mem, phi):
    """phi_M = facet-avg JUMP(phi) = phi_i - phi_e."""
    j = _mem_trace(g, mem, phi, "m") - _mem_trace(g, mem, phi, "p")
    return torch.einsum("q,qm->m", g["w_f"], j)


def jump_phi_M_m(g, mem, phi):
    """phi_M = facet-avg JUMP(phi) = phi_i - phi_e (kernel K14 on a CUDA
    tensor)."""
    if not phi.is_cuda:
        return jump_phi_M_m_plain(g, mem, phi)
    return _membrane_trace_cuda(g, mem, [phi], [1.0], TRACE_JUMP).view(-1)


def membrane_traces_m_plain(g, mem, fields, coefs):
    """The plus and minus facet averages and the Nernst potentials
    coefs[f] * facet-avg ln(plus / minus) of every field (nd, nc), from the
    one-field plain functions -> (3, n_fields, n_mem)."""
    return torch.stack([
        torch.stack([membrane_avg_m_plain(g, mem, u, "p") for u in fields]),
        torch.stack([membrane_avg_m_plain(g, mem, u, "m") for u in fields]),
        torch.stack([_nernst_plain(g, mem, u, cf) for u, cf in zip(fields, coefs)])])


def membrane_traces_m(g, mem, fields, coefs):
    """The plus and minus facet averages and the Nernst potentials of every
    field -> (3, n_fields, n_mem): a step's ODE inputs in one launch of
    kernel K14 on CUDA tensors (for up to MAX_TRACE_FIELDS fields), each
    value bitwise the one-field entry points' (coefs from nernst_coef)."""
    if not fields[0].is_cuda:
        return membrane_traces_m_plain(g, mem, fields, coefs)
    return _membrane_trace_cuda(g, mem, fields, coefs,
                                TRACE_PLUS | TRACE_MINUS | TRACE_NERNST)


def eliminated_concentration_plain(c, z, rho, z_elim):
    """c_N = -(1/z_N)(sum_k z_k c_k + rho); exact nodal arithmetic since all
    fields are DG1.  c (n_ions-1, nd, nc), rho (nc,)."""
    acc = torch.einsum("k,kic->ic", z, c)
    return (-(acc + rho[None, :]) / z_elim).contiguous()


def _fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add, from torch's
    correctly rounded operations (Boldo and Melquiond, "Emulation of FMA
    and correctly rounded sums: proved algorithms using rounding to odd",
    IEEE Trans. Computers 57(4), 2008): Dekker's exact product a b = uh +
    ul (Veltkamp's split), the exact sum c + uh = th + tl, tl + ul rounded
    to odd, then th plus that rounded to nearest.  Tensors of one float
    dtype, far from overflow and underflow."""
    # Veltkamp's factor 2^ceil(p/2) + 1 (p = 24, 53 significand bits)
    split, ibits = {torch.float32: (4097.0, torch.int32),
                    torch.float64: (134217729.0, torch.int64)}[a.dtype]

    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi

    def two_sum(x, y):
        s = x + y
        yy = s - x
        return s, (x - (s - yy)) + (y - yy)

    uh = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    ul = al * bl - (((uh - ah * bh) - al * bh) - ah * bl)
    th, tl = two_sum(c, uh)
    v, e = two_sum(tl, ul)
    even = (v.view(ibits) & 1) == 0
    inf = torch.full_like(v, float("inf"))
    v = torch.where((e != 0) & even, torch.nextafter(v, torch.where(e > 0, inf, -inf)), v)
    return th + v


def eliminated_concentration_ordered_plain(c, z, rho, z_elim):
    """:func:`eliminated_concentration_plain` in the kernel's arithmetic: acc
    = fma(z_k, c_k, acc) from zero over k (the fused multiply-add that
    nvcc's default contraction made of the earlier kernel's acc += z_k c_k,
    which the kernel writes out), then -(acc + rho) / z_elim, the division
    by a tensor (a CUDA division by a host scalar multiplies by its
    reciprocal), so on the card the kernel equals it to the last bit."""
    acc = torch.zeros_like(c[0])
    for k in range(c.shape[0]):
        acc = _fma(z[k].expand_as(acc), c[k], acc)
    return torch.div(-(acc + rho[None, :]), torch.full_like(acc, z_elim))


def eliminated_concentration(c, z=None, rho=None, z_elim=None, tables=None):
    """c_N = -(1/z_N)(sum_k z_k c_k + rho) (kernel K14 ``eliminated`` on a
    CUDA tensor: one launch, a thread one node (or, in float32, two cells of
    a row), for nd in NODE_ND and 1 to CELL_MAX_IONS - 1 solved ions;
    NotImplementedError otherwise).  The public route checks c, z and rho
    each call and reads z to the host (z and z_elim come by value).
    ``tables``: :func:`cell_tables` of the solver's charges and ``rho``
    (checked when they were built): the step's route, on which z = the
    tables' z[:-1], z_elim = z[-1] and rho come from the tables (pass none
    of them) and only c is checked.  The result is a new tensor on every
    route: the caller's state holds it and the next step reads it, so a
    buffer owned by the step would alias a state the caller may still
    hold."""
    if tables is not None:
        if z is not None or rho is not None or z_elim is not None:
            raise ValueError("eliminated_concentration: with tables, z, rho and z_elim "
                             "come from the tables")
        if tables.rho is None:
            raise ValueError("eliminated_concentration: tables built without rho")
    if not c.is_cuda:
        if tables is not None:
            z, rho, z_elim = tables.z[:-1], tables.rho, float(tables.z[-1])
        return eliminated_concentration_plain(c, z, rho, z_elim)
    if tables is not None:
        nd, _, nc, n = tables.dims
        m, dt_ = n - 1, tables.dtype
    else:
        m, nd, nc = c.shape
        dt_ = c.dtype
    if not (1 <= m < CELL_MAX_IONS and nd in NODE_ND):
        raise NotImplementedError(
            f"eliminated_concentration: CUDA kernel built for nd in {NODE_ND} and 1 to "
            f"{CELL_MAX_IONS - 1} solved ions, got nd = {nd}, {m} ions")
    cp = _ptr("c", c, dt_, (m, nd, nc))
    out = c.new_empty((nd, nc))               # c's dtype and device, checked above
    if tables is None:
        _, rp = _inputs(dt_, z=(z, (m,)), rho=(rho, (nc,)))
        st = _cell_tables_c(dt_, (0, 0, 0, rp), (nd, nd - 1, nc), z.tolist() + [float(z_elim)])
        ptr = ctypes.addressof(st)
    else:
        ptr = tables.ptr
    _cuda.launch("eliminated_concentration", "knp_eliminated", dt_, ptr, cp, out.data_ptr())
    return out
