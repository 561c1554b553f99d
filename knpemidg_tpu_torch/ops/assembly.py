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
layout instead (ops/pairs.py, kernel K12 on the card); everything else here
is plain torch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .pairs import (gather_blocks_pair, gather_blocks_pair_multi,
                    pair_block_diag_embed)


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


def _sip_blocks(g, kp, km, gnp, gnm, tau_over_h, sip_mask, pen_p=None, pen_m=None):
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
        return sign_v * (-0.5) * area * s[:, None, :] * gn_u[None, :, :]

    t1_pp = term1(+1.0, Rp, kp, gnp)
    t1_pm = term1(+1.0, Rp, km, gnm)
    t1_mp = term1(-1.0, Rm, kp, gnp)
    t1_mm = term1(-1.0, Rm, km, gnm)

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
    t3_pm = pen(Rp, +1, Rm, -1, pen_m)
    t3_mp = pen(Rm, -1, Rp, +1, pen_p)
    t3_mm = pen(Rm, -1, Rm, -1, pen_m)

    m = sip_mask[None, None, :]
    return (
        torch.where(m, t1_pp + t2_pp + t3_pp, 0.0),
        torch.where(m, t1_pm + t2_pm + t3_pm, 0.0),
        torch.where(m, t1_mp + t2_mp + t3_mp, 0.0),
        torch.where(m, t1_mm + t2_mm + t3_mm, 0.0),
    )


def _jump_jump_blocks(g, coef, mask):
    """coef * <[u],[v]> blocks on masked facets; coef (nf+1,), a broadcast
    over the static facet mass tensors E_vu (precompute_static)."""
    s = torch.where(mask, coef * g["f_area"], 0.0)[None, None, :]
    return (s * g["E_pp"], -s * g["E_pm"], -s * g["E_mp"], s * g["E_mm"])


def _test_integrals(g, vals_p, vals_m):
    """rhs side contributions: int_f vals_side * v_side.
    vals_* (nq, nf+1) -> b_p, b_m (nd, nf+1).  The caller encodes signs."""
    w = g["w_f"]
    b_p = g["f_area"] * _wsum_vec(w, vals_p, g["f_Rp"])
    b_m = g["f_area"] * _wsum_vec(w, vals_m, g["f_Rm"])
    return b_p, b_m


# ---------------------------------------------------------------------------
# EMI system (potential)
# ---------------------------------------------------------------------------

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
    pm: Optional[Dict[str, Any]] = None,
):
    """EMI block-ELL operator, rhs and block-Jacobi preconditioner diagonal
    (the regularised B operator).  ``mem_t``: membrane-presliced tables; the
    Robin membrane source is computed on the n_mem axis and scatter-added
    into the facet rhs.

    Returns (blocks (K,nd,nd,nc), rhs (nd,nc), P_diag (nd,nd,nc)); with
    pair maps ``pm``, ((pd, pe), rhs, P_diag_pair), where the pair
    diagonal of P_diag includes the intra-pair coupling."""
    _degree1(g)
    if mms is not None:
        raise NotImplementedError("MMS verification is not ported yet")
    z, D, c = ions["z"], ions["D"], ions["c"]
    F, psi, C_phi, tau = phys["F"], phys["psi"], phys["C_phi"], phys["tau_emi"]

    # kappa = F * psi * sum_k z_k^2 D_k c_k   (nodal, (nd, nc))
    kappa = F * psi * torch.einsum("k,kc,kic->ic", z * z, D, c)

    # --- cell term: int kappa grad(u).grad(v) ------------------------------
    kbar = torch.einsum("i,ic->c", g["phibar"], kappa)
    A_cell = (g["vol"] * kbar) * g["GG"]

    # --- facet traces of kappa ----------------------------------------------
    kp = facet_trace(g, kappa, "p")                          # (nq, nf+1)
    km = facet_trace(g, kappa, "m")

    sip = masks["f_sip"]
    mem = masks["f_mem"]
    Mpp, Mpm, Mmp, Mmm = _sip_blocks(g, kp, km, g["gnp"], g["gnm"],
                                     tau / g["f_havg"], sip)

    # --- membrane coupling: + C_phi <[u],[v]> on membrane facets ------------
    cphi = torch.full_like(g["f_area"], C_phi)
    Cpp, Cpm, Cmp, Cmm = _jump_jump_blocks(g, cphi, mem)
    Mpp, Mpm, Mmp, Mmm = Mpp + Cpp, Mpm + Cpm, Mmp + Cmp, Mmm + Cmm

    if pm is not None:
        # the SIP blocks sum transposed views; the emit kernel reads rows
        blocks = gather_blocks_pair(g, pm, A_cell, *(M.contiguous() for M in
                                                     (Mpp, Mpm, Mmp, Mmm)))
    else:
        blocks = gather_blocks(g, A_cell, Mpp, Mpm, Mmp, Mmm)

    # --- rhs: diffusive terms, all ions -------------------------------------
    ones = torch.ones_like(g["f_Rp"][:, 0, :])                # (nq, nf+1)
    gradc = torch.einsum("idc,kic->kdc", g["G"], c)           # (n_ions, d, nc)
    flux = torch.einsum("k,kc,kdc->dc", z, D, gradc)          # (d, nc)
    fp = torch.einsum("df,df->f", flux[:, g["f_cp"]], g["f_n"])
    fm = torch.einsum("df,df->f", flux[:, g["f_cm"]], g["f_n"])
    favg_q = (0.5 * F * (fp + fm) * sip)[None, :] * ones      # (nq, nf+1)
    b_cell = -F * g["vol"] * torch.einsum("dc,idc->ic", flux, g["G"])
    b_p, b_m = _test_integrals(g, favg_q, -favg_q)

    # Robin data: splitting -> phi_M; passive -> phi_M - I_ch/C_phi.
    # Term: + C_phi g JUMP(v) = g C_phi (v_i - v_e)
    gr = phi_M if splitting else phi_M - I_ch_tot / C_phi
    nm = mem_t["cp"].shape[0]
    fidx = mem_t["fidx"]
    src = C_phi * gr[:nm] * g["f_area"][fidx]                  # (nm,)
    w_f = g["w_f"]
    b_p = b_p.index_add(1, fidx, -src * torch.einsum("q,qim->im", w_f, mem_t["Rp"]))
    b_m = b_m.index_add(1, fidx, src * torch.einsum("q,qim->im", w_f, mem_t["Rm"]))

    rhs = gather_rhs(g, b_cell, b_p, b_m)

    # --- preconditioner: diag blocks of B = A + kappa/Lp^2 mass --------------
    reg = (g["vol"] * kbar / phys["Lp"] ** 2) * g["M0"][:, :, None]
    if pm is not None:
        pd, pe = blocks
        P_diag = pd + pair_block_diag_embed(pm, reg)
        return (pd, pe), rhs.contiguous(), P_diag.contiguous()
    P_diag = blocks[0] + reg
    return blocks, rhs.contiguous(), P_diag.contiguous()


# ---------------------------------------------------------------------------
# KNP system
# ---------------------------------------------------------------------------

def assemble_knp_static(g, masks, ion, phys):
    """Time-independent part of the KNP operator for one ion: mass/dt +
    stiffness + SIP + penalty (D is a static P0 field)."""
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
):
    """All solved ions' KNP operators + rhs in one pass with shared facet
    and membrane gathers.  ``max(D*un, 0) == D*max(un, 0)`` since D > 0, so
    the upwind switch is shared by the ions.  ``mem_t``: membrane-presliced
    tables; the whole membrane rhs is computed on the n_mem facet axis.

    Returns (blocks (m,K,nd,nd,nc), rhs (m,nd,nc)); with pair maps ``pm``
    ((pdK, peK), rhs), and ``static_blocks`` must be in pair form too
    (ops.pairs.cell_bell_to_pair)."""
    _degree1(g)
    z, D = ions["z"], ions["D"]                      # (m,), (m, nc)
    c_n, c_k = ions["c_n"], ions["c_k"]              # (m, nd, nc)
    F, psi, C_M, dt = phys["F"], phys["psi"], phys["C_M"], phys["dt"]
    m = z.shape[0]
    nd = c_k.shape[1]
    d = g["G"].shape[1]
    nf1 = g["f_area"].shape[0]
    sip = masks["f_sip"]
    w = g["w_f"]

    # --- shared cell drift --------------------------------------------------
    gphi = cell_grad(g, phi)                         # (d, nc)
    drift = torch.einsum("idc,dc->ic", g["G"], gphi)  # (nd, nc)
    A_cell = ((z * psi)[:, None, None, None]
              * (g["vol"] * D)[:, None, None, :]
              * drift[None, :, None, :] * g["phibar"][None, None, :, None])

    # --- one stacked gather per side: [gphi | D_all] ------------------------
    stackA = torch.cat([gphi, D], dim=0)             # (d+m, nc)
    SP = stackA[:, g["f_cp"]]
    SM = stackA[:, g["f_cm"]]
    u_p = torch.clamp(torch.einsum("df,df->f", SP[:d], g["f_n"]), min=0.0)
    u_m = torch.clamp(-torch.einsum("df,df->f", SM[:d], g["f_n"]), min=0.0)
    D_p, D_m = SP[d:], SM[d:]                        # (m, nf+1)

    # --- upwind blocks ------------------------------------------------------
    scale = (-psi) * z[:, None] * (g["f_area"] * sip)[None, :]   # (m, nf+1)
    sp_ = (scale * D_p * u_p[None, :])[:, None, None, :]
    sm_ = (scale * D_m * u_m[None, :])[:, None, None, :]
    Mpp = sp_ * g["E_pp"][None]
    Mpm = -sm_ * g["E_pm"][None]
    Mmp = -sp_ * g["E_mp"][None]
    Mmm = sm_ * g["E_mm"][None]

    # --- batched block gather (one stacked gather per cell-facet slot) ------
    cf = g["cf_idx"]
    isp = g["cf_is_plus"]
    if pm is not None:
        pdK, peK = gather_blocks_pair_multi(g, pm, A_cell.contiguous(), *(
            M.contiguous() for M in (Mpp, Mpm, Mmp, Mmm)))
        if static_blocks is not None:
            pdK = pdK + static_blocks[0]
            peK = peK + static_blocks[1]
        blocks = (pdK, peK)
    else:
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

    # --- rhs ----------------------------------------------------------------
    b_cell = (g["vol"] / dt) * torch.einsum("ij,kjc->kic", g["M0"], c_n)

    alpha = (D[:, None, :] * (z * z)[:, None, None]) * c_k / alpha_sum[None]
    AU = alpha.reshape(m * nd, -1)
    Cfac = (C_M / (F * dt)) / z                                  # (m,)
    inv_Fz = (1.0 / (F * z))[:, None, None]

    # membrane rhs on the n_mem axis: every facet here IS membrane, so no
    # masks; phi_M / I_ch are already slot-ordered (no gather)
    nm = mem_t["cp"].shape[0]
    Rp_m, Rm_m = mem_t["Rp"], mem_t["Rm"]                # (nq, nd, nm)
    fidx = mem_t["fidx"]
    stackM = torch.cat([AU, phi], dim=0)                 # (m*nd+nd, nc)
    MPm = stackM[:, mem_t["cp"]]
    MMm = stackM[:, mem_t["cm"]]
    AUp = MPm[:m * nd].reshape(m, nd, nm)
    AUm = MMm[:m * nd].reshape(m, nd, nm)
    jphi_m = torch.einsum("qim,im->qm", Rp_m, MPm[m * nd:]) \
        - torch.einsum("qim,im->qm", Rm_m, MMm[m * nd:])  # (nq, nm)
    a_p = torch.einsum("qim,kim->kqm", Rp_m, AUp)
    a_m = torch.einsum("qim,kim->kqm", Rm_m, AUm)
    C_p = a_p * Cfac[:, None, None]
    C_m = a_m * Cfac[:, None, None]
    phiM_f = phi_M[:nm][None, None, :]
    Itot_f = I_ch_tot[:nm]
    Ik_f = I_ch[:, :nm][:, None, :]                      # (m,1,nm)
    s_extra_p = (a_p * Itot_f[None, None, :] * inv_Fz) if splitting else 0.0
    s_extra_m = (a_m * Itot_f[None, None, :] * inv_Fz) if splitting else 0.0
    s_e = C_p * phiM_f - Ik_f * inv_Fz + s_extra_p       # (m, nq, nm)
    s_i = C_m * phiM_f - Ik_f * inv_Fz + s_extra_m
    jC = C_p - C_m
    aC = 0.5 * (C_p + C_m)
    jphi_b = jphi_m[None]
    val_p = -s_e + (-jphi_b * jC * 0.5 - jphi_b * aC)
    val_m = s_i + (-jphi_b * jC * 0.5 + jphi_b * aC)
    area_m = g["f_area"][fidx]
    b_p = area_m * torch.einsum("q,kqm,qim->kim", w, val_p, Rp_m)
    b_m = area_m * torch.einsum("q,kqm,qim->kim", w, val_m, Rm_m)
    bpm = torch.zeros((m * 2 * nd, nf1), dtype=b_cell.dtype, device=b_cell.device)
    bpm[:, fidx] = torch.cat([b_p, b_m], dim=1).reshape(m * 2 * nd, nm)

    # batched rhs gather
    rhs = b_cell
    for l in range(cf.shape[0]):
        got = bpm[:, cf[l]].reshape(m, 2, nd, -1)
        rhs = rhs + torch.where(isp[l][None, None, :], got[:, 0], got[:, 1])
    return blocks, rhs.contiguous()


# ---------------------------------------------------------------------------
# membrane traces and updates (the presliced n_mem-axis helpers)
# ---------------------------------------------------------------------------

def _mem_trace(g, mem, u, side: str):
    """Membrane-presliced facet trace -> (nq, n_mem)."""
    R = mem["Rp" if side == "p" else "Rm"]           # (nq, nd, n_mem)
    c = mem["cp" if side == "p" else "cm"]           # (n_mem,)
    return torch.einsum("qim,im->qm", R, u[:, c])


def membrane_avg_m(g, mem, u, side: str):
    """Facet-average membrane trace -> (n_mem,)."""
    return torch.einsum("q,qm->m", g["w_f"], _mem_trace(g, mem, u, side))


def nernst_potential_m(g, mem, c, z, F, R, T):
    """E = RT/(zF) * facet-avg ln(c_plus / c_minus)."""
    cp = _mem_trace(g, mem, c, "p")
    cm = _mem_trace(g, mem, c, "m")
    return R * T / (F * z) * torch.einsum("q,qm->m", g["w_f"], torch.log(cp / cm))


def jump_phi_M_m(g, mem, phi):
    """phi_M = facet-avg JUMP(phi) = phi_i - phi_e."""
    j = _mem_trace(g, mem, phi, "m") - _mem_trace(g, mem, phi, "p")
    return torch.einsum("q,qm->m", g["w_f"], j)


def eliminated_concentration(c, z, rho, z_elim):
    """c_N = -(1/z_N)(sum_k z_k c_k + rho); exact nodal arithmetic since all
    fields are DG1.  c (n_ions-1, nd, nc), rho (nc,)."""
    acc = torch.einsum("k,kic->ic", z, c)
    return -(acc + rho[None, :]) / z_elim
