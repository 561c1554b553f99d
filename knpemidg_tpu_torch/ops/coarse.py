"""The coarse and deflation part of the two-level preconditioner apply,
kernels K6 (the EMI apply, one system) and K7 (the ion-batched KNP apply),
in three steps over m systems (``csrc/two_level.cu``):

  restrict      r (m, nd, nc) -> chunk sums rc (m, n_agg) and the
                projections proj (m, nf) on the compartment one-hots, the
                moment fields and the Ritz fields (nf of them in all);
  solve         the equilibrated dense coarse solve (one refinement sweep
                when the data has ``As``) and the small deflation solves:
                zc (m, n_agg), coef (m, nf);
  prolong_add   out += broadcast zc + coef^T [OH; W; Wr], in place.

Each wrapper runs its plain torch version (``*_plain``) for tensors on the
CPU and launches its kernel for CUDA tensors; there is no fallback between
the two.  The kernels take nd = 4 (cell layout) and 2nd = 8 (pair layout).
K6 and K7 count their launches apart (``_batched`` for K7).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import _cuda

COARSE_ND = (4, 8)
MAX_TILE = 1024       # a restrict block covers whole chunks of at most this many cells
MAX_SMALL = 2000      # rows of a deflation group solved in one block's shared memory


class Coarse(NamedTuple):
    """Kernel operands of frozen two-level data, with a leading system axis
    on the coarse matrices; the deflation groups (None when absent) are
    shared by the systems."""
    agg: int
    inv: torch.Tensor                  # (m, n_agg, n_agg)
    s: torch.Tensor                    # (m, n_agg)
    As: Optional[torch.Tensor]         # (m, n_agg, n_agg) or None
    OH: Optional[torch.Tensor]         # (n_comp, nc)
    comp: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]   # inv, s, As
    W: Optional[torch.Tensor]          # (nw, nd, nc)
    mom: Optional[Tuple[torch.Tensor, torch.Tensor]]                  # inv, s
    Wr: Optional[torch.Tensor]         # (nr, nd, nc)
    ritz: Optional[Tuple[torch.Tensor, torch.Tensor]]                 # inv, s
    batched: bool                      # K7 (counted apart from K6)

    @property
    def sizes(self):
        """(n_comp, nw, nr)."""
        return tuple(0 if t is None else t.shape[0] for t in (self.OH, self.W, self.Wr))


def operands(data, agg: int, batched: bool) -> Coarse:
    """Pack two-level ``data`` (build_two_level plus the deflation entries)
    for the kernels: contiguous, the coarse matrices with a system axis
    (``batched`` data already has one)."""
    def c(t):
        return None if t is None else t.contiguous()

    def sys_axis(t):
        return None if t is None else (t if batched else t[None]).contiguous()

    def group(*keys):
        return tuple(c(data[k]) for k in keys) if keys[0] in data else None

    return Coarse(agg=agg, inv=sys_axis(data["inv"]), s=sys_axis(data["s"]),
                  As=sys_axis(data.get("As")), OH=c(data.get("comp_onehot")),
                  comp=group("comp_inv", "comp_s", "comp_As"), W=c(data.get("mom_W")),
                  mom=group("mom_inv", "mom_s"), Wr=c(data.get("ritz_W")),
                  ritz=group("ritz_inv", "ritz_s"), batched=batched)


def _name(entry, co: Coarse):
    return f"two_level_{entry}" + ("_batched" if co.batched else "")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def restrict_plain(co: Coarse, r):
    """(rc (m, n_agg), proj (m, nf)) of r (m, nd, nc)."""
    m, _, nc = r.shape
    n_agg = co.s.shape[-1]
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


def solve_plain(co: Coarse, rc, proj):
    """(zc (m, n_agg), coef (m, nf)): the coarse values to prolong and the
    deflation coefficients."""
    rs = co.s * rc
    z = _mv(co.inv, rs)
    if co.As is not None:
        z = z + _mv(co.inv, rs - _mv(co.As, z))
    zc = co.s * z
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


def prolong_add_plain(co: Coarse, out, zc, coef):
    """out (m, nd, nc) += the prolonged coarse and deflation corrections, in
    place; returns out."""
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
    return out.add_(v)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_fields(co: Coarse, nd, nc, dtype):
    for name, t, shape in (("comp_onehot", co.OH, (nc,)), ("mom_W", co.W, (nd, nc)),
                           ("ritz_W", co.Wr, (nd, nc))):
        if t is not None:
            _cuda.check(name, t, dtype, (t.shape[0],) + shape)


def restrict(co: Coarse, r):
    """Chunk sums and field projections (the restrict kernel on a CUDA
    tensor): (rc (m, n_agg), proj (m, nf))."""
    if not r.is_cuda:
        return restrict_plain(co, r)
    if r.dim() != 3:
        raise ValueError("two_level restrict: expected r of shape (m, nd, nc)")
    m, nd, nc = r.shape
    _cuda.check("r", r)
    if nd not in COARSE_ND:
        raise NotImplementedError(
            f"two_level restrict: CUDA kernel built for nd in {COARSE_ND}, got nd = {nd}")
    if co.agg > MAX_TILE:
        raise NotImplementedError(
            f"two_level restrict: chunks above {MAX_TILE} cells are not supported")
    n_agg = co.s.shape[-1]
    if n_agg != -(-nc // co.agg):
        raise ValueError("two_level restrict: coarse size does not match the chunks")
    _check_fields(co, nd, nc, r.dtype)
    n_comp, nw, nr = co.sizes
    nf = n_comp + nw + nr
    cpt = max(1, 256 // co.agg)                  # chunks per restrict block
    nblk = -(-n_agg // cpt)
    rc = torch.empty((m, n_agg), dtype=r.dtype, device=r.device)
    proj = torch.empty((m, nf), dtype=r.dtype, device=r.device)
    partial = torch.empty((m, nf, nblk), dtype=r.dtype, device=r.device)
    _cuda.launch(_name("restrict", co), "knp_tl_restrict", r.dtype, r.data_ptr(),
                 _ptr(co.OH), _ptr(co.W), _ptr(co.Wr), rc.data_ptr(), proj.data_ptr(),
                 partial.data_ptr(), m, nd, nc, co.agg, n_agg, cpt, n_comp, nw, nr)
    return rc, proj


def solve(co: Coarse, rc, proj):
    """Dense coarse and small deflation solves (the solve kernels on a CUDA
    tensor): (zc (m, n_agg), coef (m, nf))."""
    if not rc.is_cuda:
        return solve_plain(co, rc, proj)
    m, n = rc.shape
    dt = rc.dtype
    _cuda.check("rc", rc)
    _cuda.check("proj", proj, dt, (m, sum(co.sizes)))
    _cuda.check("inv", co.inv, dt, (m, n, n))
    _cuda.check("s", co.s, dt, (m, n))
    if co.As is not None:
        _cuda.check("As", co.As, dt, (m, n, n))
    n_comp, nw, nr = co.sizes
    if max(n_comp, nw, nr) > MAX_SMALL:
        raise NotImplementedError(
            f"two_level solve: deflation groups above {MAX_SMALL} rows are not supported")
    groups = (("comp", co.comp, n_comp, 3), ("mom", co.mom, nw, 2), ("ritz", co.ritz, nr, 2))
    for name, grp, k, nt in groups:
        if (grp is None) != (k == 0):
            raise ValueError(f"two_level solve: {name} fields and Galerkin data disagree")
        if grp is not None:
            for i, t in enumerate(grp):
                _cuda.check(f"{name}[{i}]", t, dt, (k,) if t.dim() == 1 else (k, k))
    comp = co.comp or (None, None, None)
    mom = co.mom or (None, None)
    ritz = co.ritz or (None, None)
    zc = torch.empty_like(rc)
    coef = torch.empty_like(proj)
    refine = co.As is not None
    z1 = torch.empty_like(rc) if refine else None
    t = torch.empty_like(rc) if refine else None
    _cuda.launch(_name("solve", co), "knp_tl_solve", dt, co.inv.data_ptr(),
                 co.s.data_ptr(), _ptr(co.As), rc.data_ptr(), _ptr(z1), _ptr(t),
                 zc.data_ptr(), proj.data_ptr(), coef.data_ptr(),
                 *(_ptr(x) for x in comp), *(_ptr(x) for x in mom),
                 *(_ptr(x) for x in ritz), m, n, n_comp, nw, nr)
    return zc, coef


def prolong_add(co: Coarse, out, zc, coef):
    """out += the prolonged corrections, in place (the prolong kernel on a
    CUDA tensor); returns out."""
    if not out.is_cuda:
        return prolong_add_plain(co, out, zc, coef)
    if out.dim() != 3:
        raise ValueError("two_level prolong_add: expected out of shape (m, nd, nc)")
    m, nd, nc = out.shape
    n_agg = co.s.shape[-1]
    _cuda.check("out", out)
    _cuda.check("zc", zc, out.dtype, (m, n_agg))
    _cuda.check("coef", coef, out.dtype, (m, sum(co.sizes)))
    if nd not in COARSE_ND:
        raise NotImplementedError(
            f"two_level prolong_add: CUDA kernel built for nd in {COARSE_ND}, got nd = {nd}")
    if n_agg * co.agg < nc:
        raise ValueError("two_level prolong_add: the chunks do not cover the cells")
    _check_fields(co, nd, nc, out.dtype)
    n_comp, nw, nr = co.sizes
    _cuda.launch(_name("prolong", co), "knp_tl_prolong", out.dtype, out.data_ptr(),
                 zc.data_ptr(), coef.data_ptr(), _ptr(co.OH), _ptr(co.W), _ptr(co.Wr),
                 m, nd, nc, co.agg, n_agg, n_comp, nw, nr)
    return out


def coarse_add(co: Coarse, out, r):
    """out (m, nd, nc) += the coarse and deflation part of the two-level
    apply to r (m, nd, nc), in place: restrict, solve, prolong_add."""
    rc, proj = restrict(co, r)
    zc, coef = solve(co, rc, proj)
    return prolong_add(co, out, zc, coef)
