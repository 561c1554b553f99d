"""Block-ELL sparse matvec and block-Jacobi, cells-last layout.

The DG operator has a fixed sparsity of K = d+2 blocks per cell row (self +
one neighbour per facet), stored dense as ``blocks (K, nd, nd, nc)`` with
the neighbour table ``nbr (K, nc)`` (slot 0 = self).

Kernel A (``csrc/bell_matvec.cu``) carries :func:`bell_matvec` and
:func:`bell_matvec_multi`; kernel B (``csrc/block_jacobi.cu``) carries
:func:`block_jacobi_inverse` and :func:`block_jacobi_apply`.  Each wrapper
runs its plain torch version (``*_plain``) for tensors on the CPU and
launches its kernel for CUDA tensors; there is no fallback between the two.
Kernel A is built for the 3D DG1 operator (K = 5 slots of nd = 4 blocks)
and the 2D one (K = 4 slots of nd = 3 blocks), kernel B for their blocks
and the 3D pair layout's 8 x 8 blocks; other block sizes or slot counts
raise on a CUDA tensor.  The 2D instantiations count their launches apart
(``_nd3``).  The inverse reads the diagonal blocks in place (a view whose
systems lie apart, such as slot 0 of an (m, K, nd, nd, nc) operator) and
takes the pair layout's 'halves' form (pair_bj = 'halves': the two
diagonal nd/2 x nd/2 sub-blocks inverted apart, the off-diagonal blocks of
the output zero and not written), into a caller's buffer where one is
given.  The apply takes the halves form too (the inverse's off-diagonal
blocks are not read), and its inverse once checked by
:func:`block_jacobi_operands`, so an apply checks only r.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _cuda

MATVEC_BUILT = {4: 5, 3: 4}   # kernel A: nd -> slots K (self + the facet neighbours
                              # of a tet, of a triangle)
BJ_ND = (3, 4, 8)   # kernel B: 2D and 3D cell blocks and 3D pair blocks (2nd = 8)


def _check_nd(name, nd, built):
    if nd not in built:
        raise NotImplementedError(
            f"{name}: CUDA kernel built for nd in {built}, got nd = {nd}")


def _bj_name(name, nd):
    """Launch-counter name of a kernel-A or kernel-B instantiation."""
    return name if nd == 4 else f"{name}_nd{nd}"


# ---------------------------------------------------------------------------
# kernel A: block-ELL matvec
# ---------------------------------------------------------------------------

def bell_matvec_plain(blocks, nbr, x):
    """y[i,c] = sum_{k,j} blocks[k,i,j,c] * x[j, nbr[k,c]];  x, y: (nd, nc).
    Slot 0 (the diagonal) first, then the K-1 gathered slots."""
    y = torch.einsum("ijc,jc->ic", blocks[0], x)
    xg = x[:, nbr[1:]]                                    # (nd, K-1, nc)
    return y + torch.einsum("kijc,jkc->ic", blocks[1:], xg)


def bell_matvec_multi_plain(blocks, nbr, x):
    """m operators sharing one neighbour table: blocks (m, K, nd, nd, nc),
    x (m, nd, nc) -> (m, nd, nc)."""
    m, nd, nc = x.shape
    y = torch.einsum("mijc,mjc->mic", blocks[:, 0], x)
    xg = x.reshape(m * nd, nc)[:, nbr[1:]]
    xg = xg.reshape(m, nd, nbr.shape[0] - 1, nc)
    return y + torch.einsum("mkijc,mjkc->mic", blocks[:, 1:], xg)


def _bell_cuda(blocks, nbr, x, m):
    nd, nc = x.shape[-2], x.shape[-1]
    K = nbr.shape[0]
    if x.dim() != (2 if m == 1 and blocks.dim() == 4 else 3):
        raise ValueError("bell_matvec: x must be (nd, nc) or (m, nd, nc)")
    _cuda.check("x", x)
    _cuda.check("blocks", blocks, x.dtype,
                ((m,) if blocks.dim() == 5 else ()) + (K, nd, nd, nc))
    _cuda.check("nbr", nbr, torch.int32, (K, nc))
    _check_nd("bell_matvec", nd, tuple(MATVEC_BUILT))
    if K != MATVEC_BUILT[nd]:
        raise NotImplementedError(
            f"bell_matvec: CUDA kernel built for K = {MATVEC_BUILT[nd]} slots at nd = {nd}, "
            f"got K = {K}")
    y = torch.empty_like(x)
    _cuda.launch(_bj_name("bell_matvec", nd), "knp_bell_matvec", x.dtype, blocks.data_ptr(),
                 nbr.data_ptr(), x.data_ptr(), y.data_ptr(), m, K, nd, nc)
    return y


def bell_matvec(blocks, nbr, x):
    """Single-system block-ELL matvec (kernel A on a CUDA tensor)."""
    if not x.is_cuda:
        return bell_matvec_plain(blocks, nbr, x)
    return _bell_cuda(blocks, nbr, x, 1)


def bell_matvec_multi(blocks, nbr, x):
    """Ion-batched block-ELL matvec (kernel A with m systems on a CUDA
    tensor): one launch for all m operators sharing ``nbr``."""
    if not x.is_cuda:
        return bell_matvec_multi_plain(blocks, nbr, x)
    return _bell_cuda(blocks, nbr, x, x.shape[0])


def bell_matvec_fan(blocks, nbr, x):
    """One operator applied to m vectors: blocks (K, nd, nd, nc),
    x (m, nd, nc) -> (m, nd, nc), one gather per slot.  Setup only (the
    moment-deflation Galerkin), so plain torch on every device."""
    m, nd, nc = x.shape
    y = torch.einsum("ijc,mjc->mic", blocks[0], x)
    xf = x.reshape(m * nd, nc)
    for k in range(1, nbr.shape[0]):
        xg = xf[:, nbr[k]].reshape(m, nd, nc)
        y = y + torch.einsum("ijc,mjc->mic", blocks[k], xg)
    return y


# ---------------------------------------------------------------------------
# kernel B: block-Jacobi inverse and apply
# ---------------------------------------------------------------------------

def block_jacobi_inverse_plain(diag_blocks, halves=False):
    """Unpivoted Gauss-Jordan inverse of the (nd x nd) diagonal blocks over
    the trailing cell axis: (..., nd, nd, nc) -> same.  The DG diagonal
    blocks are mass-regularised SPD, so the pivots stay positive.
    ``halves``: the two diagonal nd/2 x nd/2 sub-blocks inverted apart and
    placed in a zero nd x nd block (the pair layout's pair_bj = 'halves':
    the JAX package inverts the diagonal times the halves mask, whose
    eliminations across the halves multiply by exact zeros)."""
    nd = diag_blocks.shape[-3]
    if halves:
        h = nd // 2
        out = diag_blocks.new_zeros(diag_blocks.shape)
        for s in (slice(None, h), slice(h, None)):
            out[..., s, s, :] = block_jacobi_inverse_plain(diag_blocks[..., s, s, :])
        return out
    A = [[diag_blocks[..., i, j, :] for j in range(nd)] for i in range(nd)]
    one = torch.ones_like(diag_blocks[..., 0, 0, :])
    zero = torch.zeros_like(one)
    I = [[one if i == j else zero for j in range(nd)] for i in range(nd)]
    for k in range(nd):
        piv = 1.0 / A[k][k]
        A[k] = [a * piv for a in A[k]]
        I[k] = [a * piv for a in I[k]]
        for i in range(nd):
            if i == k:
                continue
            f = A[i][k]
            A[i] = [a - f * b for a, b in zip(A[i], A[k])]
            I[i] = [a - f * b for a, b in zip(I[i], I[k])]
    return torch.stack([torch.stack(row, dim=-2) for row in I], dim=-3)


def block_jacobi_apply_plain(Pinv, r, halves=False):
    """Per-cell GEMV: (..., nd, nd, nc) x (..., nd, nc) -> (..., nd, nc),
    contiguous like the kernel's output (the two-level apply adds into it
    in place).  ``halves``: the two diagonal nd/2 x nd/2 sub-blocks only
    (the pair layout's pair_bj = 'halves', whose inverse is zero off them)."""
    if not halves:
        return torch.einsum("...ijc,...jc->...ic", Pinv, r).contiguous()
    h = Pinv.shape[-2] // 2
    return torch.cat([torch.einsum("...ijc,...jc->...ic", Pinv[..., s, s, :], r[..., s, :])
                      for s in (slice(None, h), slice(h, None))], dim=-2)


def _batch(t, core_dims):
    """Number of systems m of a (nd, ..., nc) or (m, nd, ..., nc) tensor."""
    return t.shape[0] if t.dim() == core_dims + 1 else 1


def _check_halves_out(out, nd):
    """A halves inverse's buffer must be zero off its two diagonal
    sub-blocks, which the kernel never writes: checked once per tensor and
    in-place version (the kernel's writes do not bump it), the checked
    version kept on the tensor."""
    if getattr(out, "_zero_off_halves", None) == out._version:
        return
    h = nd // 2
    if bool(out[..., :h, h:, :].any()) or bool(out[..., h:, :h, :].any()):
        raise ValueError("block_jacobi_inverse: the halves form's buffer must be zero off "
                         "its two diagonal sub-blocks")
    out._zero_off_halves = out._version


def block_jacobi_inverse(diag_blocks, halves=False, out=None):
    """(nd, nd, nc) or (m, nd, nd, nc) -> inverse blocks (kernel B on a
    CUDA tensor).  ``diag_blocks`` is read in place: each system's
    (nd, nd, nc) must be cells-last and contiguous, the systems may lie
    any distance apart (slot 0 of an (m, K, nd, nd, nc) operator).
    ``halves``: the pair layout's halves form (2nd = 8 on the card; 6 or 8
    on the CPU), which reads only the two diagonal sub-blocks (the caller
    need not mask the diagonal) and writes only those; its output is zero
    elsewhere.  ``out``: the buffer to write (contiguous, the diagonal's
    shape; for the halves form zero off the two sub-blocks, checked once
    per tensor); without it a new tensor (zeroed for the halves form)."""
    nd, nc = diag_blocks.shape[-2], diag_blocks.shape[-1]
    if diag_blocks.dim() not in (3, 4) or diag_blocks.shape[-3] != nd:
        raise ValueError("block_jacobi_inverse: expected (m,) nd, nd, nc blocks")
    if halves and nd not in (6, 8):
        raise ValueError(f"block_jacobi_inverse: the halves form takes pair blocks "
                         f"(nd = 6 or 8), got nd = {nd}")
    if not diag_blocks.is_cuda:
        inv = block_jacobi_inverse_plain(diag_blocks, halves)
        return inv if out is None else out.copy_(inv)
    if diag_blocks.stride()[-3:] != (nd * nc, nc, 1):
        raise ValueError("block_jacobi_inverse: each system's blocks must be cells-last "
                         "and contiguous")
    _check_nd("block_jacobi_inverse", nd, (8,) if halves else BJ_ND)
    m = _batch(diag_blocks, 3)
    if out is None:
        out = (torch.zeros if halves else torch.empty)(
            diag_blocks.shape, dtype=diag_blocks.dtype, device=diag_blocks.device)
    else:
        _cuda.check("out", out, diag_blocks.dtype, diag_blocks.shape)
        if halves:
            _check_halves_out(out, nd)
    sys_stride = diag_blocks.stride(0) if diag_blocks.dim() == 4 else nd * nd * nc
    _cuda.launch(_bj_name("block_jacobi_inverse", nd), "knp_bj_inverse", diag_blocks.dtype,
                 diag_blocks.data_ptr(), out.data_ptr(), m, nd, nc, sys_stride, int(halves))
    return out


class BjOperands(NamedTuple):
    """A block-Jacobi inverse checked once for its applies (on the card: its
    dtype, shape and form), with the apply's output buffer where the caller
    asked for one."""
    Pinv: torch.Tensor
    halves: bool
    rshape: tuple              # the shape of r (and z): (m,) nd, nc
    name: str                  # the launch counter ("" on the CPU)
    buf: Optional[torch.Tensor]
    tail: tuple                # m, nd, nc, halves


def block_jacobi_operands(Pinv, halves=False, buffer=False) -> BjOperands:
    """Check the inverse blocks (nd, nd, nc) or (m, nd, nd, nc) once for
    :func:`block_jacobi_apply`.  ``halves``: apply the two diagonal
    sub-blocks only (pair blocks, nd = 6 or 8; kernel B takes nd = 8).
    ``buffer``: every apply writes into one output allocated here, for a
    caller that is done with the result before the next apply (the pair
    layout's solves: the masked two-level applies, whose prolong-add
    writes into it, and the block-Jacobi KNP apply, which multiplies it by
    the mask); without it each apply returns a new tensor."""
    if Pinv.dim() not in (3, 4) or Pinv.shape[-3] != Pinv.shape[-2]:
        raise ValueError("block_jacobi_apply: expected (m,) nd, nd, nc blocks")
    nd, nc = Pinv.shape[-2], Pinv.shape[-1]
    if halves and nd not in (6, 8):
        raise ValueError(f"block_jacobi_apply: the halves form takes pair blocks "
                         f"(nd = 6 or 8), got nd = {nd}")
    rshape = tuple(Pinv.shape[:-3]) + (nd, nc)
    buf = (torch.empty(rshape, dtype=Pinv.dtype, device=Pinv.device) if buffer else None)
    if not Pinv.is_cuda:
        return BjOperands(Pinv, bool(halves), rshape, "", buf, ())
    _cuda.check("Pinv", Pinv)
    _check_nd("block_jacobi_apply", nd, (8,) if halves else BJ_ND)
    return BjOperands(Pinv, bool(halves), rshape, _bj_name("block_jacobi_apply", nd), buf,
                      (_batch(Pinv, 3), nd, nc, int(bool(halves))))


def _check_vector(op, name, v):
    """r or out of an apply: the operands' shape (one system's also with a
    leading axis of 1), dtype and device, contiguous."""
    if ((v.shape != op.rshape and (v.dim() != 3 or v.shape[0] != 1 or v.shape[1:] != op.rshape))
            or v.dtype != op.Pinv.dtype or not v.is_cuda or not v.is_contiguous()):
        raise ValueError(f"block_jacobi_apply: expected a contiguous {op.Pinv.dtype} {name} "
                         f"of shape {op.rshape}, got {v.dtype} {tuple(v.shape)}")


def block_jacobi_apply(Pinv, r, out=None):
    """(nd, nd, nc) x (nd, nc), or batched over m systems, -> (.., nd, nc)
    (kernel B on a CUDA tensor).  ``Pinv``: the inverse blocks, checked
    here and applied in the full form, or their :func:`block_jacobi_operands`,
    which carry the form and the output buffer; with those an apply checks
    only r (and ``out``, the tensor to write in place of the operands'
    buffer or a new one).  One system's r and out may carry a leading axis
    of 1."""
    op = Pinv if isinstance(Pinv, BjOperands) else block_jacobi_operands(Pinv)
    dst = op.buf if out is None else out
    if not r.is_cuda:
        z = block_jacobi_apply_plain(op.Pinv, r, op.halves)
        return z if dst is None else dst.copy_(z)
    if not op.Pinv.is_cuda:
        raise ValueError("block_jacobi_apply: the operands were built from CPU tensors")
    _check_vector(op, "r", r)
    if out is not None and out is not op.buf:
        _check_vector(op, "out", out)
    z = torch.empty_like(r) if dst is None else dst
    _cuda.launch(op.name, "knp_bj_apply", r.dtype, op.Pinv.data_ptr(), r.data_ptr(),
                 z.data_ptr(), *op.tail)
    return z
