"""Host sparse direct solves (torch port of knpemidg_tpu/solvers/direct.py),
the MMS verification path's stand-in for MUMPS: scipy SuperLU on the host.
The singular EMI system is solved through the bordered extension
``[[A, 1], [1^T, 0]]``, which enforces a zero-mean solution and projects an
inconsistent rhs -- the same solution, up to the constant, as MUMPS'
null-pivot least squares.

The operator and rhs come to the host (``.cpu()``) and the solution goes
back as numpy; the solver puts it on its device.  The iterative solves are
the path that runs on the card.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def bell_to_csr(blocks, nbr) -> sp.csr_matrix:
    """Block-ELL in the cells-last layout, blocks (K, nd, nd, nc) with the
    neighbour table nbr (K, nc) -> scipy CSR (N, N), cell-major dofs."""
    blocks = np.transpose(_host(blocks), (3, 0, 1, 2))      # (nc, K, nd, nd)
    nbr = _host(nbr).T
    nc, K, nd, _ = blocks.shape
    rows = np.repeat(np.arange(nc) * nd, K * nd * nd) + np.tile(
        np.repeat(np.arange(nd), nd), nc * K
    )
    cols = (np.repeat(nbr, nd * nd, axis=None) * nd).reshape(nc, K, nd, nd) + np.arange(nd)
    A = sp.coo_matrix(
        (np.asarray(blocks).ravel(), (rows, cols.ravel())), shape=(nc * nd, nc * nd)
    )
    A.sum_duplicates()
    return A.tocsr()


def solve_direct(blocks, nbr, b, nullspace_constant: bool = False) -> np.ndarray:
    """LU solve in float64; with ``nullspace_constant``, solve the bordered
    system.  ``b`` in the device layout (nd, nc); returns the same layout
    as a host float64 array."""
    blocks = _host(blocks).astype(np.float64)
    nbr = _host(nbr)
    b = _host(b).astype(np.float64)
    A = bell_to_csr(blocks, nbr)
    rhs = b.T.ravel()                       # cell-major dof order
    if nullspace_constant:
        n = A.shape[0]
        ones = np.ones((n, 1)) / np.sqrt(n)
        Ab = sp.bmat([[A, ones], [ones.T, None]], format="csc")
        sol = spla.spsolve(Ab, np.concatenate([rhs, [0.0]]))
        return sol[:-1].reshape(b.shape[::-1]).T
    return spla.spsolve(A.tocsc(), rhs).reshape(b.shape[::-1]).T
