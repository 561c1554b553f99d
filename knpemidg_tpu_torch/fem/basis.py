"""Lagrange simplex basis (P1/P2) in barycentric form.

Everything is expressed through the barycentric coordinates ``lam``
(lambda_0..lambda_d) and the constant barycentric gradients ``G``
(rows of the P1 gradient matrix): for any degree, the basis values are
polynomials in lam and the physical gradients are lam-dependent linear
combinations of the G rows -- so one (nq, nd, d+1) coefficient table turns
the P1 geometry tabulation into any-degree tabulation.

Replaces FFC's tabulated element tables for the ``DG_k`` spaces the
reference builds from ``degree_emi/degree_knp`` (solver.py:163-169)."""
from __future__ import annotations

import math

import numpy as np


def n_basis(d: int, degree: int) -> int:
    """dim P_degree(simplex^d) = binom(d + degree, degree)."""
    return math.comb(d + degree, degree)


def node_lambdas(d: int, degree: int) -> np.ndarray:
    """Barycentric coordinates of the Lagrange nodes, (nd, d+1).

    Degree 1: vertices.  Degree 2: vertices then edge midpoints in
    lexicographic (i<j) vertex-pair order."""
    eye = np.eye(d + 1)
    if degree == 1:
        return eye
    if degree == 2:
        mids = [0.5 * (eye[i] + eye[j])
                for i in range(d + 1) for j in range(i + 1, d + 1)]
        return np.vstack([eye, mids])
    raise NotImplementedError(f"degree {degree} not supported (1 or 2)")


def values(lam: np.ndarray, degree: int) -> np.ndarray:
    """Basis values at barycentric points: lam (..., d+1) -> (..., nd)."""
    lam = np.asarray(lam)
    if degree == 1:
        return lam
    if degree == 2:
        verts = lam * (2.0 * lam - 1.0)                    # (..., d+1)
        d1 = lam.shape[-1]
        edges = [4.0 * lam[..., i] * lam[..., j]
                 for i in range(d1) for j in range(i + 1, d1)]
        return np.concatenate([verts, np.stack(edges, axis=-1)], axis=-1)
    raise NotImplementedError(f"degree {degree} not supported (1 or 2)")


def grad_coeffs(lam: np.ndarray, degree: int) -> np.ndarray:
    """Gradient coefficient table A: lam (..., d+1) -> (..., nd, d+1) with

        grad phi_a (x) = sum_i A[..., a, i] * grad lambda_i

    where grad lambda_i are the constant P1 gradient rows (Geometry.G)."""
    lam = np.asarray(lam)
    d1 = lam.shape[-1]
    if degree == 1:
        return np.broadcast_to(np.eye(d1), lam.shape[:-1] + (d1, d1)).copy()
    if degree == 2:
        nd = n_basis(d1 - 1, 2)
        A = np.zeros(lam.shape[:-1] + (nd, d1))
        for i in range(d1):                               # vertex functions
            A[..., i, i] = 4.0 * lam[..., i] - 1.0
        a = d1
        for i in range(d1):                               # edge functions
            for j in range(i + 1, d1):
                A[..., a, i] = 4.0 * lam[..., j]
                A[..., a, j] = 4.0 * lam[..., i]
                a += 1
        return A
    raise NotImplementedError(f"degree {degree} not supported (1 or 2)")


def nodes_physical(vertices: np.ndarray, cells: np.ndarray,
                   degree: int) -> np.ndarray:
    """Physical coordinates of the Lagrange nodes per cell: (nc, nd, d)."""
    lam_n = node_lambdas(cells.shape[1] - 1, degree)      # (nd, d+1)
    return np.einsum("ni,cid->cnd", lam_n, vertices[cells])
