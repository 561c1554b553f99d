"""Quadrature rules on reference simplices.

Weights are normalized to sum to 1 (integral mean); kernels multiply by the
physical cell volume / facet area.  Points are returned in *barycentric*
coordinates, shape (nq, nverts), so a physical point is ``lam @ verts``.

These replace the runtime-generated FFC quadrature of the reference
(implicit in every `assemble` call, src/knpemidg/solver.py:452 etc.).
"""
from __future__ import annotations

import numpy as np

__all__ = ["simplex_rule", "gauss_legendre_01"]


def gauss_legendre_01(n: int):
    """Gauss-Legendre nodes/weights on [0,1]; weights sum to 1."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def _interval_rule(degree: int):
    n = max(1, (degree + 2) // 2)
    x, w = gauss_legendre_01(n)
    lam = np.stack([1.0 - x, x], axis=1)
    return lam, w


def _perm_group(vals, mults):
    """All distinct permutations of barycentric multiset."""
    from itertools import permutations

    base = []
    for v, m in zip(vals, mults):
        base += [v] * m
    return np.array(sorted(set(permutations(base))), dtype=np.float64)


def _triangle_rule(degree: int):
    if degree <= 1:
        return np.array([[1 / 3, 1 / 3, 1 / 3]]), np.array([1.0])
    if degree <= 2:
        pts = _perm_group((2 / 3, 1 / 6), (1, 2))
        return pts, np.full(3, 1 / 3)
    if degree <= 4:
        # Dunavant degree-4, 6 points
        g1 = _perm_group((0.108103018168070, 0.445948490915965), (1, 2))
        g2 = _perm_group((0.816847572980459, 0.091576213509771), (1, 2))
        pts = np.vstack([g1, g2])
        w = np.concatenate([np.full(3, 0.223381589678011), np.full(3, 0.109951743655322)])
        return pts, w
    # Dunavant degree-5, 7 points
    c = np.array([[1 / 3, 1 / 3, 1 / 3]])
    g1 = _perm_group((0.059715871789770, 0.470142064105115), (1, 2))
    g2 = _perm_group((0.797426985353087, 0.101286507323456), (1, 2))
    pts = np.vstack([c, g1, g2])
    w = np.concatenate(
        [[0.225], np.full(3, 0.132394152788506), np.full(3, 0.125939180544827)]
    )
    if degree > 5:
        # degree 6: Dunavant 12 points
        g1 = _perm_group((0.501426509658179, 0.249286745170910), (1, 2))
        g2 = _perm_group((0.873821971016996, 0.063089014491502), (1, 2))
        a, b = 0.053145049844817, 0.310352451033784
        c3 = 1.0 - a - b
        g3 = _perm_group((a, b, c3), (1, 1, 1))
        pts = np.vstack([g1, g2, g3])
        w = np.concatenate(
            [
                np.full(3, 0.116786275726379),
                np.full(3, 0.050844906370207),
                np.full(6, 0.082851075618374),
            ]
        )
    return pts, w


def _tet_rule(degree: int):
    if degree <= 1:
        return np.full((1, 4), 0.25), np.array([1.0])
    if degree <= 2:
        a, b = 0.585410196624969, 0.138196601125011
        pts = _perm_group((a, b), (1, 3))
        return pts, np.full(4, 0.25)
    # Keast degree-5 rule (15 points, positive weights), used for degree 3-5
    c = np.full((1, 4), 0.25)
    g1 = _perm_group((0.0, 1 / 3), (1, 3))
    a2, b2 = 8 / 11, 1 / 11
    g2 = _perm_group((a2, b2), (1, 3))
    a3, b3 = 0.4334498464263357, 0.0665501535736643
    g3 = _perm_group((a3, b3), (2, 2))
    pts = np.vstack([c, g1, g2, g3])
    w = np.concatenate(
        [
            [0.1817020685825351],
            np.full(4, 0.0361607142857143),
            np.full(4, 0.0698714945161738),
            np.full(6, 0.0656948493683187),
        ]
    )
    return pts, w / w.sum()


def simplex_rule(nverts: int, degree: int):
    """Rule on simplex with `nverts` vertices, exact to `degree` (weights sum 1).

    Returns (lam (nq, nverts), w (nq,)).
    """
    if nverts == 1:
        return np.ones((1, 1)), np.ones(1)
    if nverts == 2:
        return _interval_rule(degree)
    if nverts == 3:
        return _triangle_rule(degree)
    if nverts == 4:
        return _tet_rule(degree)
    raise ValueError(f"unsupported simplex with {nverts} vertices")
