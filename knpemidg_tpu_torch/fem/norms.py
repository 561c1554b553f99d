"""Error norms for verification (copy of knpemidg_tpu/fem/norms.py on the
port's own basis and quadrature): host numpy, run once per solution."""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from . import basis as fe
from .quadrature import simplex_rule
from ..mesh.core import Mesh


def _cell_quad(mesh: Mesh, degree: int):
    d = mesh.dim
    lam, w = simplex_rule(d + 1, degree)
    x = mesh.vertices[mesh.cells]                # (nc, nd, d)
    qp = np.einsum("qi,cid->cqd", lam, x)
    detJ = np.abs(np.linalg.det(x[:, 1:] - x[:, :1]))
    vol = detJ / math.factorial(d)
    return qp, lam, w, vol


def l2_error(
    mesh: Mesh,
    u: np.ndarray,
    exact: Callable[[np.ndarray], np.ndarray],
    degree: int = 5,
    subdomain: Optional[int] = None,
    shift: float = 0.0,
):
    """|| u_h - exact - shift ||_L2 over a subdomain (or everywhere); ``u``
    (nc, nd) host coefficients."""
    qp, lam, w, vol = _cell_quad(mesh, degree)
    u = np.asarray(u, dtype=np.float64)
    k = 1 if u.shape[1] == mesh.dim + 1 else 2     # infer field degree
    uh = np.einsum("qa,ca->cq", fe.values(lam, k), u)
    ue = exact(qp)
    err2 = np.einsum("q,cq->c", w, (uh - ue - shift) ** 2) * vol
    if subdomain is not None:
        err2 = err2[mesh.cell_tags == subdomain]
    return float(np.sqrt(np.abs(err2.sum())))


def integral(mesh: Mesh, values: Callable[[np.ndarray], np.ndarray], degree: int = 5,
             subdomain: Optional[int] = None) -> float:
    """Integral of a callable (or DG1 coefficient array) over a subdomain."""
    qp, lam, w, vol = _cell_quad(mesh, degree)
    if callable(values):
        vq = values(qp)
    else:
        values = np.asarray(values, dtype=np.float64)
        k = 1 if values.shape[1] == mesh.dim + 1 else 2
        vq = np.einsum("qa,ca->cq", fe.values(lam, k), values)
    v = np.einsum("q,cq->c", w, vq) * vol
    if subdomain is not None:
        v = v[mesh.cell_tags == subdomain]
    return float(v.sum())
