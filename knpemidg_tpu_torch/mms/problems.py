"""Manufactured solutions for verification (torch port of
knpemidg_tpu/mms/problems.py).

The source terms ``f = dc/dt + div(J)`` and all interface defect data are
derived symbolically with sympy once at setup and lambdified: the device
callables ``f(x, t)`` to torch (``x (..., d, n)`` cells-last, as the
assembly holds its quadrature points), the exact solutions and initial
data to numpy (``x (..., d)``, for the initial interpolation and the error
norms).

Geometry: unit square, inner box [0.25, 0.75]^2 = subdomain 1 (ICS), outer
= subdomain 0 (ECS); interface walls tagged 1 (left), 2 (bottom), 3 (right),
4 (top); the wall normals point from inner (1) to outer (0):
n1 = (-1,0), (0,-1), (1,0), (0,1).
"""
from __future__ import annotations

import dataclasses
import math
from numbers import Number
from typing import Callable, Dict, List, Tuple

import numpy as np
import sympy as sp
import torch


WALL_NORMALS = {1: (-1, 0), 2: (0, -1), 3: (1, 0), 4: (0, 1)}

# sympy's torch printer calls pow and sqrt on constants too (pi**2,
# sqrt(2)), which torch refuses: those stay Python arithmetic, as they are
# in the JAX package's lambdified code
_TORCH_CONSTANTS = {
    "pow": lambda a, b: a ** b if isinstance(a, Number) and isinstance(b, Number)
    else torch.pow(a, b),
    "sqrt": lambda a: math.sqrt(a) if isinstance(a, Number) else torch.sqrt(a)}


def _lambdify(expr, syms):
    """expr(x, y, t) -> f(x_tensor (..., d, n), t), broadcast to the
    points' shape (..., n) in their dtype and on their device: a constant
    expression comes back as a full tensor."""
    x, y, t = syms
    fn = sp.lambdify((x, y, t), expr, modules=[_TORCH_CONSTANTS, "torch"])

    def wrapped(xa, ta):
        ta = torch.as_tensor(ta, dtype=xa.dtype, device=xa.device)
        out = fn(xa[..., 0, :], xa[..., 1, :], ta)
        shape = xa.shape[:-2] + xa.shape[-1:]
        return torch.broadcast_to(torch.as_tensor(out, dtype=xa.dtype, device=xa.device),
                                  shape)

    return wrapped


def _lambdify_np(expr, syms):
    """Numpy variant for initial conditions and error norms."""
    x, y, t = syms
    fn = sp.lambdify((x, y, t), expr, modules="numpy")

    def wrapped(xa, ta=0.0):
        out = fn(xa[..., 0], xa[..., 1], ta)
        return np.broadcast_to(np.asarray(out, dtype=np.float64), xa[..., 0].shape)

    return wrapped


def _lambdify_vec(exprs, syms):
    """Vector-valued variant -> (..., d, n) with components on axis -2."""
    comps = [_lambdify(e, syms) for e in exprs]

    def wrapped(xa, ta):
        return torch.stack([f(xa, ta) for f in comps], dim=-2)

    return wrapped


@dataclasses.dataclass
class MMSProblem:
    """Everything the solver needs in MMS mode.  Subdomain key: 0=ECS, 1=ICS.
    Ion index k runs over the full ion list (last = eliminated)."""

    wall_tags: Tuple[int, ...]
    n_ions: int
    # volume sources, keyed by subdomain tag
    f_phi: Dict[int, Callable]
    f_c: List[Dict[int, Callable]]
    # interface data per wall
    g_phi: Dict[int, Callable]
    g_J_phi: Dict[int, Callable]
    g_robin_1: List[Dict[int, Callable]]   # ICS-side Robin data per ion
    g_robin_2: List[Dict[int, Callable]]   # ECS-side
    # exterior Neumann flux vectors per ion (ECS solution flux)
    neumann: List[Callable]
    # exact solutions (numpy callables of (x, t)) for error computation
    exact_phi: Dict[int, Callable]
    exact_c: List[Dict[int, Callable]]
    # initial conditions (numpy callables of x)
    init_c: List[Dict[int, Callable]]


def _build(params, conc_exprs, phi_exprs, syms):
    """Common derivation given exact concentration and potential
    expressions.

    conc_exprs: list over ions of {subdomain: sympy expr(x, y, t)}
    phi_exprs:  {subdomain: expr}
    """
    x, y, t = syms
    F, R, T = params["F"], params["R"], params["temperature"]
    psi = F / (R * T)
    C_phi = params["C_phi"]
    z = params["z"]                       # list over ions
    D = params["D"]                       # list over ions of {sub: value}
    C = params["C"]                       # list over ions of {sub: value}
    n_ions = len(conc_exprs)

    def grad(e):
        return (sp.diff(e, x), sp.diff(e, y))

    def div(v):
        return sp.diff(v[0], x) + sp.diff(v[1], y)

    # ion fluxes per subdomain: J = -D grad(c) - z D psi c grad(phi)
    J = []
    for k in range(n_ions):
        Jk = {}
        for s in (0, 1):
            gc = grad(conc_exprs[k][s])
            gp = grad(phi_exprs[s])
            Jk[s] = tuple(
                -D[k][s] * gc[i] - z[k] * D[k][s] * psi * conc_exprs[k][s] * gp[i]
                for i in range(2)
            )
        J.append(Jk)

    # volume sources
    f_c = [
        {s: sp.diff(conc_exprs[k][s], t) + div(J[k][s]) for s in (0, 1)}
        for k in range(n_ions)
    ]
    f_phi = {
        s: F * sum(z[k] * div(J[k][s]) for k in range(n_ions)) for s in (0, 1)
    }

    def dotn(v, n1):
        return v[0] * n1[0] + v[1] * n1[1]

    phi_jump = phi_exprs[1] - phi_exprs[0]          # phi_i - phi_e

    g_phi, g_J_phi = {}, {}
    g_robin_1 = [dict() for _ in range(n_ions)]
    g_robin_2 = [dict() for _ in range(n_ions)]
    for wall, n1 in WALL_NORMALS.items():
        IM = F * sum(z[k] * dotn(J[k][1], n1) for k in range(n_ions))
        g_phi[wall] = phi_jump - IM / C_phi
        g_J_phi[wall] = -F * sum(
            z[k] * (dotn(J[k][1], n1) - dotn(J[k][0], n1)) for k in range(n_ions)
        )
        for k in range(n_ions):
            g_robin_1[k][wall] = phi_jump - dotn(J[k][1], n1) / C[k][1]
            g_robin_2[k][wall] = phi_jump - dotn(J[k][0], n1) / C[k][0]

    lam = lambda e: _lambdify(e, syms)
    return MMSProblem(
        wall_tags=tuple(WALL_NORMALS),
        n_ions=n_ions,
        f_phi={s: lam(f_phi[s]) for s in (0, 1)},
        f_c=[{s: lam(f_c[k][s]) for s in (0, 1)} for k in range(n_ions)],
        g_phi={w: lam(e) for w, e in g_phi.items()},
        g_J_phi={w: lam(e) for w, e in g_J_phi.items()},
        g_robin_1=[{w: lam(e) for w, e in d.items()} for d in g_robin_1],
        g_robin_2=[{w: lam(e) for w, e in d.items()} for d in g_robin_2],
        neumann=[_lambdify_vec(J[k][0], syms) for k in range(n_ions)],
        exact_phi={s: _lambdify_np(phi_exprs[s], syms) for s in (0, 1)},
        exact_c=[
            {s: _lambdify_np(conc_exprs[k][s], syms) for s in (0, 1)}
            for k in range(n_ions)
        ],
        init_c=[
            {
                s: _lambdify_np(conc_exprs[k][s].subs(t, 0), syms)
                for s in (0, 1)
            }
            for k in range(n_ions)
        ],
    )


def setup_mms_space(params) -> MMSProblem:
    """Spatial-convergence MMS: time-independent trigonometric exact
    solutions, 3 ions (a, b, c), c eliminated."""
    x, y, t = sp.symbols("x y t")
    z = params["z"]
    pi = sp.pi
    k_a1 = sp.Rational(3, 10) + sp.Rational(2, 10) * sp.sin(2 * pi * x) * sp.sin(2 * pi * y)
    k_b1 = sp.Rational(9, 10) + sp.Rational(3, 10) * sp.cos(2 * pi * x) * sp.sin(2 * pi * y)
    k_a2 = sp.Rational(3, 10) + sp.Rational(2, 10) * sp.cos(2 * pi * x) * sp.cos(2 * pi * y)
    k_b2 = sp.Rational(8, 10) + sp.Rational(3, 10) * sp.sin(2 * pi * x) * sp.cos(2 * pi * y)
    k_c1 = -(z[0] * k_a1 + z[1] * k_b1) / z[2]
    k_c2 = -(z[0] * k_a2 + z[1] * k_b2) / z[2]
    phi_1 = sp.cos(2 * pi * x) * sp.cos(2 * pi * y)
    phi_2 = sp.sin(2 * pi * x) * sp.sin(2 * pi * y)
    conc = [{1: k_a1, 0: k_a2}, {1: k_b1, 0: k_b2}, {1: k_c1, 0: k_c2}]
    return _build(params, conc, {1: phi_1, 0: phi_2}, (x, y, t))


def setup_mms_time(params) -> MMSProblem:
    """Temporal-convergence MMS: linear-in-space, trigonometric-in-time
    exact solutions."""
    x, y, t = sp.symbols("x y t")
    z = params["z"]
    pi = sp.pi
    k_a1 = 1 + (x + y) + sp.Rational(2, 10) * sp.cos(2 * pi * t)
    k_b1 = 1 + (x + y) + sp.Rational(3, 10) * sp.cos(2 * pi * t)
    k_a2 = 1 + (x + y) + sp.Rational(5, 10) * sp.sin(2 * pi * t)
    k_b2 = 1 + (x + y) + sp.Rational(6, 10) * sp.sin(2 * pi * t)
    k_c1 = -(z[0] * k_a1 + z[1] * k_b1) / z[2]
    k_c2 = -(z[0] * k_a2 + z[1] * k_b2) / z[2]
    phi_1 = (1 + x + y) * (1 + t**2)
    phi_2 = (1 + x - y) * (1 + t**2)
    conc = [{1: k_a1, 0: k_a2}, {1: k_b1, 0: k_b2}, {1: k_c1, 0: k_c2}]
    return _build(params, conc, {1: phi_1, 0: phi_2}, (x, y, t))
