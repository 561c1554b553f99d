"""Typed configuration objects for the KNP-EMI solver.

The reference (adajel/KNP-EMI-DG) passes plain namedtuples and dicts around
(e.g. examples/idealized-geometries/run_2D.py:94-98, :117-142,
:185-192).  Here the same semantic fields live in frozen dataclasses so they
are hashable / usable as jit static arguments, while `Ion` remains a thin
record matching the reference's ion-dict protocol (keys ``name, z, D_sub,
c_init_sub, c_init_sub_type, f_source, bdry``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PhysicalParams:
    """Physical parameters (reference: `params` namedtuple, run_2D.py:94-98).

    Units are whatever the application chooses (SI in idealized-geometries,
    cm/ms/mV-ish in emix-simulations) -- the framework is unit agnostic,
    mirroring the reference.
    """

    dt: float                                   # global (PDE) time step
    F: float = 96485.0                          # Faraday constant
    R: float = 8.314                            # gas constant
    temperature: float = 300.0                  # temperature
    C_M: float = 0.02                           # membrane capacitance
    C_phi: Optional[float] = None               # coupling coeff, default C_M/dt
    n_steps_ODE: int = 25                       # ODE substeps per PDE step
    ode_scheme: str = "rk4"                     # 'rk4' | 'rush_larsen'
    phi_M_init: Any = 0.0                       # float | callable(x)->val | array
    phi_M_init_type: str = "constant"           # constant | expression | function
    rho_sub: Optional[Dict[int, Any]] = None    # immobile background charge per subdomain

    def __post_init__(self):
        if self.C_phi is None:
            self.C_phi = self.C_M / self.dt

    @property
    def psi(self) -> float:
        return self.F / (self.R * self.temperature)


@dataclasses.dataclass
class Ion:
    """One ion species (reference ion dict, run_2D.py:117-142).

    ``D_sub``/``c_init_sub`` map subdomain tag -> value, where a value is a
    float (``c_init_sub_type='constant'``), a callable of position
    (``'expression'``), or an array of per-cell nodal values (``'function'``).
    The *last* ion of the ion list is eliminated via electroneutrality
    (solver.py:819-838).
    """

    name: str
    z: float
    D_sub: Dict[int, float]
    c_init_sub: Dict[int, Any]
    c_init_sub_type: str = "constant"
    f_source: Any = 0.0                 # callable(x, t)->val or float (ECS source, dx(0))
    bdry: Any = None                    # exterior Neumann flux (MMS only)
    # --- MMS-only fields (tests/mms_space.py data) ---
    C_sub: Optional[Dict[int, float]] = None
    f1: Any = None                      # volume source subdomain 1 (ICS)
    f2: Any = None                      # volume source subdomain 0 (ECS)
    g_robin_1: Any = None               # per-wall robin data, ICS side
    g_robin_2: Any = None               # per-wall robin data, ECS side


def ion_from_dict(d: Dict[str, Any]) -> Ion:
    """Accept reference-style ion dicts verbatim."""
    known = {f.name for f in dataclasses.fields(Ion)}
    kw = {k: v for k, v in d.items() if k in known}
    return Ion(**kw)


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Linear solver configuration (reference `solver_params` namedtuple,
    run_2D.py:185-192; PETSc options solver.py:406-468, :665-721)."""

    direct_emi: bool = False
    direct_knp: bool = False
    resolution: int = 0
    rtol_emi: float = 1e-5
    rtol_knp: float = 1e-7
    atol_emi: float = 1e-40
    atol_knp: float = 2e-40
    threshold_emi: Optional[float] = None   # kept for API parity (AMG knob)
    threshold_knp: Optional[float] = None
    max_it_emi: int = 1000                  # ksp_max_it (solver.py:429, :687)
    max_it_knp: int = 1000
    gmres_restart: int = 20
    verbose: bool = False
    # raise when a Krylov solve hits max_it without converging (reference:
    # ksp_error_if_not_converged, solver.py:428)
    error_if_not_converged: bool = True
    # preconditioner: 'two_level' (BoomerAMG stand-in) or 'jacobi'
    precond: str = "two_level"
    # KNP-side preconditioner ('' -> same as precond); the parabolic KNP
    # system often prefers plain block-Jacobi (no coarse-apply cost)
    precond_knp: str = ""
    agg_size: int = 64                      # cells per coarse aggregate
    knp_solver: str = "gmres"               # 'gmres' | 'bicgstab' (batched)
    # 'cgs2' (full-basis CGS2) | 'cgs2c' (chunked CGS2: a while_loop over
    # 8-row basis chunks bounded at ceil((j+1)/8) reads only the populated
    # rows -- same projections, ~(j+1)/(m+1) of the HBM traffic) | 'cgs1'
    # (single pass; counts nearly double at rtol 1e-7 in f32, round 3).
    # 'cgs2c' is measured and BURIED (tools/exp_cgs2c_ab.py, EMIx 14-step
    # window): identical KNP counts (406 vs 407) but +3.9% wall -- the
    # full-basis einsum is dispatch/latency-bound, not bandwidth-bound, so
    # the chunk loop's overhead eats the traffic savings.
    gmres_orth: str = "cgs2"                # (KNP batched)
    # 'replay' (fori_loop over the j stored 2x2 Givens rotations per
    # Arnoldi step) | 'carry' (carry the accumulated rotation product Q,
    # apply as one (m+1)^2 GEMV).  'carry' is measured and BURIED
    # (tools/exp_cgs2c_ab.py): KNP counts +6 and +6.6% wall -- most of the
    # loss is EMI trajectory noise through the phi_M knife edge (ulp-level
    # KNP changes resample the EMI spike steps), the rest the Q update's
    # own dispatches; the replay fori_loop was never the bottleneck.
    gmres_rot: str = "replay"               # (KNP batched)
    # EMI deflation enrichment: per-compartment polynomial moments of this
    # order join the exact compartment-constant deflation (0 = off).  The
    # membrane surface harmonics they capture dominate the CG count during
    # AP upstrokes (200 -> 12 iters on the EMIx mesh at order 2)
    emi_moment_order: int = 2
    # compute the moment-deflation Galerkin in HOST float64
    # (twolevel.moment_galerkin_host on the moment fields) instead of device
    # f32 matvecs.  The round-3 "order 3/4 DOUBLES counts" burial was an
    # f32-Galerkin-noise artifact of the device path; the f64 Galerkin
    # lifts that ceiling, which matters at ~1M tets where the order-2
    # budget is exhausted (ROADMAP item 12).  Costs one device->host
    # blocks pull per pc build.
    emi_moment_host: bool = False
    # per-compartment override: ICS compartments (nonzero subdomain tag)
    # get THIS moment order when it exceeds emi_moment_order (0 = off).
    # The budget-exceeding membrane harmonics at ~1M tets live on the
    # membrane-rich ICS bodies; raising the order only there avoids
    # spending W rows (and per-iteration apply bandwidth) on the single
    # big ECS compartment whose modes the order-2 budget already covers.
    emi_moment_order_ics: int = 0
    # axial moment extension: compartments whose bounding-box aspect
    # exceeds ~4 (axons are ~300:1; the l=4 bundle ECS is ~70:1) get
    # Chebyshev polynomials T_j of the scaled DOMINANT-axis coordinate
    # appended for j = order+1 .. THIS value (0 = off).  Rationale: the
    # scaling-table blowup is driven by domain LENGTH at fixed h
    # (box_3d_axons(1,2) EMI window 73 -> (1,4) 343 at the same h) --
    # slow variation ALONG the axons outgrows the tensor order-2 budget,
    # and raising the full tensor order pays ~C(p+3,3) rows/compartment
    # for modes that are axial.  Axial-only rows cost (p - order) each.
    # Chebyshev (not raw monomials) keeps the high-degree Galerkin
    # well-conditioned; |loc_axis| <= 1 by the per-axis scaling.
    # MEASURED (tools/scaling_headroom.py --over emi_moment_host=1
    # emi_moment_axial=N, 10-step window, production tolerances):
    #   249k tets: base EMI 343 / 716 ms/step; axial6 153 / 499;
    #              axial12 130 / 466 (1.87 us/cell, vs 0.71 at 124k)
    #   995k tets: base EMI 1432 / 5456 ms/step; axial12 449 / 2735
    #              (2.75 us/cell vs 5.48) -- the single biggest dent in
    #              the mesh-size blowup (ROADMAP r5 item 2).  Stacking
    #              emi_ritz=64+host on top RESOURCE_EXHAUSTEDs at 995k
    #              (ritz_W 1.0 GB + mom_W 1.5 GB on a 16 GB chip).
    # Off by default: all recorded EMIx benchmarks predate the knob, and
    # the flagship mesh's compartments are not bundle-elongated.
    emi_moment_axial: int = 0
    # store the moment-deflation fields compartment-BLOCKED on device
    # (twolevel.block_moment_rows): every W row is supported on exactly
    # one compartment, yet the dense (nw, nd, nc) layout streams
    # nc-wide mostly-zero rows twice per EMI iteration -- at 995k tets
    # the axial-12 stack is ~1.5 GB of HBM read per apply direction and
    # is what RESOURCE_EXHAUSTEDs the emi_ritz=64 stack (ROADMAP r5
    # item 2b).  Blocked rows live as (n_g, rows, nd, L) over their
    # compartment's own cell list and the apply gathers/scatters at
    # static indices.  Exact same math (row permutation only).
    # Requires emi_moment_host (the fields must stay host-side through
    # the Galerkin); cell layout only.  Off by default: recorded
    # benchmarks predate the knob.
    emi_moment_blocked: bool = False
    # EMI Ritz deflation: harvest this many approximate small-eigenvalue
    # modes of the preconditioned operator at the INITIAL pc build
    # (device Lanczos + genuine-f64 host Galerkin; 0 = off, -1 = AUTO:
    # 24 on the cell layout, 0 on the pair layout).  The LAYOUT decides
    # whether deflation pays (tools/exp_ritz_host.py + the cell A/B,
    # EMIx 14-step window, after the coarse-equilibration underflow fix):
    #   cell:  ritz0 566 EMI iters / 196 ms/step  vs  ritz24 299 / 162
    #          (deflation kills the 110-160-iteration spike steps)
    #   pair:  ritz0 181 / 134.5  vs  ritz16 301 / ritz24 229 / ritz32
    #          253 (tools/exp_pair_ritz.py, round 5).  Round 4's pair
    #          harvest had a real bug -- it Lanczos'ed against the
    #          FULL-pair BJ while production runs pair_bj='halves' + live
    #          mask; fixing the mismatch improved n=24 from 254 to 229
    #          but deflation stays a LOSS at every budget: the pair-halves
    #          baseline has no spike cluster to deflate (max step 27 vs
    #          the cell layout's 110-160 spikes), so the extra additive
    #          term only perturbs the two-level balance and the
    #          trajectory, and its apply cost raises the wall
    #          (134.5 -> 141-163 ms/step).
    # n_ritz=16 is measured WORSE than off on cell (488) -- harvest
    # quality is erratic below ~24 fields (tools/exp_ritz_tune.py).
    # Harvesting again at a LATER state is measured harmful
    # (tools/exp_ritz_ab.py: +82% at step 3), so pc refreshes reuse the
    # t=0 harvest.
    emi_ritz: int = -1
    # Harvest the Ritz fields with a HOST float64 Lanczos
    # (solvers/twolevel.ritz_lanczos_W_host) instead of the device f32
    # one.  The f32 recursion is chaotic: ulp-level program changes
    # (e.g. one reassociated einsum) resample the harvest and move the
    # flagship first-step EMI count 94 <-> 227; the f64 recursion is
    # deterministic and cannot collapse onto the nullspace.  Costs one
    # ~320 MB device->host blocks pull at the initial pc build.
    emi_ritz_host: bool = False
    # KNP Ritz deflation (experimental, MEASURED AND BURIED): same recipe
    # on the batched KNP operators -- per-ion preconditioned-Krylov
    # harvest at the initial pc build, genuine-f64 host Galerkin,
    # additive correction in the batched two-level apply (0 = off).
    # Measured on the EMIx 14-step window (tools/exp_knp_ritz.py): n=8
    # -0.8%, n=16 +2.2% -- a t=0 harvest cannot flatten the drift growth
    # because the operator CHANGES through the window (the late-window
    # 43-47 counts are untouched).  n=32 shows -27.5% counts BUT max rel
    # dc 1.1e-2: the large deflation distorts the preconditioned-norm
    # convergence test (accuracy laundering), and the wall is a wash
    # anyway.  Kept as an option for future drift-aware refresh schemes.
    knp_ritz: int = 0
    # pair-layout block-Jacobi scope: 'halves' (default) inverts the two
    # per-cell blocks (the cell layout's smoother); 'full' inverts the
    # whole (2nd x 2nd) pair diagonal including the intra-pair coupling.
    # Measured on the EMIx window (tools/exp_pair_tune.py): the stronger
    # 'full' smoother UNBALANCES the additive two-level sum -- EMI 305 /
    # KNP 434 window iters vs 'halves' 264 / 410 (cell layout: 293 /
    # 369), walls 155.5 vs 148.0 ms/step.
    pair_bj: str = "halves"
    # diagonal shift on the EQUILIBRATED coarse matrix before its Cholesky
    # (solvers/twolevel.build_two_level).  Direct f64 spectral measurement
    # (tools/exp_coarse_spectrum.py) shows the only modes below 1e-5 at
    # any measured chunk count are the compartment constants (handled by
    # exact deflation); the smallest GENUINE coarse modes sit 2+ orders
    # above, so the default shift caps nothing the coarse treats.  Values
    # < 1e-5 risk an indefinite f32 Cholesky (measured at 995k: silent
    # 0-iteration EMI PCG) and engage the NaN-fallback ladder in
    # build_two_level.  Kept tunable as measured infrastructure.
    coarse_ridge: float = 1e-5
    # rebuild the frozen preconditioner every N steps (0 = freeze at t0).
    # The coarse/deflation Galerkin data drifts with the concentrations;
    # refresh bounds that drift on long runs (hundreds of steps).  NOTE the
    # EMI iteration spikes during an AP upstroke are intrinsic to those
    # steps' right-hand sides (measured: per-step-fresh pc still spikes),
    # so frequent refresh does not pay -- a rebuild costs ~1.6 s on the
    # EMIx mesh; every ~50 steps adds ~30 ms/step
    pc_refresh_every: int = 0
    # count-triggered refresh (the reference re-setups its AMG every step,
    # solver.py:727-742; here a refresh is only worth its ~1.6 s rebuild
    # when iteration counts have genuinely degraded): when > 0, the
    # active-scan loop also refreshes whenever the last step's total
    # Krylov work (EMI + summed KNP iters) exceeds this factor times the
    # best (minimum) step total seen since the previous refresh.
    # pc_refresh_every still applies as an independent cadence.
    # Measured on the EMIx AP window by tools/exp_adaptive_refresh.py
    # (see ROADMAP round-5 notes); round-3 already showed a per-step-FRESH
    # KNP pc leaves the drift-growth counts identical, so this is a
    # safety valve for long runs where the t0 pc eventually goes stale,
    # not a window-count lever.
    pc_refresh_factor: float = 0.0


@dataclasses.dataclass
class StimParams:
    """Membrane stimulus (reference `stim_params`, run_2D.py:152-154)."""

    stimulus: Optional[Dict[str, float]] = None
    stimulus_locator: Optional[Callable[[np.ndarray], bool]] = None
    g_syn_bar: float = 0.0
