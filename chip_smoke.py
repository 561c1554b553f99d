#!/usr/bin/env python3
"""Smoke run of knpemidg_tpu_torch on one NVIDIA GPU.

Drives the port's two paths -- StandardSolver setup, then
solve_system_active over the 10-step reference protocol (Tstop 1 ms,
dt 0.1 ms) -- on the 124,416-tet box_3d_axons(1, length_factor=2) mesh
(scaled to cm) with the EMIx physics: first on the cell layout, then on
the interleaved pair layout (enable_pair_layout, the JAX benchmark's
layout).  On the way it:

  1. requires a CUDA card and prints its name and power limit;
  2. builds the CUDA kernels from csrc/ (one nvcc per source, in
     parallel) and prints the build seconds;
  3. compares every kernel of each path with its plain torch version at
     that path's shapes, in float32 and float64, and times the kernel, the
     plain version and, where one PyTorch call computes the same function,
     that call; computes each kernel's bound from this run's inputs.  The
     assembly kernels (K10, K11, K14) are checked on each layout at a state
     perturbed from the initial one with a seeded generator; K13 as the
     solver's whole ODE step of both tags at its pushes, under each scheme,
     with its one-warp latency floor (the same launch on 32 points a tag);
  4. checks each layout on a small input against the reference iteration
     counts of the JAX package and the port's own CPU run;
  5. runs the protocol in float64 on each layout at emix.solver_params()
     (the JAX bench's SolverParams: AUTO Ritz deflation, 24 fields on the
     cell layout, none on the pair layout) with every launch counter reset
     first, and fails unless every solve converged, the fields are finite,
     every kernel of that path was launched, the K14 traces twice a step,
     K13 once a step, K9 once an Arnoldi step, and (cell layout) the
     preconditioner carries the Ritz fields; then reports the cell
     layout's emi_ritz=0 window beside it;
  6. runs the same protocol in float32 on each layout and reports its
     Krylov counts and whether each solve converged: on the cell layout
     with the device Ritz harvest (three runs, whose counts must repeat),
     the host float64 harvest (emi_ritz_host) and emi_ritz=0.  At the
     production tolerances the float32 EMI solve can stall at the
     iteration cap on this mesh (so can the JAX package's float32 program
     on the CPU), so this phase reports and does not assert convergence;
     every window's Krylov counts, float64 and float32, must equal the
     reference counts measured on the card (WINDOW_COUNTS, PERF.md);
  7. runs the cell layout's float64 protocol once more with
     ode_scheme="rush_larsen" (the neuron's points through the Rush-Larsen
     branch of K13's one launch a step) and asserts it as in 5;
  8. drives the gather probes P1/P2 through knpemidg_tpu_torch.probes.run
     (their own path) and holds them against the plain gathers exactly;
  9. drives the MMS verification path (2D DG1 on mms_square, passive,
     float64) through Solver(..., mms=...) and solve_system_passive: the
     2D instantiations of K1, K5 and K6 (nd = 3), and K8-K11 and K14 at
     their 2D shapes (K9 one system a solve), against their plain versions
     at the largest mesh's shapes (mms_square(7), 32,768 triangles); the
     space table (res 2-7, direct solves) and the time
     table (res 4, seven dt halvings, direct) against the JAX package's
     nightly gates and, at res 2-5 and every dt, its CPU errors
     (MMS_SPACE_ERRORS, MMS_TIME_ERRORS, rel 1e-6); and the iterative
     solves at res 3 and 5 (tests/test_mms_iterative.py's parameters, the
     launch counters reset first) against the direct ones, their Krylov
     counts printed beside the JAX package's CPU counts and asserted equal
     to the card's recorded ones (MMS_COUNTS), every kernel of the path
     launched.

Usage:  python3 chip_smoke.py      (exits non-zero on any failure)
The last line is {"ok": true, "device": {...}}; the line before it the
card's name and power limit, and the line before that the per-kernel JSON
summary.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# tolerances on max |kernel - plain| / scale, elementwise, where scale is
# the size rounding is measured against (see kernel_phase): |B| |x| for the
# matvecs and the block-Jacobi apply, |P^-1| |P| |P^-1| for the inverse,
# and each state's / parameter's own size for the ODE step (ode_scale).
# float32: sums in another order and fused multiply-adds change the last
# bits, and the 100-evaluation ODE step carries them through the stiff
# gating dynamics.  The relayout (K4) and the pair emit (K12) are moves,
# selects and the plain version's additions in its order: exact.
# The two-level kernels (K6, K7) are held to the same 1e-5 / 1e-12 against
# their componentwise scales: the sums of |terms| of each restricted,
# solved (through the refinement) or prolonged value (coarse_abs,
# solve_scale); K7's one-launch apply (two_level_coarse_batched) the same
# against the three plain steps, and bit for bit against its three
# launches.
TWO_LEVEL = [f"two_level_{e}{b}{p}" for b in ("", "_batched") for p in ("", "_pair", "_nd3")
             for e in ("restrict", "solve", "prolong")] + [
    f"two_level_coarse_batched{p}" for p in ("", "_pair")]
# The assembly kernels (K10, K11, K14): the cell, facet, membrane and trace
# kernels do arithmetic and are held to 1e-5 / 1e-12 of each value's sum of
# |terms| (the plain version with neg = +1 on absolute-valued inputs); the
# EMI emit adds in the plain version's order, without fused multiply-adds:
# exact.  knp_membrane_emit (K11's membrane rhs and emit in one call) is
# held to 1e-5 / 1e-12 on b_p, b_m and exactly (zero error scales) on the
# blocks and the rhs, that rhs against the plain emit of the launch's own
# b_p, b_m.
_ASM = "knpemidg_tpu/ops/assembly.py:"
# kernel -> (source under csrc/, the TPU-side function it replaces)
ASSEMBLY = {"emi_cell": ("assemble_emi.cu", _ASM + "289"),
            "emi_facet": ("assemble_emi.cu", _ASM + "197"),
            "emi_emit_cell": ("assemble_emi.cu", _ASM + "156"),
            "alpha_sum": ("assemble_knp.cu", "knpemidg_tpu/solver.py:750"),
            "knp_cell": ("assemble_knp.cu", _ASM + "678"),
            "knp_facet": ("assemble_knp.cu", _ASM + "678"),
            "knp_membrane_emit": ("assemble_knp.cu", _ASM + "678"),
            "membrane_trace": ("membrane_trace.cu", _ASM + "888"),
            "eliminated_concentration": ("membrane_trace.cu", _ASM + "941")}
ASSEMBLY_EXACT = ("emi_emit_cell",)
# The Krylov kernels (K8, K9) are held to 1e-5 / 1e-12 of each value's sum
# of |terms| (the Givens scalars: of the largest value of each output), the
# Rush-Larsen step as the RK4 one, the gather probes exactly.
KRYLOV = {"pcg_dot": ":101", "pcg_update": ":105", "pcg_dot2_direction": ":108",
          "gmres_start": ":319", "gmres_cgs_dot": ":305", "gmres_arnoldi": ":385",
          "gmres_solve_update": ":445"}
# the suffix of a layout's rows: the MMS path's 2D shapes are the "_nd3" rows
SUFFIX = {"cell": "", "pair": "_pair", "mms": "_nd3"}
KRYLOV_TOL = {torch.float32: {k + p: 1e-5 for k in KRYLOV for p in SUFFIX.values()},
              torch.float64: {k + p: 1e-12 for k in KRYLOV for p in SUFFIX.values()}}
TOL = {torch.float32: {"bell_matvec": 1e-5, "block_jacobi_apply": 1e-5,
                       "block_jacobi_inverse": 1e-5, "membrane_rk4": 1e-4,
                       "membrane_rl": 1e-4, "pgather": 0.0, "pgather2": 0.0,
                       **KRYLOV_TOL[torch.float32],
                       "pair_matvec": 1e-5, "block_jacobi_inverse_nd8": 1e-5,
                       "block_jacobi_apply_nd8": 1e-5, "to_pair": 0.0,
                       "bell_matvec_nd3": 1e-5, "block_jacobi_inverse_nd3": 1e-5,
                       "block_jacobi_apply_nd3": 1e-5,
                       "from_pair": 0.0, "gather_blocks_pair": 0.0,
                       **{k: 1e-5 for k in TWO_LEVEL},
                       **{k + p: 0.0 if k in ASSEMBLY_EXACT else 1e-5
                          for k in ASSEMBLY for p in SUFFIX.values()}},
       torch.float64: {"bell_matvec": 1e-12, "block_jacobi_apply": 1e-12,
                       "block_jacobi_inverse": 1e-12, "membrane_rk4": 1e-12,
                       "membrane_rl": 1e-12, "pgather": 0.0, "pgather2": 0.0,
                       **KRYLOV_TOL[torch.float64],
                       "pair_matvec": 1e-12, "block_jacobi_inverse_nd8": 1e-12,
                       "block_jacobi_apply_nd8": 1e-12, "to_pair": 0.0,
                       "bell_matvec_nd3": 1e-12, "block_jacobi_inverse_nd3": 1e-12,
                       "block_jacobi_apply_nd3": 1e-12,
                       "from_pair": 0.0, "gather_blocks_pair": 0.0,
                       **{k: 1e-12 for k in TWO_LEVEL},
                       **{k + p: 0.0 if k in ASSEMBLY_EXACT else 1e-12
                          for k in ASSEMBLY for p in SUFFIX.values()}}}
# dtype of the asserted protocol runs: float64 converges in a few Krylov
# iterations per step; float32 at the same tolerances can stall
MAIN_DTYPE = torch.float64
AGG = 64                  # emix.solver_params().agg_size: cells per coarse chunk
# the small-input references: box_3d_axons(0, 1) x 1e2, EMIx setup at
# emix.solver_params() (AUTO: Ritz-24 on cells, none on pairs), f64, two
# steps (counts of the JAX package, tests/test_torch_ritz.py and
# tests/test_torch_pair_slice.py)
REF = {"cell": ([5, 3], [[1, 1], [2, 1]]),
       "pair": ([3, 9], [[11, 8], [9, 5]])}

# the card's peaks (NVIDIA H100 SXM data sheet): HBM bandwidth, and the
# non-tensor-core float32 / float64 rates
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# operations of one membrane right-hand side evaluation per point, counted
# from csrc/membrane_rk4.cu (each exp, log, sqrt and division as one); a
# Rush-Larsen substep of HH is two right-hand sides and two half gate
# updates of 45 operations each (GlialKir runs RK4 under that scheme)
RK4_RHS_OPS = {"HodgkinHuxleyMV": 85, "GlialKir": 40}
RL_SUBSTEP_OPS = {"HodgkinHuxleyMV": 2 * 85 + 2 * 45, "GlialKir": 4 * 40}
# the Krylov counts of every 10-step window, EMI a step and KNP a step and
# ion (float64: 28 / 22 / 28 / 33 EMI iterations; float32: 2,742 x 3, 418,
# 2,631, 363), as measured on the card (PERF.md): every kernel
# redesign keeps the bits, so report_window fails a window that moves
WINDOW_COUNTS = {
    "cell64": ([5, 3, 3, 3, 3, 3, 1, 3, 3, 1], [[1, 1]] * 7 + [[2, 1], [1, 1], [1, 1]]),
    "cell64-r0": ([4, 4, 2, 2, 2, 1, 2, 2, 2, 1],
                  [[3, 1], [2, 2]] + [[1, 1]] * 4 + [[2, 2]] + [[1, 1]] * 3),
    "cell64-rl": ([5, 3, 3, 3, 3, 3, 1, 3, 3, 1], [[1, 1]] * 7 + [[2, 1], [1, 1], [1, 1]]),
    "pair64": ([9, 8, 2, 3, 2, 2, 2, 1, 2, 2],
               [[9, 4], [6, 2], [3, 2], [1, 1], [3, 2], [1, 1], [2, 2], [2, 1], [3, 1], [1, 1]]),
    "cell32-r24": ([110, 822, 133, 102, 63, 86, 1000, 102, 109, 215],
                   [[5, 5], [5, 5], [10, 8], [9, 6], [14, 9], [11, 6], [9, 6], [14, 9],
                    [15, 9], [16, 10]]),
    "cell32-host": ([83, 56, 33, 38, 4, 5, 47, 5, 89, 58],
                    [[5, 5], [10, 7], [11, 7], [10, 6], [12, 8], [9, 6], [14, 6], [10, 6],
                     [13, 7], [14, 6]]),
    "cell32-r0": ([25, 309, 167, 432, 301, 347, 181, 207, 343, 319],
                  [[5, 6], [10, 10], [13, 7], [12, 10], [14, 6], [11, 6], [15, 7], [11, 6],
                   [15, 10], [12, 6]]),
    "pair32": ([26, 20, 44, 6, 86, 6, 86, 44, 6, 39],
               [[21, 10], [12, 16], [16, 8], [17, 10], [15, 6], [11, 11], [14, 8], [16, 6],
                [17, 7], [14, 6]])}
KRYLOV_ROWS = 4           # populated basis rows at which K9 is checked and timed

# The MMS verification path: the JAX package's nightly protocol
# (tests/test_mms_space.py, tests/test_mms_time.py,
# tests/test_mms_iterative.py), float64 on the card
MMS_D_SUB = {"a": {1: 6.0, 0: 5.0}, "b": {1: 3.0, 0: 4.0}, "c": {1: 1.0, 0: 2.0}}
MMS_C_SUB = {"a": {1: 1.0, 0: 2.0}, "b": {1: 2.0, 0: 4.0}, "c": {1: 3.0, 0: 2.0}}
MMS_Z = {"a": 1.0, "b": -1.0, "c": 1.0}
MMS_DT_SPACE = 1e-10      # two steps: C_phi = 1 / dt = 1e10
MMS_TSTOP = 2.0e-2        # the time table's final time
MMS_SPACE_RES = (2, 3, 4, 5, 6, 7)
MMS_TIME_RES, MMS_TIME_HALVINGS = 4, 7
MMS_ITER_RES = (3, 5)
# the L2 errors of a, b, c and the mean-shifted phi of the JAX package's
# nightly runs on the CPU in float64 (tests/test_mms_space.py
# run_resolution at res 2-5, tests/test_mms_time.py run_dt at res 4 and
# dt = 1e-2 / 2^i): the card's must agree to rel 1e-6
MMS_SPACE_ERRORS = {
    2: {"a": 0.04169368245180822, "b": 0.06254052344451493, "c": 0.07516435688737634,
        "phi": 0.11561453796144025},
    3: {"a": 0.012010742810881865, "b": 0.01801611207693895, "c": 0.021652676757950184,
        "phi": 0.04605370240235351},
    4: {"a": 0.0031109307180738873, "b": 0.0046663929508508695, "c": 0.005608312172387485,
        "phi": 0.013703528328414268},
    5: {"a": 0.0007846445293795882, "b": 0.001176963244944192, "c": 0.0014145400020589068,
        "phi": 0.003618437519942686}}
MMS_TIME_ERRORS = {
    1: {"a": 0.003364086128941288, "b": 0.0034344013520871564, "c": 0.006730935338706914,
        "phi": 0.0008393023663013415},
    2: {"a": 0.0018298407391779197, "b": 0.0018520329039482298, "c": 0.0036480808741679136,
        "phi": 0.0005081698697028704},
    3: {"a": 0.0009515211277065133, "b": 0.0009586840562121026, "c": 0.0018931871098276636,
        "phi": 0.0002713403695774523},
    4: {"a": 0.0004841392377948614, "b": 0.0004866170468787458, "c": 0.0009621991418316762,
        "phi": 0.00013935686952712165},
    5: {"a": 0.0002440354460437987, "b": 0.0002449771919857959, "c": 0.00048472022199108156,
        "phi": 7.053356876454283e-05},
    6: {"a": 0.00012249461528960197, "b": 0.00012288802899625625, "c": 0.00024323276853664913,
        "phi": 3.547057941652979e-05},
    7: {"a": 6.136522781447516e-05, "b": 6.154207352309794e-05, "c": 0.00012183141092018841,
        "phi": 1.7784812808966076e-05}}
MMS_ERROR_TOL = 1e-6
# the iterative runs' Krylov counts (EMI a step, KNP a step and ion): the
# JAX package's on the CPU (tests/test_mms_iterative.py's run), printed
# beside the card's, and the card's as measured (PERF.md); the EMI PCG
# stagnates at rtol 1e-13 with C_phi = 1e10, so round-off moves its counts:
# a change to a kernel of this path that moves its output bits re-records
# MMS_COUNTS (the check that decides correctness is iterative against
# direct)
MMS_JAX_COUNTS = {3: ([3645, 1166], [[2, 2], [2, 2]]), 5: ([28236, 8528], [[3, 2], [3, 2]])}
MMS_COUNTS = {3: ([3719, 1535], [[2, 2], [2, 2]]), 5: ([28105, 8193], [[3, 2], [3, 2]])}

# kernel -> (source, the TPU-side function it replaces, the path it serves
# [, the launch counter when it is not the kernel's name])
KERNELS = {
    "bell_matvec": ("knpemidg_tpu_torch/csrc/bell_matvec.cu",
                    "knpemidg_tpu/ops/spmv.py:17", "cell"),
    "block_jacobi_inverse": ("knpemidg_tpu_torch/csrc/block_jacobi.cu",
                             "knpemidg_tpu/ops/spmv.py:102", "cell"),
    "block_jacobi_apply": ("knpemidg_tpu_torch/csrc/block_jacobi.cu",
                           "knpemidg_tpu/ops/spmv.py:131", "cell"),
    "membrane_rk4": ("knpemidg_tpu_torch/csrc/membrane_rk4.cu",
                     "knpemidg_tpu/membrane/engine.py:93", "cell"),
    "pair_matvec": ("knpemidg_tpu_torch/csrc/pair_matvec.cu",
                    "knpemidg_tpu/ops/pairs.py:344", "pair"),
    "to_pair": ("knpemidg_tpu_torch/csrc/pair_relayout.cu",
                "knpemidg_tpu/ops/pairs.py:273", "pair"),
    "from_pair": ("knpemidg_tpu_torch/csrc/pair_relayout.cu",
                  "knpemidg_tpu/ops/pairs.py:326", "pair"),
    "gather_blocks_pair": ("knpemidg_tpu_torch/csrc/pair_emit.cu",
                           "knpemidg_tpu/ops/pairs.py:384", "pair"),
    "block_jacobi_inverse_nd8": ("knpemidg_tpu_torch/csrc/block_jacobi.cu",
                                 "knpemidg_tpu/ops/spmv.py:102", "pair"),
    "block_jacobi_apply_nd8": ("knpemidg_tpu_torch/csrc/block_jacobi.cu",
                               "knpemidg_tpu/ops/spmv.py:131", "pair"),
    # K6 (the EMI apply) and K7 (the batched KNP apply) at each layout's
    # shapes; one launch counter per entry point serves both layouts.  The
    # main path's K7 is the one-launch apply (two_level_coarse_batched);
    # K7's three entry points stay rows of their own (the route of
    # operands with As), off the main path (OFF_PATH)
    **{f"two_level_{e}{b}{'_pair' if p == 'pair' else ''}": (
        "knpemidg_tpu_torch/csrc/two_level.cu",
        "knpemidg_tpu/solvers/twolevel.py:" + ("907" if b else "784"), p,
        f"two_level_{e}{b}")
       for b in ("", "_batched") for p in ("cell", "pair")
       for e in ("restrict", "solve", "prolong")},
    **{f"two_level_coarse_batched{'_pair' if p == 'pair' else ''}": (
        "knpemidg_tpu_torch/csrc/two_level.cu", "knpemidg_tpu/solvers/twolevel.py:907", p,
        "two_level_coarse_batched") for p in ("cell", "pair")},
    # K10, K11, K14 at each layout's cell axis, and at the MMS path's 2D
    # shapes (alpha_sum is not on that path); one counter serves all three
    **{k + SUFFIX[p]: ("knpemidg_tpu_torch/csrc/" + src, repl, p, k)
       for p in ("cell", "pair", "mms") for k, (src, repl) in ASSEMBLY.items()
       if not (p == "mms" and k == "alpha_sum")},
    # K8 (the EMI PCG) and K9 (the KNP GMRES: the ion batch on the 3D
    # layouts, one system a solve on the MMS path) at each layout's shapes
    **{k + SUFFIX[p]: (
        "knpemidg_tpu_torch/csrc/" + ("pcg.cu" if k.startswith("pcg") else "gmres.cu"),
        "knpemidg_tpu/solvers/krylov.py" + line, p, k)
       for p in ("cell", "pair", "mms") for k, line in KRYLOV.items()},
    # K13's Rush-Larsen scheme: its own window; the probes: their own run
    "membrane_rl": ("knpemidg_tpu_torch/csrc/membrane_rk4.cu",
                    "knpemidg_tpu/membrane/engine.py:129", "rl"),
    # the 2D instantiations (nd = 3: K1 at K = 4, K5, K6's restrict and
    # prolong-add; the solve is nd-free) at the MMS path's shapes
    "bell_matvec_nd3": ("knpemidg_tpu_torch/csrc/bell_matvec.cu",
                        "knpemidg_tpu/ops/spmv.py:17", "mms"),
    "block_jacobi_inverse_nd3": ("knpemidg_tpu_torch/csrc/block_jacobi.cu",
                                 "knpemidg_tpu/ops/spmv.py:102", "mms"),
    "block_jacobi_apply_nd3": ("knpemidg_tpu_torch/csrc/block_jacobi.cu",
                               "knpemidg_tpu/ops/spmv.py:131", "mms"),
    **{f"two_level_{e}_nd3": ("knpemidg_tpu_torch/csrc/two_level.cu",
                              "knpemidg_tpu/solvers/twolevel.py:784", "mms",
                              "two_level_solve" if e == "solve" else f"two_level_{e}_nd3")
       for e in ("restrict", "solve", "prolong")},
    "pgather": ("knpemidg_tpu_torch/csrc/gather_probe.cu", "tools/profile_shapes.py:74",
                "probe"),
    "pgather2": ("knpemidg_tpu_torch/csrc/gather_probe.cu", "tools/profile_shapes.py:103",
                 "probe"),
}


def counter(name):
    """The launch counter of a KERNELS entry."""
    return KERNELS[name][3] if len(KERNELS[name]) > 3 else name


# counters each path's run must launch (membrane_rk4 serves both layouts;
# the Rush-Larsen window is a cell window whose one K13 launch a step, the
# glial points' RK4 included, counts as membrane_rl).  K7's three entry
# points are checked and timed at the main path's shapes, but the main
# path's K7 operands (no fields, no As) take the one-launch apply: their
# window launches are 0
OFF_PATH = {f"two_level_{e}_batched" for e in ("restrict", "solve", "prolong")}
PATH_KERNELS = {"cell": sorted({counter(k) for k, v in KERNELS.items() if v[2] == "cell"}
                               - OFF_PATH),
                "pair": sorted(({counter(k) for k, v in KERNELS.items() if v[2] == "pair"}
                                | {"membrane_rk4"}) - OFF_PATH)}
PATH_KERNELS["rl"] = [k for k in PATH_KERNELS["cell"] if k != "membrane_rk4"] + ["membrane_rl"]
# K13 launches a step of each path's run: (membrane_rk4, membrane_rl)
ODE_LAUNCHES_PER_STEP = {"cell": (1, 0), "pair": (1, 0), "rl": (0, 1)}
PATH_KERNELS["probe"] = ["pgather", "pgather2"]
# the MMS path's iterative runs: the 2D rows, K8, K9 (one system a solve),
# K10, K11 without alpha_sum (the MMS membrane data replace alpha's), K14
PATH_KERNELS["mms"] = sorted({counter(k) for k, v in KERNELS.items() if v[2] == "mms"})


def report_window(S, dtype, layout, variant=""):
    """Print the per-step Krylov counts and walls of a finished
    solve_system_active run; return (median ms/step, median ODE ms)."""
    steps_ms = [1e3 * (a + b) for a, b in zip(S.ode_walls, S.stats.step_walls)]
    tag = f"{layout}{'64' if dtype == MAIN_DTYPE else '32'}{variant}"
    med, ode = statistics.median(steps_ms), 1e3 * statistics.median(S.ode_walls)
    print(f"{tag:7s} {dtype} emi iters {S.stats.emi_niters}")
    print(f"{tag:7s} {dtype} knp iters {S.stats.knp_niters}")
    print(f"{tag:7s} {dtype} ms/step {[round(v, 2) for v in steps_ms]}")
    print(f"{tag:7s} {dtype} median {med:.2f} ms/step (ODE median {ode:.2f} ms)")
    same = (S.stats.emi_niters, S.stats.knp_niters) == WINDOW_COUNTS[tag]
    print(f"{tag:7s} {dtype} Krylov counts equal the reference counts: {same}")
    if not same:
        raise AssertionError(f"the {tag} window's Krylov counts moved")
    return med, ode


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20):
    """Median milliseconds of fn() on the card (CUDA events, warmed up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, calls=20, replays=5):
    """Device milliseconds of one fn(): ``calls`` calls captured in one CUDA
    graph, its replay timed by CUDA events (median of ``replays``), so no
    host time lies between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def err(got, ref, scale):
    """(max |got - ref|, max |got - ref| / scale) over the elements."""
    d = (got.double() - ref.double()).abs()
    scale = scale.double().expand_as(d)
    rel = torch.where(scale > 0, d / torch.where(scale > 0, scale, 1.0),
                      torch.where(d > 0, torch.inf, 0.0))
    return float(d.max()), float(rel.max())


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def exact(ref):
    """Error scales of a comparison that must be exact."""
    return [torch.ones_like(r) for r in ref]


def compare(name, dtype, kernel_fn, plain_fn, scale_fn, results, inputs=(),
            flops=0.0, library_fn=None, record=True, timed=None, extra_bytes=0,
            whole_bytes=None, out_bytes=None, graph=False):
    """Check one kernel against its plain version; when ``record``, time
    the kernel, the plain version and the library call per dtype and store
    them with the bound (``inputs`` read once plus ``extra_bytes`` of
    inputs the work reads in part, the outputs written once, ``flops``
    operations).  kernel_fn/plain_fn return a list of tensors, scale_fn
    maps the plain outputs to the error scales (see TOL).  ``timed`` =
    (kernel, plain) functions to time instead of the checked ones (an
    in-place kernel is checked on a copy, timed without one).
    ``whole_bytes``: the input bytes counting every input whole, whose
    bound is printed beside the work's (with every output whole).
    ``out_bytes``: the bytes the work writes where it writes part of its
    outputs (K12: the owner halves of pe), else every output whole.
    ``graph``: also the kernel's device microseconds a call, 20 calls
    replayed as one CUDA graph (graph_ms: no host time between them).
    Returns the bound in ms when recorded."""
    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    errs = [err(a, b, sc) for a, b, sc in zip(got, ref, scale_fn(ref))]
    abs_e, rel_e = max(e[0] for e in errs), max(e[1] for e in errs)
    ok = bool(np.isfinite(rel_e)) and rel_e <= TOL[dtype][name]
    label = name if record else f"{name} (check)"
    print(f"compare {label:30s} {str(dtype):14s} max_abs_err {abs_e:.3e} "
          f"rel {rel_e:.3e} (tol {TOL[dtype][name]:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version in {dtype}")
    if not record:
        return
    entry = results.setdefault(name, {}).setdefault(dtype, {})
    entry["max_abs_err"] = abs_e
    k_fn, p_fn = timed or (kernel_fn, plain_fn)
    entry["ms"] = cuda_ms(k_fn)
    entry["plain_ms"] = cuda_ms(p_fn)
    entry["library_ms"] = cuda_ms(library_fn) if library_fn is not None else None
    entry["device_us"] = 1e3 * graph_ms(k_fn) if graph else None
    wrote = nbytes(got) if out_bytes is None else out_bytes
    byte_ms = 1e3 * (nbytes(inputs) + extra_bytes + wrote) / PEAK_BYTES_S
    op_ms = 1e3 * flops / PEAK_FLOPS[dtype]
    entry["bound_ms"] = max(byte_ms, op_ms)
    entry["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    lib = ("" if entry["library_ms"] is None
           else f"  library {entry['library_ms']:.4f} ms")
    lib += "" if entry["device_us"] is None else f"  graph replay {entry['device_us']:.2f} us"
    print(f"time    {name:30s} {str(dtype):14s} kernel {entry['ms']:.4f} ms  "
          f"plain {entry['plain_ms']:.4f} ms{lib}  bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']})")
    if whole_bytes is not None:
        print(f"bound   {name:30s} {str(dtype):14s} {byte_ms:.4f} ms the work's bytes, "
              f"{1e3 * (whole_bytes + nbytes(got)) / PEAK_BYTES_S:.4f} ms counting every "
              f"input whole")
    return entry["bound_ms"]


def inv_scale(P, inv):
    """Componentwise bound of a block inverse: |P^-1| |P| |P^-1|."""
    return torch.einsum("...ikc,...klc,...ljc->...ijc", inv.abs(), P.abs(), inv.abs())


def bj_inv_flops(P):
    nd = P.shape[-2]
    return 2.0 * nd ** 3 * P.numel() / (nd * nd)


def bj_apply_flops(P):
    return 2.0 * P.numel()


def lib_inv(P):
    """torch.linalg.inv on the batched blocks (cells-last -> batch-first)."""
    return torch.linalg.inv(torch.movedim(P, -1, -3))


def lib_apply(Pinv, r):
    """One batched torch.matmul for the block-Jacobi apply."""
    return torch.matmul(torch.movedim(Pinv, -1, -3),
                        torch.movedim(r, -1, -2)[..., None])


def bsr_matrix(rows, cols, vals, n_rows, n_cols):
    """torch.sparse_bsr_tensor of the square blocks vals (nnz, b, b) at the
    block positions (rows, cols), duplicates summed: a library call's
    operand, built once outside its timing."""
    import warnings

    b = vals.shape[-1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)     # "beta state", invariant checks
        coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]), vals,
                                      (n_rows, n_cols, b, b)).coalesce()
        r, c = coo.indices()
        crow = torch.zeros(n_rows + 1, dtype=torch.int32, device=vals.device)
        crow[1:] = torch.cumsum(torch.bincount(r, minlength=n_rows), 0)
        return torch.sparse_bsr_tensor(crow, c.int(), coo.values().contiguous(),
                                       (n_rows * b, n_cols * b), check_invariants=False)


def bell_bsr(B, nbr):
    """One cell-layout system (B (K, nd, nd, nc), nbr (K, nc)) as a BSR
    matrix of nd x nd blocks on the dof vector ordered (cell, dof)."""
    K, nd, _, nc = B.shape
    rows = torch.arange(nc, device=B.device).repeat(K)
    vals = B.permute(0, 3, 1, 2).reshape(K * nc, nd, nd)
    return bsr_matrix(rows, nbr.reshape(-1), vals, nc, nc)


def pair_bsr(pd, pe, pm):
    """One pair-layout system as a BSR matrix of nd x nd blocks on the dof
    vector ordered (half, pair, dof): the pair diagonal's four blocks and
    each external slot's owner-half block at its gather column."""
    from knpemidg_tpu_torch.ops import pairs

    nd, npair = pe.shape[2], pe.shape[-1]
    p = torch.arange(npair, device=pd.device)
    rows, cols, vals = [], [], []
    for hr in range(2):
        for hc in range(2):
            rows.append(hr * npair + p)
            cols.append(hc * npair + p)
            vals.append(pd[hr * nd:(hr + 1) * nd, hc * nd:(hc + 1) * nd].permute(2, 0, 1))
    own = pairs.owner_half_rows(pm, nd)[:, nd, 0]        # (S, npair): owner is half 1
    for t in range(pe.shape[0]):
        h = own[t].long()
        rows.append(h * npair + p)
        cols.append(pm["ext_col"][t].long())
        vals.append(torch.where(own[t][:, None, None], pe[t, nd:].permute(2, 0, 1),
                                pe[t, :nd].permute(2, 0, 1)))
    return bsr_matrix(torch.cat(rows), torch.cat(cols), torch.cat(vals), 2 * npair, 2 * npair)


def bsr_library(name, dtype, systems):
    """The library call of a matvec row: one torch.sparse_bsr_tensor product
    per system, ``systems`` a list of (make the BSR matrix, vector in the
    matrix's dof order, the plain output in that order).  Returns the
    function to time, or None with torch's reason printed when torch does
    not take the product or the product is not the kernel's function."""
    try:
        mats = [(make(), u.contiguous()) for make, u, _ in systems]
        outs = [A @ u for A, u in mats]
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        print(f"library {name:30s} {str(dtype):14s} none (torch: "
              f"{str(e).strip().splitlines()[0][:160]})")
        return None
    diff = max(float((o - ref).abs().max() / ref.abs().max().clamp_min(1e-300))
               for o, (_, _, ref) in zip(outs, systems))
    print(f"library {name:30s} {str(dtype):14s} torch.sparse_bsr_tensor @ vector, "
          f"{len(mats)} products, max |bsr - plain| / max |plain| {diff:.1e}")
    # a sanity check of the conversion (a wrong block is an error of order 1),
    # not a tolerance of the library's rounding
    if not diff <= 1e3 * TOL[dtype][name]:
        print(f"library {name:30s} {str(dtype):14s} none (the BSR product disagrees)")
        return None
    return lambda: [A @ u for A, u in mats]


def coarse_abs(co):
    """Coarse operands with every tensor replaced by its absolute value, for
    the plain versions (no workspace)."""
    def a(v):
        if isinstance(v, torch.Tensor):
            return v.abs()
        return tuple(a(x) for x in v) if isinstance(v, tuple) else v
    return co._replace(work=None, **{k: a(v) for k, v in co._asdict().items() if k != "work"})


def solve_scale(co, rc, proj):
    """Componentwise scale of the solve: every product and sum of the dense
    solve (through its refinement) and of the small solves in absolute
    values."""
    from knpemidg_tpu_torch.ops.coarse import _mv

    a = coarse_abs(co)
    x = (co.s * rc).abs()
    z = _mv(a.inv, x)
    if co.As is not None:
        z = z + _mv(a.inv, x + _mv(a.As, z))
    out = [a.s * z]
    n_comp, nw, nr = co.sizes
    if co.comp is not None:
        invc, sc, Asc = a.comp
        xc = sc * proj[:, :n_comp].abs()
        y = xc @ invc.T
        out.append(sc * (y + (xc + y @ Asc.T) @ invc.T))
    for grp, lo, hi in ((a.mom, n_comp, n_comp + nw), (a.ritz, n_comp + nw, n_comp + nw + nr)):
        if grp is not None:
            out.append(grp[1] * ((grp[1] * proj[:, lo:hi].abs()) @ grp[0].T))
    return [out[0], torch.cat(out[1:], dim=1)] if len(out) > 1 else [out[0]]


def nonempty(ts):
    return [t for t in ts if t.numel()]


def dense_gemvs(co, x):
    """The dense solve's GEMVs as cuBLAS calls (torch.mv, or one batched
    torch.matmul for m systems): the yardstick of the solve entry."""
    mats = [co.inv, co.As, co.inv] if co.As is not None else [co.inv]
    if co.inv.shape[0] == 1:
        return [torch.mv(A[0], x[0]) for A in mats]
    return [torch.matmul(A, x[..., None]) for A in mats]


def bits(t):
    """t's bytes as integers (torch.equal takes -0 for +0)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def coarse_phase(layout, co, r, results, mask=None, record=True):
    """K6 (co.batched False) or K7 at one layout's shapes (layout "mms":
    the 2D rows, nd = 3): restrict, solve and prolong_add against their
    plain versions on the same inputs, timed with their bounds (checked
    only without ``record``).  solve and prolong_add run as the apply calls them:
    on the workspace's buffers (restrict's and solve's outputs, here loaded
    with the plain versions' values), the prolong-add with the pair
    layout's live ``mask``.  K7's operands (no fields, no As) also take the
    one-launch apply, as the KNP solve calls it: held bit for bit to the
    three launches and to the three plain steps to round-off, and timed."""
    from knpemidg_tpu_torch.ops import coarse

    dtype = r.dtype
    sfx = ("_batched" if co.batched else "") + {"pair": "_pair", "mms": "_nd3"}.get(layout, "")
    name = lambda e: f"two_level_{e}{sfx}"
    a = coarse_abs(co)
    fields = [t for t in (co.OH, co.W, co.Wr) if t is not None]
    m, nd, nc = r.shape
    n_comp, nw, nr = co.sizes
    # the work reads each field over its span only (the one-hot's values,
    # nd values a cell of W and Wr): those bytes, every field whole beside
    span_cells = [0, 0]
    if co.work.spans is not None:
        ln = (co.work.spans[:, 1] - co.work.spans[:, 0]).clamp(min=0).long().cpu()
        span_cells = [int(ln[:n_comp].sum()), int(ln[n_comp:].sum())]
    span_bytes = (span_cells[0] + nd * span_cells[1]) * r.element_size()
    whole = (lambda ts: nbytes(ts + fields)) if fields else (lambda ts: None)
    field_flops = 2.0 * m * (nd * span_cells[1] + span_cells[0])
    compare(name("restrict"), dtype, lambda: nonempty(coarse.restrict(co, r)),
            lambda: nonempty(coarse.restrict_plain(co, r)),
            lambda ref: nonempty(coarse.restrict_plain(a, r.abs())), results,
            inputs=[r], extra_bytes=span_bytes, whole_bytes=whole([r]),
            flops=field_flops + r.numel(), record=record, graph=layout == "mms")
    rc, proj = coarse.restrict_plain(co, r)
    wk = co.work
    wk.rc.copy_(rc)
    wk.proj.copy_(proj)
    mats = [co.inv, co.s] + ([co.As] if co.As is not None else []) + [
        t for grp in (co.comp, co.mom, co.ritz) if grp is not None for t in grp]
    n = rc.shape[1]
    x = co.s * rc
    compare(name("solve"), dtype, lambda: nonempty(coarse.solve(co, wk.rc, wk.proj)),
            lambda: nonempty(coarse.solve_plain(co, rc, proj)),
            lambda ref: solve_scale(co, rc, proj), results,
            inputs=[rc, proj] + mats,
            flops=2.0 * m * n * n * (3 if co.As is not None else 1),
            library_fn=lambda: dense_gemvs(co, x), record=record, graph=layout == "mms")
    zc, coef = coarse.solve_plain(co, rc, proj)
    wk.zc.copy_(zc)
    wk.coef.copy_(coef)
    out0 = r.clone()                   # stands in for the block-Jacobi output
    bufs = [out0.clone(), out0.clone()]
    masks = [] if mask is None else [mask]
    compare(name("prolong"), dtype,
            lambda: [coarse.prolong_add(co, out0.clone(), wk.zc, wk.coef, mask)],
            lambda: [coarse.prolong_add_plain(co, out0.clone(), zc, coef, mask)],
            lambda ref: [coarse.prolong_add_plain(a, out0.abs(), zc.abs(), coef.abs(), mask)],
            results, inputs=[out0, zc, coef] + masks, extra_bytes=span_bytes,
            whole_bytes=whole([out0, zc, coef] + masks),
            flops=field_flops + (3.0 if masks else 2.0) * r.numel(),
            timed=(lambda: coarse.prolong_add(co, bufs[0], wk.zc, wk.coef, mask),
                   lambda: coarse.prolong_add_plain(co, bufs[1], zc, coef, mask)),
            record=record, graph=layout == "mms")
    if co.work.fused is None or nd not in coarse.FUSED_ND:
        return
    fused = "two_level_coarse_batched" + ("_pair" if layout == "pair" else "")
    three = coarse.prolong_add(co, out0.clone(), *coarse.solve(co, *coarse.restrict(co, r)),
                               mask)
    one = coarse.coarse_add(co, out0.clone(), r, mask)
    torch.cuda.synchronize()
    same = torch.equal(bits(one), bits(three))
    print(f"exact   {fused:30s} {str(dtype):14s} one launch = restrict, solve, prolong_add "
          f"bit for bit: {same}")
    if not same:
        raise AssertionError(f"{fused} differs from the three launches in {dtype}")
    bufs = [out0.clone(), out0.clone()]
    compare(fused, dtype, lambda: [coarse.coarse_add(co, out0.clone(), r, mask)],
            lambda: [coarse.coarse_apply_plain(co, out0.clone(), r, mask)],
            lambda ref: [coarse.coarse_apply_plain(a, out0.abs(), r.abs(), mask)],
            results, inputs=[r, out0, co.inv, co.s] + masks,
            flops=2.0 * m * n * n + r.numel() + (3.0 if masks else 2.0) * r.numel(),
            timed=(lambda: coarse.coarse_add(co, bufs[0], r, mask),
                   lambda: coarse.coarse_apply_plain(co, bufs[1], r, mask)))


def coarse_inputs(pc, agg, dtype):
    """K6 and K7 operands of a built pc, cast to ``dtype``."""
    from knpemidg_tpu_torch.ops import coarse

    cast = lambda d: {k: v.to(dtype) for k, v in d.items()}
    return (coarse.operands(cast(pc["emi"]), agg, batched=False),
            coarse.operands(cast(pc["knp"]), agg, batched=True))


def cast_step_inputs(mem, pushes, dtype):
    """The step's membrane states (in step order) and pushes in ``dtype``;
    a source tensor shared by several pushes is cast once."""
    from knpemidg_tpu_torch.membrane import engine

    cast = {}

    def src(v):
        t, off = v
        if id(t) not in cast:
            cast[id(t)] = t.to(dtype)
        return cast[id(t)], off

    mms = [engine.MembraneState(mm.states.to(dtype), mm.params.to(dtype), mm.model)
           for mm in mem.values()]
    ps = [engine.TagPush(v=None if p.v is None else src(p.v),
                         params={k: src(v) for k, v in p.params.items()}) for p in pushes]
    return mms, ps


def flat_step(out):
    """ode_step_tags' (states, phi_M, I_ch) as a list of tensors."""
    mems, phi_M, I_ch = out
    return [v for mm in mems for v in (mm.states, mm.params)] + [phi_M, I_ch]


def push_bytes(table, pushes):
    """Bytes of the pushed values the step reads in place of parameters."""
    return sum(e.n * t.element_size() for e, p in zip(table.entries, pushes)
               for t, _ in ([p.v] if p.v is not None else []) + list(p.params.values()))


LATENCY_POINTS = 32       # points a tag of the latency floor: a warp a lane


def latency_floor(table, mms, pushes, args, ion_names):
    """Device milliseconds (graph replay) of the same launch on the first
    LATENCY_POINTS points of each tag (one warp for a model with a lane a
    point, 8 for HH's 8 lanes a point): the chain's latency with the card
    otherwise idle."""
    from knpemidg_tpu_torch.membrane import engine

    n = LATENCY_POINTS
    small = engine.tag_table([(e.model, j * n, n) for j, e in enumerate(table.entries)],
                             n * len(table.entries), ion_names, table.scheme)
    sub = [engine.MembraneState(mm.states[:, :n].contiguous(), mm.params[:, :n].contiguous(),
                                mm.model) for mm in mms]
    return graph_ms(lambda: engine.ode_step_tags(small, sub, pushes, *args))


def kernel_phase(S, state, results):
    """The cell path's kernels at its shapes."""
    from knpemidg_tpu_torch.membrane import engine
    from knpemidg_tpu_torch.ops import spmv

    nbr = S.g["nbr"]
    pM, Ich, Itot = S._pads(state)
    blocks, rhs, Pd = S._assemble_emi(state["c"], state["c_elim"], pM, Itot, state["t"])
    blocksK, rhsK = S._knp_assemble_all(state["c"], state["c_elim"], state["phi"],
                                        pM, Ich, Itot, state["t"], state["c"])
    table, pushes = S._ode_pushes(state, first_step=True)
    pe = state["pc"]["emi"]
    print(f"shapes  EMI blocks {tuple(blocks.shape)}  KNP blocks "
          f"{tuple(blocksK.shape)}  membrane points "
          f"{ {tag: e.n for tag, e in zip(state['mem'], table.entries)} }  coarse "
          f"{tuple(pe['inv'].shape)}  moment {tuple(pe['mom_W'].shape)}  Ritz "
          f"{tuple(pe['ritz_W'].shape) if 'ritz_W' in pe else None}")

    def ode_scale(mms, ref):
        """Each state row against its own max |plain| (a gating variable is
        not measured against V); each parameter row against its own max
        |plain| floored at the tag's largest leak term g_leak |V - E|: the
        written-back channel currents are sums of such terms that cancel
        to ~1e-10 at rest.  phi_M against its max |plain|, each I_ch row
        against its max |plain| floored at the largest leak term of any
        tag."""
        out, leaks = [], []
        for mm, ys, ps in zip(mms, ref[0:-2:2], ref[1:-2:2]):
            P, V = mm.model.PARAMS, ys[mm.model.STATES["V"]]
            leak = torch.maximum(
                (ps[P["g_leak_Na"]] * (V - ps[P["E_Na"]])).abs().max(),
                (ps[P["g_leak_K"]] * (V - ps[P["E_K"]])).abs().max())
            leaks.append(leak)
            out += [ys.abs().amax(dim=-1, keepdim=True),
                    torch.maximum(ps.abs().amax(dim=-1, keepdim=True), leak)]
        phi_M, I_ch = ref[-2:]
        return out + [phi_M.abs().max(), torch.maximum(
            I_ch.abs().amax(dim=-1, keepdim=True), torch.stack(leaks).max())]

    # each timed call is one application per system of the step: the EMI
    # (m = 1) and the KNP (m = 2) operator, both membrane tags
    for dtype in (torch.float32, torch.float64):
        B, x = blocks.to(dtype), rhs.to(dtype)
        BK, xK = blocksK.to(dtype), rhsK.to(dtype)
        P, PK = Pd.to(dtype).contiguous(), BK[:, 0].contiguous()
        cells = lambda v: v.t().reshape(-1)               # (nd, nc) -> (cell, dof)
        bell_lib = bsr_library("bell_matvec", dtype, [
            (lambda B_=B_, nb=nbr: bell_bsr(B_, nb), cells(v), cells(ref))
            for B_, v, ref in [(B, x, spmv.bell_matvec_plain(B, nbr, x))]
            + [(BK[k], xK[k], spmv.bell_matvec_plain(BK[k], nbr, xK[k]))
               for k in range(BK.shape[0])]])
        compare("bell_matvec", dtype,
                lambda: [spmv.bell_matvec(B, nbr, x), spmv.bell_matvec_multi(BK, nbr, xK)],
                lambda: [spmv.bell_matvec_plain(B, nbr, x),
                         spmv.bell_matvec_multi_plain(BK, nbr, xK)],
                lambda ref: [spmv.bell_matvec_plain(B.abs(), nbr, x.abs()),
                             spmv.bell_matvec_multi_plain(BK.abs(), nbr, xK.abs())],
                results, inputs=[B, nbr, x, BK, nbr, xK],
                flops=2.0 * (B.numel() + BK.numel()), library_fn=bell_lib)
        compare("block_jacobi_inverse", dtype,
                lambda: [spmv.block_jacobi_inverse(P), spmv.block_jacobi_inverse(PK)],
                lambda: [spmv.block_jacobi_inverse_plain(P),
                         spmv.block_jacobi_inverse_plain(PK)],
                lambda ref: [inv_scale(P, ref[0]), inv_scale(PK, ref[1])], results,
                inputs=[P, PK], flops=bj_inv_flops(P) + bj_inv_flops(PK),
                library_fn=lambda: [lib_inv(P), lib_inv(PK)])
        inv, invK = spmv.block_jacobi_inverse(P), spmv.block_jacobi_inverse(PK)
        # as the two-level apply calls it: operands checked once, a new z
        op, opK = spmv.block_jacobi_operands(inv), spmv.block_jacobi_operands(invK)
        compare("block_jacobi_apply", dtype,
                lambda: [spmv.block_jacobi_apply(op, x),
                         spmv.block_jacobi_apply(opK, xK)],
                lambda: [spmv.block_jacobi_apply_plain(inv, x),
                         spmv.block_jacobi_apply_plain(invK, xK)],
                lambda ref: [spmv.block_jacobi_apply_plain(inv.abs(), x.abs()),
                             spmv.block_jacobi_apply_plain(invK.abs(), xK.abs())],
                results, inputs=[inv, x, invK, xK],
                flops=bj_apply_flops(inv) + bj_apply_flops(invK),
                library_fn=lambda: [lib_apply(inv, x), lib_apply(invK, xK)])
        mms, ps = cast_step_inputs(state["mem"], pushes, dtype)
        t = state["t"].to(dtype)
        args = (t, S.params.dt, S.params.n_steps_ODE)
        for name, scheme, ops in (
                ("membrane_rk4", "rk4", lambda mm: 4 * RK4_RHS_OPS[type(mm.model).__name__]),
                ("membrane_rl", "rush_larsen",
                 lambda mm: RL_SUBSTEP_OPS[type(mm.model).__name__])):
            tab = engine.tag_table([(e.model, e.s0, e.n) for e in table.entries],
                                   table.n_mem, S.ion_names, scheme)
            step = lambda fn, tab=tab, ps=ps: flat_step(fn(tab, mms, ps, *args))
            compare(name, dtype, lambda: step(engine.ode_step_tags),
                    lambda: step(engine.ode_step_tags_plain),
                    lambda ref: ode_scale(mms, ref), results,
                    inputs=[v for mm in mms for v in (mm.states, mm.params)],
                    extra_bytes=push_bytes(table, ps),
                    flops=sum(S.params.n_steps_ODE * ops(mm) * mm.states.shape[1]
                              for mm in mms))
            r = results[name][dtype]
            r["floor_ms"] = latency_floor(tab, mms, ps, args, S.ion_names)
            r["graph_ms"] = graph_ms(lambda: engine.ode_step_tags(tab, mms, ps, *args))
            print(f"floor   {name:30s} {str(dtype):14s} graph replay: {LATENCY_POINTS} "
                  f"points a tag {r['floor_ms']:.4f} ms, all points {r['graph_ms']:.4f} ms; "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        # K6 with the compartment, moment and Ritz data of the pc build, K7
        # with the two ions' coarse data; the step's EMI and KNP rhs
        co6, co7 = coarse_inputs(state["pc"], AGG, dtype)
        if co6.Wr is None:
            raise AssertionError("the cell pc carries no Ritz fields")
        coarse_phase("cell", co6, x[None], results)
        coarse_phase("cell", co7, xK.contiguous(), results)


def pair_kernel_phase(S, state, results):
    """The pair path's kernels (K3, K4, K12, K5 at nd = 8) at its shapes:
    the pair operators, vectors and facet blocks of the step's EMI and KNP
    assemblies."""
    from knpemidg_tpu_torch.ops import assembly, pairs, spmv

    pm = S.pairs
    pM, Ich, Itot = S._pads(state)
    # the facet blocks the assembly hands the pair emit (K12)
    emits = {}
    originals = {n: getattr(assembly, n) for n in ("gather_blocks_pair",
                                                   "gather_blocks_pair_multi")}

    def capture(name):
        def wrapped(*args, **kw):
            emits[name] = (args[2:], kw)
            return originals[name](*args, **kw)
        return wrapped

    try:
        for name in originals:
            setattr(assembly, name, capture(name))
        (pd, pe), rhs, Pd = S._assemble_emi(state["c"], state["c_elim"], pM, Itot,
                                            state["t"], pair=True)
        (pdK, peK), rhsK = S._knp_assemble_all(state["c"], state["c_elim"], state["phi"],
                                               pM, Ich, Itot, state["t"], state["c"])
    finally:
        for name, fn in originals.items():
            setattr(assembly, name, fn)
    npair = pd.shape[-1]
    print(f"shapes  pair EMI pd {tuple(pd.shape)} pe {tuple(pe.shape)}  KNP pd "
          f"{tuple(pdK.shape)} pe {tuple(peK.shape)}  padded cells {rhs.shape[-1]}")
    halves = S._pair_bj_halves
    # the pair matvec kernel reads only the owner half's rows of each
    # external slot: the operators must be exactly zero in the other half
    own = pairs.owner_half_rows(pm, S.nd)
    zero = {k: not bool(blk.masked_select(~own).any()) for k, blk in (("EMI", pe[None]),
                                                                        ("KNP", peK))}
    print(f"invariant pe exactly zero outside each slot's owner half: EMI {zero['EMI']}, "
          f"KNP {zero['KNP']}")
    if not all(zero.values()):
        raise AssertionError("a pair operator is not zero outside the owner halves")

    for dtype in (torch.float32, torch.float64):
        cast = lambda ts: [t.to(dtype).contiguous() for t in ts]
        # as the assemblies call it: the EMI emit with the regularisation
        # blocks (third output pd + embedded reg), the KNP emit with the
        # static pair operator added last
        e_args, k_args = cast(emits["gather_blocks_pair"][0]), cast(
            emits["gather_blocks_pair_multi"][0])
        reg = emits["gather_blocks_pair"][1]["reg"].to(dtype)
        add = tuple(cast(emits["gather_blocks_pair_multi"][1]["add"]))
        # as the step calls it: into buffers made once, whose pe keeps its
        # zero halves; the work writes pd, pdiag and the owner halves of
        # pe, and reads add_pe's owner halves and the packed map table
        m = k_args[0].shape[0]
        bufE = pairs.emit_buffers(pm, S.nd, dtype, reg.device, diag=True)
        bufK = pairs.emit_buffers(pm, S.nd, dtype, reg.device, m=m)
        own_vals = int(own.sum()) * S.nd
        elt = reg.element_size()
        compare("gather_blocks_pair", dtype,
                lambda: [*pairs.gather_blocks_pair(None, pm, *e_args, reg=reg, out=bufE),
                         *pairs.gather_blocks_pair_multi(None, pm, *k_args, add=add,
                                                         out=bufK)],
                lambda: [*pairs.gather_blocks_pair_plain(None, pm, *e_args, reg=reg),
                         *pairs.gather_blocks_pair_multi_plain(None, pm, *k_args, add=add)],
                exact, results,
                inputs=e_args + k_args + [reg, add[0], pairs.emit_table(pm)],
                extra_bytes=m * own_vals * elt,
                out_bytes=((2 + m) * bufE[0].numel() + (1 + m) * own_vals) * elt,
                whole_bytes=nbytes(e_args + k_args + [reg, *add] + [pm[k] for k in (
                    "cop", "live1", "int_f", "int_p0", "ext_f", "ext_isp", "ext_h")]))
        zero = all(not bool(bits(pe).masked_select(~own).any()) for pe in (bufE[1][None],
                                                                            bufK[1]))
        print(f"exact   gather_blocks_pair             {str(dtype):14s} the buffers' pe "
              f"+0 outside the owner halves after the timed emits: {zero}")
        if not zero:
            raise AssertionError("the pair emit wrote outside the owner halves")

        # the solver's vectors (EMI: rhs, iterate, predictor base; KNP: rhs,
        # iterate), converted as the solver converts them: the list form
        vecs = [t.to(dtype).contiguous() for t in (rhs, state["phi"], state["phi_prev"])]
        vecsK = [t.to(dtype).contiguous() for t in (rhsK, state["c"])]
        stack, stackK = torch.stack(vecs), torch.stack(vecsK)
        mask = S._pair_mask.to(dtype).reshape(2, S.nd, npair)
        bufs = [torch.empty(t.shape[:-2] + (2 * S.nd, npair), dtype=dtype, device=t.device)
                for t in (stack, stackK)]

        def lib_to_pair():
            return [torch.mul(torch.movedim(t.reshape(-1, S.nd, npair, 2), -1, 1),
                              mask, out=b.view(-1, 2, S.nd, npair))
                    for t, b in zip((stack, stackK), bufs)]

        plain_to_pair = lambda: [pairs.to_pair_plain(pm, stack),
                                 pairs.to_pair_plain(pm, stackK)]
        compare("to_pair", dtype, lambda: [pairs.to_pair(pm, vecs), pairs.to_pair(pm, vecsK)],
                plain_to_pair, exact, results, inputs=[stack, stackK, pm["live1"]],
                library_fn=lib_to_pair,
                timed=(lambda: [pairs.to_pair(pm, vecs, out=bufs[0]),
                                pairs.to_pair(pm, vecsK, out=bufs[1])], plain_to_pair))
        compare("to_pair", dtype, lambda: [pairs.to_pair(pm, stack), pairs.to_pair(pm, stackK)],
                plain_to_pair, exact, results, record=False)
        # back as the solver converts: the EMI solution with the guess added in
        # pair form, the KNP one added to c in cell form
        xp, guess = pairs.to_pair(pm, stack[1]), pairs.to_pair(pm, stack[2])
        xpK, cK = pairs.to_pair(pm, stackK[1]), vecsK[1]
        cells = lambda v: torch.movedim(v.reshape(*v.shape[:-2], 2, S.nd, npair), -3, -1)
        obufs = [torch.empty_like(stack[1]), torch.empty_like(cK)]

        def lib_from_pair():
            return [torch.add(cells(xp), cells(guess), out=obufs[0].view(S.nd, npair, 2)),
                    torch.add(cK.view(-1, S.nd, npair, 2), cells(xpK),
                              out=obufs[1].view(-1, S.nd, npair, 2))]

        plain_from_pair = lambda: [pairs.from_pair_plain(pm, xp, add=guess),
                                   pairs.from_pair_plain(pm, xpK, base=cK)]
        compare("from_pair", dtype,
                lambda: [pairs.from_pair(pm, xp, add=guess), pairs.from_pair(pm, xpK, base=cK)],
                plain_from_pair, exact, results, inputs=[xp, guess, xpK, cK],
                flops=xp.numel() + xpK.numel(), library_fn=lib_from_pair,
                timed=(lambda: [pairs.from_pair(pm, xp, add=guess, out=obufs[0]),
                                pairs.from_pair(pm, xpK, base=cK, out=obufs[1])],
                       plain_from_pair))
        compare("from_pair", dtype, lambda: [pairs.from_pair(pm, xp), pairs.from_pair(pm, xpK)],
                lambda: [pairs.from_pair_plain(pm, xp), pairs.from_pair_plain(pm, xpK)],
                exact, results, record=False)

        D, E = pd.to(dtype), pe.to(dtype)
        DK, EK = pdK.to(dtype), peK.to(dtype)
        r, rK = pairs.to_pair(pm, rhs.to(dtype)), pairs.to_pair(pm, rhsK.to(dtype))
        halves_order = lambda v: v.reshape(2, S.nd, npair).transpose(1, 2).reshape(-1)
        pair_lib = bsr_library("pair_matvec", dtype, [
            (lambda a=a, b=b: pair_bsr(a, b, pm), halves_order(v),
             halves_order(pairs.pair_matvec_plain(a, b, pm, v)))
            for a, b, v in [(D, E, r)] + [(DK[k], EK[k], rK[k]) for k in range(DK.shape[0])]])
        # the work: pd, the owner-half rows of pe, x, ext_col, the mask, y
        pe_bytes = (int(own.sum()) * S.nd * (1 + DK.shape[0])) * E.element_size()
        compare("pair_matvec", dtype,
                lambda: [pairs.pair_matvec(D, E, pm, r), pairs.pair_matvec_multi(DK, EK, pm, rK)],
                lambda: [pairs.pair_matvec_plain(D, E, pm, r),
                         pairs.pair_matvec_multi_plain(DK, EK, pm, rK)],
                lambda ref: [pairs.pair_matvec_plain(D.abs(), E.abs(), pm, r.abs()),
                             pairs.pair_matvec_multi_plain(DK.abs(), EK.abs(), pm, rK.abs())],
                results, inputs=[D, r, DK, rK, pm["ext_col"], pm["ext_hmask"]],
                extra_bytes=pe_bytes, whole_bytes=nbytes([D, E, r, DK, EK, rK, pm["ext_col"]]),
                flops=2.0 * (D.numel() + DK.numel()) + 2.0 * pe_bytes / E.element_size(),
                library_fn=pair_lib)

        # the main path's 'halves' diagonals are timed; the full ones checked.
        # The main path applies the halves inverse in the halves form, as the
        # masked two-level apply calls it (operands checked once, one output
        # buffer); its work reads the two diagonal sub-blocks of the inverse
        P_h = (Pd.to(dtype) * halves.to(dtype)).contiguous()
        PK_h = (DK * halves.to(dtype)[None]).contiguous()
        P_f, PK_f = Pd.to(dtype).contiguous(), DK.contiguous()
        for P, PK, record in ((P_h, PK_h, True), (P_f, PK_f, False)):
            compare("block_jacobi_inverse_nd8", dtype,
                    lambda: [spmv.block_jacobi_inverse(P), spmv.block_jacobi_inverse(PK)],
                    lambda: [spmv.block_jacobi_inverse_plain(P),
                             spmv.block_jacobi_inverse_plain(PK)],
                    lambda ref: [inv_scale(P, ref[0]), inv_scale(PK, ref[1])], results,
                    inputs=[P, PK], flops=bj_inv_flops(P) + bj_inv_flops(PK),
                    library_fn=lambda: [lib_inv(P), lib_inv(PK)], record=record)
            inv, invK = spmv.block_jacobi_inverse(P), spmv.block_jacobi_inverse(PK)
            if record:
                ops = [spmv.block_jacobi_operands(t, halves=True, buffer=True)
                       for t in (inv, invK)]
                half_bytes = (inv.numel() + invK.numel()) // 2 * inv.element_size()
                compare("block_jacobi_apply_nd8", dtype,
                        lambda: [spmv.block_jacobi_apply(ops[0], r),
                                 spmv.block_jacobi_apply(ops[1], rK)],
                        lambda: [spmv.block_jacobi_apply_plain(inv, r, halves=True),
                                 spmv.block_jacobi_apply_plain(invK, rK, halves=True)],
                        lambda ref: [spmv.block_jacobi_apply_plain(inv.abs(), r.abs(), True),
                                     spmv.block_jacobi_apply_plain(invK.abs(), rK.abs(),
                                                                   True)],
                        results, inputs=[r, rK], extra_bytes=half_bytes,
                        whole_bytes=nbytes([inv, r, invK, rK]),
                        flops=bj_apply_flops(inv) / 2 + bj_apply_flops(invK) / 2,
                        library_fn=lambda: [lib_apply(inv, r), lib_apply(invK, rK)])
            compare("block_jacobi_apply_nd8", dtype,
                    lambda: [spmv.block_jacobi_apply(inv, r),
                             spmv.block_jacobi_apply(invK, rK)],
                    lambda: [spmv.block_jacobi_apply_plain(inv, r),
                             spmv.block_jacobi_apply_plain(invK, rK)],
                    lambda ref: [spmv.block_jacobi_apply_plain(inv.abs(), r.abs()),
                                 spmv.block_jacobi_apply_plain(invK.abs(), rK.abs())],
                    results, record=False)
        # K6 with the compartment and moment data (AUTO: no Ritz on pairs),
        # K7 with the two ions' coarse data, on the pair rhs
        co6, co7 = coarse_inputs(state["pc"], AGG // 2, dtype)
        lm = S._live_mask(dtype)
        coarse_phase("pair", co6, r[None], results, lm)
        coarse_phase("pair", co7, rK, results, lm)


def krylov_phase(S, results, layout):
    """K8 and K9 at one layout's main-path shapes (the EMI vector, the KNP
    batch of S.N_ions systems; on the MMS path one system a solve at its
    restart) on seeded random inputs: each entry point
    against its plain version, the basis populated in KRYLOV_ROWS
    orthonormal rows (zero beyond them, as the plain versions' basis is),
    timed with its bound; the library calls are the reference's
    whole-basis products and dots.  The Arnoldi step (one launch) is also
    held to its ordered plain version to the last bit over 200 calls and
    timed in graph replay beside the whole-basis bmm / baddbmm CGS2."""
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.ops import krylov_ops as ko

    pair = layout == "pair"
    name = lambda k: k + SUFFIX[layout]
    nd, dev = S.nd, S.c_init.device
    ncol = S.pairs["int_f"].shape[0] if pair else S.n_cells
    vshape = (2 * nd if pair else nd, ncol)
    if layout == "mms":
        mb, m = 1, mms_params_iterative().gmres_restart
    else:
        mb, m = S.N_ions, emix.solver_params().gmres_restart
    n = vshape[0] * ncol
    J = KRYLOV_ROWS - 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)
    print(f"shapes  {layout} Krylov: EMI vector {vshape}, KNP batch ({mb}, {n}), restart {m}, "
          f"K9 at {KRYLOV_ROWS} populated rows")

    for dtype in (torch.float32, torch.float64):
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        # --- K9 -------------------------------------------------------------
        wk = ko.gmres_work(mb, n, m, dtype, dev)
        wk.V.zero_()
        # an orthonormal basis of KRYLOV_ROWS rows a system, as a cycle's is
        for s in range(mb):
            wk.V[:KRYLOV_ROWS, s] = torch.linalg.qr(rnd(n, KRYLOV_ROWS))[0].T
        Vs = wk.V.transpose(0, 1).contiguous()          # the reference's (mb, m+1, n)
        V_live = wk.V[:KRYLOV_ROWS]
        w = rnd(mb, n)
        h = torch.zeros_like(wk.h1)
        rows = KRYLOV_ROWS
        compare(name("gmres_cgs_dot"), dtype,
                lambda: [ko.gmres_cgs_dot(wk.V, w, rows, h.clone(), wk)[:, :rows]],
                lambda: [ko.gmres_cgs_dot_plain(wk.V, w, rows, h.clone())[:, :rows]],
                lambda ref: [ko.gmres_cgs_dot_plain(wk.V.abs(), w.abs(), rows,
                                                    h.clone())[:, :rows]],
                results, inputs=[V_live, w], flops=2.0 * V_live.numel(),
                library_fn=lambda: torch.bmm(Vs, w[..., None]))
        # step J's scalars: system 0 live, the others frozen
        wk.tol.copy_(torch.full((mb,), 1e3, dtype=dtype))
        wk.tol[0] = 1e-3
        wk.g[:, :rows] = rnd(mb, rows)
        wk.g[0, J] = 5.0
        ang = 2 * np.pi * torch.rand((mb, m), generator=gen, device=dev, dtype=dtype)
        wk.cs.copy_(torch.cos(ang))
        wk.sn.copy_(torch.sin(ang))
        wk.R.copy_(rnd(mb, m + 1, m))
        wk.R[:, range(m), range(m)] += 4.0
        wk.ks.fill_(J)
        step_out = lambda a: [a.h1[:, :rows], a.h2[:, :rows], a.hj1, a.V[J + 1], a.R, a.g,
                              a.cs, a.sn, a.ks, a.flag]

        def step(fn):
            a = work_copy(wk)
            fn(w.clone(), a, J)
            return step_out(a)

        wa, wt = work_copy(wk), [w.clone(), w.clone()]
        bound = compare(name("gmres_arnoldi"), dtype, lambda: step(ko.gmres_arnoldi),
                        lambda: step(ko.gmres_arnoldi_plain),
                        lambda ref: arnoldi_scales(wk, w, J, ref), results,
                        inputs=[V_live, w, wk.tol, wk.g, wk.cs[:, :J], wk.sn[:, :J], wk.ks],
                        flops=(8.0 * rows + 3.0) * mb * n,
                        timed=(lambda: ko.gmres_arnoldi(wt[0], wa, J),
                               lambda: ko.gmres_arnoldi_plain(wt[1], work_copy(wk), J)))
        arnoldi_exact(name("gmres_arnoldi"), dtype, ko, w, wk, J)
        # the step in graph replay (no host between the launches) beside the
        # reference's whole-basis products (bmm, baddbmm, bmm, baddbmm: the
        # CGS2 alone, a partial yardstick)
        step_us = 1e3 * graph_ms(lambda: ko.gmres_arnoldi(wt[0], wa, J))
        wl = [w[:, None].clone() for _ in range(2)]
        hl = [torch.empty((mb, m + 1, 1), dtype=dtype, device=dev) for _ in range(2)]

        def bmm_cgs2():
            torch.bmm(Vs, wl[0].transpose(1, 2), out=hl[0])
            torch.baddbmm(w[:, None], hl[0].transpose(1, 2), Vs, alpha=-1.0, out=wl[1])
            torch.bmm(Vs, wl[1].transpose(1, 2), out=hl[1])
            torch.baddbmm(wl[1], hl[1].transpose(1, 2), Vs, alpha=-1.0, out=wl[0])

        lib_us = 1e3 * graph_ms(bmm_cgs2)
        print(f"step    {name('gmres_arnoldi'):30s} {str(dtype):14s} graph replay {step_us:.2f} us "
              f"a step, bound {1e3 * bound:.2f} us ({step_us / (1e3 * bound):.2f}x); whole-basis "
              f"bmm/baddbmm CGS2 {lib_us:.2f} us; {'staged' if wa.staged else 're-read'} "
              f"layout, {wa.grid} blocks of {wa.upb} chunks")
        ws = ko.gmres_arnoldi_plain(w.clone(), work_copy(wk), J)   # ks = rows for system 0
        x = rnd(mb, n)
        yk = work_copy(ws)
        ko.gmres_solve_update_plain(yk, x.clone())      # the plain y, for the scale
        xb = [x.clone(), x.clone()]
        nk = int(ws.ks.max())
        compare(name("gmres_solve_update"), dtype,
                lambda: [ko.gmres_solve_update(ws, x.clone())],
                lambda: [ko.gmres_solve_update_plain(ws, x.clone())],
                lambda ref: [x.abs() + torch.einsum("sk,ksn->sn", yk.y.abs(),
                                                    ws.V[:m].abs())],
                results, inputs=[ws.R, ws.g, ws.ks, ws.V[:nk], x],
                flops=2.0 * nk * mb * n,
                library_fn=lambda: torch.baddbmm(x[:, None], yk.y[:, None], Vs[:, :m]),
                timed=(lambda: ko.gmres_solve_update(ws, xb[0]),
                       lambda: ko.gmres_solve_update_plain(ws, xb[1])))
        r0 = rnd(mb, n)
        wn = [work_copy(wk), work_copy(wk)]

        def start_out(fn, a):
            fn(r0, a)
            return [a.V[0], a.beta, a.g]

        compare(name("gmres_start"), dtype,
                lambda: start_out(ko.gmres_start, work_copy(wk)),
                lambda: start_out(ko.gmres_start_plain, work_copy(wk)),
                lambda ref: [r.abs() for r in ref], results,
                inputs=[r0, wk.tol], flops=3.0 * r0.numel(),
                timed=(lambda: ko.gmres_start(r0, wn[0]),
                       lambda: ko.gmres_start_plain(r0, wn[1])), graph=True)
        start_exact(name("gmres_start"), dtype, ko, r0, wk)
        del wk, ws, yk, Vs, wa, wn

        # --- K8 -------------------------------------------------------------
        x, r, p_, Ap, z = (rnd(*vshape) for _ in range(5))
        if pair:
            wmask = S._pair_mask.to(dtype).contiguous()
            wsum, mode = wmask.sum(), 2
        else:
            wmask, wsum, mode = None, torch.tensor(float(x.numel()), dtype=dtype, device=dev), 1
        sc0 = torch.stack([(r * z).sum(), (z * z).sum(), torch.zeros_like(wsum),
                           torch.zeros_like(wsum), torch.zeros_like(wsum), wsum])
        work = lambda: ko.pcg_work(sc0.clone(), torch.zeros(1, dtype=torch.int32, device=dev),
                                   wmask, mode, n)
        pa = work()
        pap = (p_ * Ap).sum()
        scale_alpha = (sc0[ko.RZ].abs() * (p_.abs() * Ap.abs()).sum() / pap ** 2)
        # the dots are timed as the solver calls them: on one work per solve
        wd = [work(), work()]
        compare(name("pcg_dot"), dtype,
                lambda: [ko.pcg_dot(p_, Ap, work()).sc[ko.ALPHA]],
                lambda: [ko.pcg_dot_plain(p_, Ap, work()).sc[ko.ALPHA]],
                lambda ref: [scale_alpha], results, inputs=[p_, Ap],
                flops=2.0 * p_.numel(), library_fn=lambda: torch.dot(p_.view(-1), Ap.view(-1)),
                timed=(lambda: ko.pcg_dot(p_, Ap, wd[0]),
                       lambda: ko.pcg_dot_plain(p_, Ap, wd[1])))
        ko.pcg_dot_plain(p_, Ap, pa)
        alpha = pa.sc[ko.ALPHA]
        ax, ar = x.abs() + alpha.abs() * p_.abs(), r.abs() + alpha.abs() * Ap.abs()
        ub = [(x.clone(), r.clone()), (x.clone(), r.clone())]
        compare(name("pcg_update"), dtype,
                lambda: list(ko.pcg_update(x.clone(), r.clone(), p_, Ap, pa)),
                lambda: list(ko.pcg_update_plain(x.clone(), r.clone(), p_, Ap, pa)),
                lambda ref: [ax + ax.mean(), ar + ar.mean()], results,
                inputs=[x, r, p_, Ap] + ([wmask] if pair else []), flops=8.0 * x.numel(),
                timed=(lambda: ko.pcg_update(*ub[0], p_, Ap, pa),
                       lambda: ko.pcg_update_plain(*ub[1], p_, Ap, pa)))
        rz_abs = (r.abs() * z.abs()).sum()
        rzn = (r * z).sum()
        stack = torch.stack([r.view(-1), z.view(-1)])

        def dot2dir_out(fn):
            a, pp = work(), p_.clone()
            fn(r, z, pp, a)
            return [a.sc[:4], a.flag, pp]

        # rz', zz, alpha (untouched), beta = rz' / rz against their sums of
        # |terms|; p = z + beta p against |z| + (|beta| + beta's scale) |p|
        beta_scale = rz_abs / sc0[ko.RZ].abs()
        dot2_scale = torch.stack([rz_abs, (z * z).sum(), torch.zeros_like(rz_abs), beta_scale])
        pb = [p_.clone(), p_.clone()]
        lbuf, beta_lib = torch.empty_like(p_), rzn / sc0[ko.RZ]
        compare(name("pcg_dot2_direction"), dtype, lambda: dot2dir_out(ko.pcg_dot2_direction),
                lambda: dot2dir_out(ko.pcg_dot2_direction_plain),
                lambda ref: [dot2_scale, torch.ones_like(ref[1]),
                             z.abs() + (ref[0][ko.BETA].abs() + beta_scale) * p_.abs()],
                results, inputs=[r, z, p_], flops=6.0 * r.numel(),
                library_fn=lambda: (torch.mv(stack, z.view(-1)),
                                    torch.addcmul(z, beta_lib, p_, out=lbuf)),
                timed=(lambda: ko.pcg_dot2_direction(r, z, pb[0], wd[0]),
                       lambda: ko.pcg_dot2_direction_plain(r, z, pb[1], wd[1])))
        for entry, fn, vecs in (("pcg_dot", ko.pcg_dot, (p_, Ap)),
                                ("pcg_dot2_direction", ko.pcg_dot2_direction, (r, z, p_))):
            dots_exact(name(entry), dtype, ko, fn, vecs, sc0, work())


def work_copy(wk):
    """A GmresWork with its own copy of every buffer (the launch shape
    kept)."""
    return type(wk)(*(t.clone() if isinstance(t, torch.Tensor) else t for t in wk))


def arnoldi_scales(wk, w, j, ref):
    """Error scales of an Arnoldi step's outputs (h1, h2, hj1, V[j+1], R, g,
    cs, sn, ks, flag) against the whole-basis plain step: each sum's |terms|
    carried through the chain -- H1 = |V| |w|, W1 = |w| + |h1| |V|, H2 = |V|
    W1, W2 = W1 + |h2| |V|, ||W2|| for hj1, and W2 / hj1 + |V[j+1]| ||W2|| /
    hj1 for V[j+1] -- the Givens scalars against the largest value of each
    output, ks and the flag exactly."""
    Va = wk.V[:j + 1].abs()
    W1 = w.abs() + torch.einsum("sk,ksn->sn", ref[0].abs(), Va)
    W2 = W1 + torch.einsum("sk,ksn->sn", ref[1].abs(), Va)
    n2 = torch.sqrt((W2 * W2).sum(1))
    hj1 = torch.where(ref[2] > 0, ref[2], 1.0)[:, None]
    return ([torch.einsum("ksn,sn->sk", Va, w.abs()), torch.einsum("ksn,sn->sk", Va, W1), n2,
             (W2 + ref[3].abs() * n2[:, None]) / hj1]
            + [r.abs().amax().expand_as(r) for r in ref[4:8]]
            + [torch.ones_like(r) for r in ref[8:]])


def arnoldi_exact(name, dtype, ko, w, wk, j, calls=200):
    """gmres_arnoldi against gmres_arnoldi_ordered_plain (the kernel's
    summation order) to the last bit of every output -- h1 and h2 over the
    populated rows, hj1, V[j+1], R, g, cs, sn, ks and the flag -- in
    ``calls`` back-to-back calls on one work: before each, w and the work's
    scalars are restored and h1, h2, hj1 and V[j+1] set to NaN, the flag to
    -1, so each call writes them.  Returns nothing; raises on a difference."""
    rows = j + 1
    base = work_copy(wk)
    want = work_copy(wk)
    ko.gmres_arnoldi_ordered_plain(w.clone(), want, j)
    outs = lambda a: [a.h1[:, :rows], a.h2[:, :rows], a.hj1, a.V[j + 1], a.R, a.g, a.cs, a.sn,
                      a.ks, a.flag]
    bits = lambda t: t.view(torch.int64) if t.dtype == torch.float64 else t.view(torch.int32)
    want_bits = [bits(t) for t in outs(want)]
    diff = torch.zeros(calls, dtype=torch.int64, device=w.device)
    wc = torch.empty_like(w)
    for i in range(calls):
        for key in ("h1", "h2", "R", "g", "cs", "sn", "ks"):
            getattr(wk, key).copy_(getattr(base, key))
        wk.h1[:, :rows] = float("nan")
        wk.h2[:, :rows] = float("nan")
        wk.hj1.fill_(float("nan"))
        wk.V[j + 1].fill_(float("nan"))
        wk.flag.fill_(-1)
        wc.copy_(w)
        ko.gmres_arnoldi(wc, wk, j)
        diff[i] = sum((bits(a) != b).sum() for a, b in zip(outs(wk), want_bits))
    torch.cuda.synchronize()
    ok = int(diff.max()) == 0
    print(f"exact   {name:30s} {str(dtype):14s} every output bitwise the ordered plain's in "
          f"each of {calls} calls: {ok} ({'staged' if wk.staged else 're-read'} layout, "
          f"{wk.grid} blocks)")
    if not ok:
        raise AssertionError(f"{name} differs from gmres_arnoldi_ordered_plain")


def start_exact(name, dtype, ko, r, wk, calls=200):
    """gmres_start against gmres_start_ordered_plain (the kernel's summation
    order) to the last bit of every output -- V[0], beta, R, g, cs, sn, ks
    and the flag -- in ``calls`` back-to-back calls on one work: before
    each, V[0], beta, R, g, cs and sn are set to NaN, ks and the flag to -1,
    so each call writes them.  Returns nothing; raises on a difference."""
    want = work_copy(wk)
    ko.gmres_start_ordered_plain(r, want)
    outs = lambda a: [a.V[0], a.beta, a.R, a.g, a.cs, a.sn, a.ks, a.flag]
    bits = lambda t: t.view(torch.int64) if t.dtype == torch.float64 else t.view(torch.int32)
    want_bits = [bits(t) for t in outs(want)]
    a = work_copy(wk)
    diff = torch.zeros(calls, dtype=torch.int64, device=r.device)
    for i in range(calls):
        for t in outs(a):
            t.fill_(-1 if t.dtype == torch.int32 else float("nan"))
        ko.gmres_start(r, a)
        diff[i] = sum((bits(x) != y).sum() for x, y in zip(outs(a), want_bits))
    torch.cuda.synchronize()
    ok = int(diff.max()) == 0
    print(f"exact   {name:30s} {str(dtype):14s} every output bitwise the ordered plain's in "
          f"each of {calls} calls: {ok} ({'staged' if wk.staged else 're-read'} layout, "
          f"{wk.grid} blocks of {wk.upb} chunks)")
    if not ok:
        raise AssertionError(f"{name} differs from gmres_start_ordered_plain")


def dots_exact(name, dtype, ko, fn, vecs, sc0, wk, calls=1000):
    """A K8 reduction entry against pcg_dots_ordered_plain (the kernels'
    summation order) to the last bit of the scalars and the flag it
    writes -- pcg_dot on (p, Ap); pcg_dot2_direction on (r, z, p), and then
    also of p = z + beta p with that beta -- then ``calls`` back-to-back
    calls on one work: each writes the same bits (the written slots are NaN
    and the flag -1 before every call, p is reset), and the ticket is 0
    after them."""
    fused = len(vecs) == 3
    sums = ko.pcg_dots_ordered_plain(*(vecs[:2] + vecs[1:2] * 2 if fused else vecs))
    sc_in = sc0.clone()
    sc_in[[ko.ZZ, ko.ALPHA, ko.BETA]] = float("nan")
    flag_in = torch.full((1,), -1, dtype=torch.int32, device=sc0.device)
    want, want_flag = sc_in.clone(), flag_in.clone()
    if fused:
        want[ko.BETA] = sums[0] / want[ko.RZ]
        want[ko.RZ] = sums[0]
        want[ko.ZZ] = sums[1]
        want_flag.fill_(int(bool(sums[1] > want[ko.TOL2])))
    else:
        want[ko.ALPHA] = want[ko.RZ] / sums[0]
    bits = lambda t: t.view(torch.int64 if dtype == torch.float64 else torch.int32)
    got = torch.empty((calls, 6), dtype=dtype, device=sc0.device)
    got_flag = torch.empty((calls, 1), dtype=torch.int32, device=sc0.device)
    p = vecs[2].clone() if fused else None
    want_p = vecs[1] + want[ko.BETA] * vecs[2] if fused else None
    p_diff = torch.zeros(calls, dtype=torch.int64, device=sc0.device)
    for i in range(calls):
        wk.sc.copy_(sc_in)
        wk.flag.copy_(flag_in)
        if fused:
            p.copy_(vecs[2])
            fn(vecs[0], vecs[1], p, wk)
            p_diff[i] = (bits(p) != bits(want_p)).sum()
        else:
            fn(*vecs, wk)
        got[i].copy_(wk.sc)
        got_flag[i].copy_(wk.flag)
    torch.cuda.synchronize()
    first = torch.equal(bits(got[0, :4]), bits(want[:4])) and torch.equal(got_flag[0], want_flag)
    repeat = (torch.equal(bits(got), bits(got[:1]).expand_as(bits(got)))
              and torch.equal(got_flag, got_flag[:1].expand_as(got_flag)))
    p_ok = int(p_diff.max()) == 0
    ticket = wk.ticket.tolist()
    print(f"exact   {name:30s} {str(dtype):14s} sc[:4] and flag bitwise equal to the ordered "
          f"sums: {first}; {calls} calls repeat: {repeat}; "
          + (f"p = z + beta p to the last bit in every call: {p_ok}; " if fused else "")
          + f"ticket after them {ticket}")
    if not (first and repeat and p_ok and ticket == [0]):
        raise AssertionError(f"{name} differs from the ordered sums or does not repeat")


def probe_phase(results, launches):
    """P1/P2 through their own entry point (knpemidg_tpu_torch.probes.run,
    the counterpart of tools/profile_shapes.py's (b) and (b2)) with the
    launch counters reset, then each against the plain gather at the
    probe's shapes, exactly, in both dtypes, timed; the plain gathers are
    the library yardstick too."""
    from knpemidg_tpu_torch import _cuda, probes

    _cuda.reset_launches()
    for dtype in (torch.float32, torch.float64):
        for name, (e, ms, gbs) in probes.run(dtype, reps=20).items():
            print(f"probe   {name:9s} {str(dtype):14s} max |err| {e:.1e}, {ms:.4f} ms, "
                  f"{gbs:.1f} GB/s")
            if e != 0.0:
                raise AssertionError(f"{name} differs from the plain gather")
    torch.cuda.synchronize()
    launches["probe"] = dict(_cuda.LAUNCHES)
    missing = [k for k in PATH_KERNELS["probe"] if launches["probe"][k] == 0]
    if missing:
        raise AssertionError(f"probe kernels not launched: {missing}")
    for dtype in (torch.float32, torch.float64):
        idx1, xsrc, idx2, xs2 = probes.make_inputs(0, dtype, "cuda")
        compare("pgather", dtype, lambda: [probes.pgather(idx1, xsrc)],
                lambda: [probes.pgather_plain(idx1, xsrc)], exact, results,
                inputs=[idx1, xsrc], library_fn=lambda: probes.pgather_plain(idx1, xsrc))
        compare("pgather2", dtype, lambda: [probes.pgather2(idx2, xs2)],
                lambda: [probes.pgather2_plain(idx2, xs2)], exact, results,
                inputs=[idx2, xs2], library_fn=lambda: probes.pgather2_plain(idx2, xs2))


def abs_tables(d):
    """A table dict with every floating-point tensor replaced by |tensor|."""
    return {k: (v.abs() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
            for k, v in d.items()}


def cast_tables(d, dtype):
    return {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
            for k, v in d.items()}


def assembly_phase(S, state, results, layout):
    """The assembly kernels (K10, K11, K14) on one layout's cell axis (the
    MMS path's: its 2D shapes, alpha_sum not on it): each entry point
    against its plain version on the same inputs, at a state perturbed from
    the initial one with a seeded generator (so the upwind switch takes
    both signs and the membrane terms are nonzero), timed with its bound.
    The emit kernels must equal their plain versions exactly; the others
    are measured against each value's sum of |terms|."""
    from knpemidg_tpu_torch.ops import assembly as asm

    pair = layout == "pair"
    name = lambda k: k + SUFFIX[layout]
    p, m = S.params, S.N_ions
    def floored(scale_fn):
        """Error scales with the dtype's smallest normal number added where
        they are positive: below it a float has fewer mantissa bits, and the
        facet blocks' near-zero entries (products with E entries of ~1e-28)
        land there in float32.  A zero scale (the dummy facet, masked
        facets) stays zero: those values must be exactly equal."""
        def fn(ref):
            return [torch.where(sc > 0, sc + torch.finfo(sc.dtype).tiny, sc)
                    for sc in scale_fn(ref)]
        return fn

    gen = torch.Generator(device=state["c"].device)
    gen.manual_seed(2024)
    rand = lambda t: torch.rand(t.shape, generator=gen, device=t.device, dtype=t.dtype)
    randn = lambda t: torch.randn(t.shape, generator=gen, device=t.device, dtype=t.dtype)
    pM0, Ich0, _ = S._pads(state)
    if not float(pM0.abs().max()) > 0.0:
        # the MMS problems start from phi_M = 0: perturb around 1 (the pad
        # entry stays 0)
        pM0 = torch.ones_like(pM0)
        pM0[-1] = 0.0
    vscale = float(pM0.abs().max())
    c64 = (state["c"] * (0.99 + 0.02 * rand(state["c"]))).contiguous()
    ce64 = (state["c_elim"] * (0.99 + 0.02 * rand(state["c_elim"]))).contiguous()
    phi64 = 0.1 * vscale * randn(state["phi"])
    pM64 = pM0 * (0.9 + 0.2 * rand(pM0))
    Ich64 = 1e-2 * randn(Ich0)
    Ich64[:, -1] = 0.0
    statics64 = S._knp_static_blocks[-1]
    n_mem_facets = int(S.masks["f_mem"].sum())
    facet_tables = [k for k in asm._EMI_FACET_TABLES if not k.startswith("E_")]
    inv_Lp2 = 1.0 / S.Lp ** 2
    z_elim = float(S.ion_list[-1].z)
    print(f"shapes  {layout} assembly: {S.g['G'].shape[-1]} cells, "
          f"{S.g['f_area'].shape[0]} facets (with the dummy), {S.n_mem} membrane facets, "
          f"nq {S.g['w_f'].shape[0]}, m {m} of {len(S.ion_list)} ions")

    for dtype in (torch.float32, torch.float64):
        g, mem = cast_tables(S.g, dtype), cast_tables(S.mem_dev, dtype)
        ga, mema = abs_tables(g), abs_tables(mem)
        masks = S.masks
        zall, Dall = S.z.to(dtype), S.D.to(dtype)
        z, D = zall[:m].contiguous(), Dall[:m].contiguous()
        c, ce = c64.to(dtype), ce64.to(dtype)
        call = torch.cat([c, ce[None]])
        phi, pM, Ich = phi64.to(dtype), pM64.to(dtype), Ich64.to(dtype)
        IchK, Itot = Ich[:m], Ich.sum(dim=0)
        gt = lambda *keys: [g[k] for k in keys]

        # --- K10 -----------------------------------------------------------
        compare(name("emi_cell"), dtype,
                lambda: list(asm.emi_cell(g, zall, Dall, call, p.F, p.psi)),
                lambda: list(asm.emi_cell_plain(g, zall, Dall, call, p.F, p.psi)),
                floored(lambda ref: list(asm.emi_cell_plain(ga, zall.abs(), Dall, call.abs(), p.F,
                                                    p.psi, neg=1.0))),
                results, inputs=[zall, Dall, call] + gt("G", "vol", "phibar"))
        kappa, kbar, flux, b_cell = asm.emi_cell_plain(g, zall, Dall, call, p.F, p.psi)
        compare(name("emi_facet"), dtype,
                lambda: list(asm.emi_facet(g, masks, kappa, flux, pM, mem, p.F, p.C_phi,
                                           S.tau)),
                lambda: list(asm.emi_facet_plain(g, masks, kappa, flux, pM, mem, p.F,
                                                 p.C_phi, S.tau)),
                floored(lambda ref: list(asm.emi_facet_plain(ga, masks, kappa.abs(), flux.abs(),
                                                     pM.abs(), mema, p.F, p.C_phi, S.tau,
                                                     neg=1.0))),
                results, inputs=[kappa, flux, pM, mem["inv"], masks["f_sip"],
                                 masks["f_mem"]] + gt(*facet_tables),
                # the jump-jump tables at the membrane facets only
                extra_bytes=4 * S.nd ** 2 * n_mem_facets * kappa.element_size(),
                whole_bytes=nbytes([kappa, flux, pM, mem["inv"], masks["f_sip"],
                                    masks["f_mem"]] + gt(*asm._EMI_FACET_TABLES)))
        *M, b_p, b_m = asm.emi_facet_plain(g, masks, kappa, flux, pM, mem, p.F, p.C_phi,
                                           S.tau)
        # the emit as the step calls it: the packed slot words of the tables
        # the KNP membrane emit reads, built once, into buffers made once
        tab = asm.knp_emit_tables(g, mem)
        ebuf = asm.emi_emit_buffers(g, dtype, kbar.device, pair)
        compare(name("emi_emit_cell"), dtype,
                lambda: [t.clone() for t in asm.emi_emit_cell(
                    g, kbar, *M, b_cell, b_p, b_m, inv_Lp2, pair=pair, out=ebuf, tables=tab)],
                lambda: list(asm.emi_emit_cell_plain(g, kbar, *M, b_cell, b_p, b_m,
                                                     inv_Lp2, pair=pair)),
                exact, results,
                inputs=[kbar, b_cell, b_p, b_m, tab.slots] + gt("vol", "GG", "M0")
                + ([] if pair else M),
                timed=(lambda: asm.emi_emit_cell(g, kbar, *M, b_cell, b_p, b_m, inv_Lp2,
                                                 pair=pair, out=ebuf, tables=tab),
                       lambda: asm.emi_emit_cell_plain(g, kbar, *M, b_cell, b_p, b_m,
                                                       inv_Lp2, pair=pair)),
                graph=True)

        # --- K11 -----------------------------------------------------------
        if layout != "mms":
            compare(name("alpha_sum"), dtype, lambda: [asm.alpha_sum(zall, Dall, call)],
                    lambda: [asm.alpha_sum_plain(zall, Dall, call)],
                    floored(lambda ref: [asm.alpha_sum_plain(zall.abs(), Dall, call.abs())]),
                    results,
                    inputs=[zall, Dall, call],
                    library_fn=lambda: torch.einsum("k,kc,kic->ic", zall * zall, Dall, call))
        asum = asm.alpha_sum_plain(zall, Dall, call)
        compare(name("knp_cell"), dtype, lambda: list(asm.knp_cell(g, phi, c, p.dt)),
                lambda: list(asm.knp_cell_plain(g, phi, c, p.dt)),
                floored(lambda ref: list(asm.knp_cell_plain(ga, phi.abs(), c.abs(), p.dt))),
                results, inputs=[phi, c] + gt("G", "vol", "M0"))
        gphi, drift, b_cellK = asm.knp_cell_plain(g, phi, c, p.dt)
        un = torch.einsum("df,df->f", gphi[:, g["f_cp"]], g["f_n"])
        if not (bool((un > 0).any()) and bool((un < 0).any())):
            raise AssertionError("the perturbed state does not exercise the upwind switch")
        compare(name("knp_facet"), dtype,
                lambda: list(asm.knp_facet(g, masks, z, D, gphi, p.psi)),
                lambda: list(asm.knp_facet_plain(g, masks, z, D, gphi, p.psi)),
                floored(lambda ref: list(asm.knp_facet_plain(ga, masks, z.abs(), D, gphi.abs(),
                                                     p.psi, neg=1.0))),
                results, inputs=[gphi, D, z, masks["f_sip"]] + gt(
                    "f_cp", "f_cm", "f_n", "f_area", "E_pp", "E_pm", "E_mp", "E_mm"))
        MK = asm.knp_facet_plain(g, masks, z, D, gphi, p.psi)
        mem_args = (z, D, c, asum, phi, pM, IchK, Itot)
        bK_p, _ = asm.knp_membrane_rhs_plain(g, mem, *mem_args, p.F, p.C_M, p.dt)
        if not float(bK_p.abs().max()) > 0.0:
            raise AssertionError("the perturbed state has a zero membrane rhs")
        statics = None if pair else statics64.to(dtype)
        membrane_emit_phase(S, g, mem, ga, mema, mem_args, drift, MK, b_cellK, statics, pair,
                            dtype, results, floored, name("knp_membrane_emit"))

        # --- K14: a step's two launches (every ion's ODE-input traces in
        # one call, the finalize jump in the other), then one call of each
        # quantity on its own, checked only ---------------------------------
        fields = list(c) + [ce]
        coefs = [asm.nernst_coef(float(ion.z), p.F, p.R, p.temperature)
                 for ion in S.ion_list]

        def ln_scale(u, cf):
            # ln(p / m): |ln| plus one rounding of each trace and of the ratio
            tp_, tm_ = asm._mem_trace(g, mem, u, "p"), asm._mem_trace(g, mem, u, "m")
            return abs(cf) * torch.einsum("q,qm->m", g["w_f"],
                                          torch.log(tp_ / tm_).abs() + 3.0)

        def jump_scale():
            return (asm.membrane_avg_m_plain(ga, mema, phi.abs(), "p")
                    + asm.membrane_avg_m_plain(ga, mema, phi.abs(), "m"))

        def traces_scale(ref):
            return [torch.stack([
                torch.stack([asm.membrane_avg_m_plain(ga, mema, u.abs(), "p") for u in fields]),
                torch.stack([asm.membrane_avg_m_plain(ga, mema, u.abs(), "m") for u in fields]),
                torch.stack([ln_scale(u, cf) for u, cf in zip(fields, coefs)])]),
                jump_scale()]

        compare(name("membrane_trace"), dtype,
                lambda: [asm.membrane_traces_m(g, mem, fields, coefs),
                         asm.jump_phi_M_m(g, mem, phi)],
                lambda: [asm.membrane_traces_m_plain(g, mem, fields, coefs),
                         asm.jump_phi_M_m_plain(g, mem, phi)],
                floored(traces_scale), results,
                inputs=[mem["Rp"], mem["Rm"], mem["cp"], mem["cm"], g["w_f"]]
                + [u[:, mem[side]] for u in fields + [phi] for side in ("cp", "cm")])

        def trace_scale(ref):
            return [jump_scale(), asm.membrane_avg_m_plain(ga, mema, c[0].abs(), "p"),
                    asm.membrane_avg_m_plain(ga, mema, ce.abs(), "m"),
                    ln_scale(c[0], coefs[0])]

        compare(name("membrane_trace"), dtype,
                lambda: [asm.jump_phi_M_m(g, mem, phi), asm.membrane_avg_m(g, mem, c[0], "p"),
                         asm.membrane_avg_m(g, mem, ce, "m"),
                         asm.nernst_potential_m(g, mem, c[0], float(S.ion_list[0].z), p.F,
                                                p.R, p.temperature)],
                lambda: [asm.jump_phi_M_m_plain(g, mem, phi),
                         asm.membrane_avg_m_plain(g, mem, c[0], "p"),
                         asm.membrane_avg_m_plain(g, mem, ce, "m"),
                         asm.nernst_potential_m_plain(g, mem, c[0], float(S.ion_list[0].z),
                                                      p.F, p.R, p.temperature)],
                floored(trace_scale), results, record=False)
        rho = S.rho.to(dtype)
        compare(name("eliminated_concentration"), dtype,
                lambda: [asm.eliminated_concentration(c, z, rho, z_elim)],
                lambda: [asm.eliminated_concentration_plain(c, z, rho, z_elim)],
                floored(lambda ref: [asm.eliminated_concentration_plain(
                    c.abs(), z.abs(), rho.abs(), abs(z_elim)).abs()]),
                results, inputs=[c, z, rho],
                library_fn=lambda: -(torch.einsum("k,kic->ic", z, c) + rho[None, :]) / z_elim)


def membrane_emit_phase(S, g, mem, ga, mema, mem_args, drift, MK, b_cellK, statics, pair,
                        dtype, results, floored, row):
    """K11's one-call membrane rhs and emit (knp_membrane_emit) as the
    step calls it, with static tables built once and into buffers made
    once: the blocks and the rhs exactly the plain emit's (the rhs on the
    launch's own b_p, b_m), b_p and b_m to the plain membrane rhs (1e-5 /
    1e-12 of each value's sum of |terms|); timed beside the plain pair of
    functions, its bound from the bytes the launch reads (the static
    tables, the fields at the membrane cells) and writes."""
    from knpemidg_tpu_torch.ops import assembly as asm

    p = S.params
    z, D = mem_args[0], mem_args[1]
    M = None if pair else MK
    tab = asm.knp_emit_tables(g, mem)
    out = asm.knp_emit_buffers(g, mem, z.shape[0], dtype, z.device, pair)
    args = (g, mem, *mem_args, p.F, p.C_M, p.dt, p.psi, drift, M, b_cellK, statics)
    kernel = lambda: list(asm.knp_membrane_emit(*args, pair=pair, out=out, tables=tab))
    got = [t.clone() for t in kernel()]

    def plain():
        b_p, b_m = asm.knp_membrane_rhs_plain(g, mem, *mem_args, p.F, p.C_M, p.dt)
        return list(asm.knp_emit_cell_plain(g, mem, z, D, p.psi, drift, *(M or (None,) * 4),
                                            b_cellK, got[2], got[3], statics, pair=pair)
                    ) + [b_p, b_m]

    def scales(ref):
        abs_b = asm.knp_membrane_rhs_plain(
            ga, mema, z.abs(), D, mem_args[2].abs(), mem_args[3], mem_args[4].abs(),
            mem_args[5].abs(), mem_args[6].abs(), mem_args[7].abs(), p.F, p.C_M, p.dt,
            neg=1.0)
        return [torch.zeros_like(ref[0]), torch.zeros_like(ref[1])] + floored(
            lambda _: list(abs_b))(ref)

    c, asum, phi = mem_args[2], mem_args[3], mem_args[4]
    compare(row, dtype, kernel, plain, scales,
            results,
            inputs=[mem["Rp"], mem["Rm"], tab.mcell, tab.area, tab.slots, tab.cells, g["w_f"],
                    g["vol"], g["phibar"], z, D, drift, b_cellK] + list(mem_args[5:])
            # the fields' values at the membrane cells (a gather; D is read whole)
            + [t[..., mem[side]] for t in (c, asum, phi) for side in ("cp", "cm")]
            + ([] if pair else list(MK) + [statics]),
            timed=(kernel, lambda: asm.knp_membrane_emit_plain(*args, pair=pair)))


def small_reference_phase(layout):
    """Two f64 steps of the small EMIx fixture on the card on one layout:
    the JAX package's Krylov counts, and the port's CPU run's fields."""
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons
    from knpemidg_tpu_torch.parallel.sharding import unpad_state

    runs = {}
    for dev in ("cuda", "cpu"):
        mesh = box_3d_axons(0, length_factor=1)
        mesh.vertices *= 1e2
        S = emix.build_solver(mesh, dtype=torch.float64, device=dev,
                              pair=layout == "pair")
        st = S.solve_system_active(0.2, 0.0, emix.solver_params())
        runs[dev] = (S, unpad_state(S, st))
    Sg, sg = runs["cuda"]
    Sc, sc = runs["cpu"]
    print(f"small   {layout} cuda emi {Sg.stats.emi_niters} knp {Sg.stats.knp_niters}  "
          f"cpu emi {Sc.stats.emi_niters} knp {Sc.stats.knp_niters}")
    if (Sg.stats.emi_niters, Sg.stats.knp_niters) != REF[layout]:
        raise AssertionError(f"small-input {layout} Krylov counts differ from the reference")
    for key in ("phi", "c", "c_elim", "phi_M"):
        a, b = sg[key].cpu(), sc[key]
        r = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        print(f"small   {layout} {key:7s} rel diff cuda vs cpu {r:.3e}")
        if not r < 1e-8:
            raise AssertionError(f"small-input {layout} field {key} differs from the CPU run")


def window(S, sp, layout):
    """The protocol through the user entry point with the launch counters
    reset; asserts convergence (solve_system_active raises otherwise),
    finite fields, the step count, every kernel of the path launched, two
    K14 trace launches and one K13 launch a step, one pcg_dot2_direction
    launch per EMI iteration and (pairs) one from_pair per solve, and the AUTO Ritz rule
    (24 fields in the cell pc, none in the pair pc).  Returns (launches,
    median ms/step, median ODE ms)."""
    state, launches = run_checked(S, sp, layout)
    med, ode = report_window(S, MAIN_DTYPE, layout)
    # one fused K8 launch per PCG iteration, one from_pair (carrying its
    # add) per solve on pairs
    per_iter = launches["pcg_dot2_direction"] == launches["pcg_dot"] == sum(S.stats.emi_niters)
    per_solve = layout != "pair" or launches["from_pair"] == 2 * len(S.stats.emi_niters)
    print(f"{layout:7s} pcg_dot2_direction once per EMI iteration: {per_iter}"
          + (f"; from_pair once per solve: {per_solve}" if layout == "pair" else ""))
    if not (per_iter and per_solve):
        raise AssertionError(f"the {layout} window's K8 / K4 launches do not match its solves")
    n_ritz = ritz_fields(state)
    print(f"{layout:7s} Ritz fields in the pc: {n_ritz}")
    if n_ritz != (24 if layout == "cell" else 0):
        raise AssertionError(f"the {layout} window ran with {n_ritz} Ritz fields")
    return launches, med, ode


def run_checked(S, sp, path):
    """One protocol run through the user entry point with the launch
    counters reset first; asserts convergence (solve_system_active raises
    otherwise), finite fields, the shapes and step count, every kernel of
    ``path`` launched, two K14 trace launches and one K13 launch a step,
    and one K9 launch per Arnoldi step.  Returns (state, launches)."""
    from knpemidg_tpu_torch import _cuda

    S.stats.__init__()
    _cuda.reset_launches()
    state = S.solve_system_active(1.0, 0.0, sp)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    print(f"{path:7s} launches {launches}")
    for key in ("c", "c_elim", "phi", "phi_M", "I_ch"):
        if not bool(torch.isfinite(state[key]).all()):
            raise AssertionError(f"non-finite values in {key}")
    n_cells = getattr(S, "n_cells_pad", S.n_cells)
    if state["c"].shape != (S.N_ions, S.nd, n_cells) or len(S.stats.emi_niters) != 10:
        raise AssertionError("unexpected output shape or step count")
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")
    steps = len(S.stats.emi_niters)
    print(f"{path:7s} membrane_trace {launches['membrane_trace']} launches in {steps} steps "
          f"({TRACE_LAUNCHES_PER_STEP} a step expected)")
    if launches["membrane_trace"] != TRACE_LAUNCHES_PER_STEP * steps:
        raise AssertionError(f"the {path} window's K14 trace launches are not "
                             f"{TRACE_LAUNCHES_PER_STEP} a step")
    ode = (launches["membrane_rk4"], launches["membrane_rl"])
    want = tuple(steps * k for k in ODE_LAUNCHES_PER_STEP[path])
    print(f"{path:7s} K13 membrane_rk4 / membrane_rl launches {ode} in {steps} steps "
          f"({want} expected: one launch a step for every tag)")
    if ode != want:
        raise AssertionError(f"the {path} window's K13 launches are {ode}, not {want}")
    # K9: one step launch per Arnoldi step.  Each float64 KNP solve of these
    # windows is one restart cycle (two gmres_start launches: the cycle's
    # and the final test's; one tolerance dot), and a cycle's steps are its
    # largest per-system count
    solves = len(S.stats.knp_niters)
    arnoldi = sum(max(c) for c in S.stats.knp_niters)
    k9 = (launches["gmres_start"], launches["gmres_cgs_dot"], launches["gmres_arnoldi"])
    print(f"{path:7s} K9 gmres_start / gmres_cgs_dot / gmres_arnoldi launches {k9} for {solves} "
          f"one-cycle solves of {arnoldi} Arnoldi steps ({(2 * solves, solves, arnoldi)} "
          f"expected: one launch a step)")
    if k9 != (2 * solves, solves, arnoldi):
        raise AssertionError(f"the {path} window's K9 launches are {k9}, not one a step")
    return state, launches


def rl_window(S, sp):
    """The cell layout's float64 protocol with ode_scheme="rush_larsen":
    the neuron's points through the Rush-Larsen kernel, the glial ones
    (no gating states) through RK4; asserted as the main window.  Returns
    the launches."""
    params = S.params
    S.params = dataclasses.replace(params, ode_scheme="rush_larsen")
    try:
        _, launches = run_checked(S, sp, "rl")
    finally:
        S.params = params
    report_window(S, MAIN_DTYPE, "cell", "-rl")
    return launches


def ritz_fields(state):
    pe = state["pc"]["emi"]
    return int(pe["ritz_W"].shape[0]) if "ritz_W" in pe else 0


def report_run(S, sp, dtype, layout, variant):
    """One more protocol run on solver S, reported only: Krylov counts,
    ms/step, the Ritz fields and the set-up time before the first step
    (the pc build with any harvest)."""
    S.stats.__init__()
    t0 = time.perf_counter()
    state = S.solve_system_active(1.0, 0.0, sp)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    report_window(S, dtype, layout, variant)
    setup_s = total - sum(S.ode_walls) - sum(S.stats.step_walls)
    finite = all(bool(torch.isfinite(state[k]).all()) for k in ("c", "phi", "phi_M"))
    label = f"{layout}{'64' if dtype == MAIN_DTYPE else '32'}{variant}"
    print(f"{label:7s} {dtype} Ritz fields {ritz_fields(state)}, set-up before the first "
          f"step {setup_s:.3f} s, window total {1e3 * total:.1f} ms, fields finite: {finite}")
    return S.stats.emi_niters, S.stats.knp_niters


def f32_window(mesh, layout):
    """The protocol in float32, reported, convergence not asserted: at the
    AUTO default, and on the cell layout three runs with the device Ritz
    harvest (its float32 Lanczos is sensitive to rounding), one with the
    host float64 harvest and one with emi_ritz=0."""
    from knpemidg_tpu_torch import emix

    S = emix.build_solver(mesh, dtype=torch.float32, device="cuda",
                          pair=layout == "pair")
    runs = [("", {})] if layout == "pair" else [
        ("-r24", {}), ("-r24", {}), ("-r24", {}), ("-host", {"emi_ritz_host": True}),
        ("-r0", {"emi_ritz": 0})]
    counts = [report_run(S, emix.solver_params(error_if_not_converged=False, **over),
                         torch.float32, layout, variant) for variant, over in runs]
    if layout == "cell":
        # no kernel uses floating-point atomics: the device-harvest runs repeat
        print(f"cell32  the three -r24 runs' counts repeat: {counts[0] == counts[1] == counts[2]}")
        if not counts[0] == counts[1] == counts[2]:
            raise AssertionError("float32 Krylov counts differ between identical runs")


# launches of a kernel in one of its timed calls (one per system of the
# step: EMI and KNP; the 2D rows: EMI and each of the two ions;
# membrane_trace: a step's ODE-input traces and its finalize jump); 1
# where not listed (K13: one launch for both tags).  A
# launch here and in the rank lines is a counted wrapper call: knp_facet's
# one is its two kernels, the scalars and the sweep
LAUNCHES_PER_TIMING = {k: 2 for k in (
    "bell_matvec", "block_jacobi_inverse", "block_jacobi_apply",
    "pair_matvec", "to_pair", "from_pair", "gather_blocks_pair",
    "block_jacobi_inverse_nd8", "block_jacobi_apply_nd8", "membrane_trace",
    "membrane_trace_pair", "membrane_trace_nd3")}
LAUNCHES_PER_TIMING.update({k: 3 for k in (
    "bell_matvec_nd3", "block_jacobi_inverse_nd3", "block_jacobi_apply_nd3")})
# K14 launches a step: every ion's ODE-input traces in one, the jump in one
TRACE_LAUNCHES_PER_STEP = 2


# ---------------------------------------------------------------------------
# the MMS verification path
# ---------------------------------------------------------------------------

def mms_solver(res, dt, kind, device="cuda"):
    """An MMS solver on mms_square(res) through the user entry points (the
    card unless ``device`` names another), set up for solve_system_passive,
    and its problem: the space (``kind`` "space") or time manufactured
    solution of the JAX package's nightly tests."""
    from knpemidg_tpu_torch.config import Ion, PhysicalParams
    from knpemidg_tpu_torch.mesh.generators import mms_square
    from knpemidg_tpu_torch.mms.problems import setup_mms_space, setup_mms_time
    from knpemidg_tpu_torch.solver import Solver

    import sympy  # noqa: F401  (the MMS problems are derived with sympy: fail here without it)

    C_phi = 1.0 / dt
    mms = (setup_mms_space if kind == "space" else setup_mms_time)({
        "F": 1.0, "R": 1.0, "temperature": 1.0, "C_phi": C_phi,
        "z": [MMS_Z[n] for n in "abc"], "D": [MMS_D_SUB[n] for n in "abc"],
        "C": [MMS_C_SUB[n] for n in "abc"]})
    params = PhysicalParams(dt=dt, F=1.0, R=1.0, temperature=1.0, C_M=1.0, C_phi=C_phi,
                            phi_M_init=0.0, phi_M_init_type="constant",
                            rho_sub={0: 0.0, 1: 0.0})
    ions = [Ion(name=n, z=MMS_Z[n], D_sub=MMS_D_SUB[n],
                c_init_sub={s: mms.init_c[k][s] for s in (0, 1)},
                c_init_sub_type="expression", C_sub=MMS_C_SUB[n])
            for k, n in enumerate("abc")]
    kw = {} if device == "cuda" else {"device": device}
    S = Solver(params, ions, mms=mms, **kw)
    S.setup_domain(mms_square(res))
    S.setup_parameters()
    S.setup_FEM_spaces()
    return S, mms


def mms_params_direct():
    from knpemidg_tpu_torch.config import SolverParams

    return SolverParams(direct_emi=True, direct_knp=True)


def mms_params_iterative():
    """tests/test_mms_iterative.py's SolverParams."""
    from knpemidg_tpu_torch.config import SolverParams

    return SolverParams(direct_emi=False, direct_knp=False, rtol_emi=1e-13, atol_emi=0.0,
                        rtol_knp=1e-12, atol_knp=0.0, max_it_emi=50000, max_it_knp=5000,
                        gmres_restart=40)


def mms_errors(S, mms, state, T=None):
    """The L2 errors of a, b, c and the mean-shifted phi (the nightly tests'
    norms, on the host)."""
    from knpemidg_tpu_torch.fem.norms import integral, l2_error

    mesh = S.mesh
    ex = (lambda f: f) if T is None else (lambda f: (lambda x: f(x, T)))
    c = state["c"].cpu().numpy().transpose(0, 2, 1)
    fields = [c[0], c[1], state["c_elim"].cpu().numpy().T]
    errs = {}
    for k, (name, u) in enumerate(zip("abc", fields)):
        errs[name] = float(np.sqrt(sum(
            l2_error(mesh, u, ex(mms.exact_c[k][s]), subdomain=s) ** 2 for s in (0, 1))))
    phi = state["phi"].cpu().numpy().T
    shift = sum(integral(mesh, ex(mms.exact_phi[s]), subdomain=s)
                for s in (0, 1)) - integral(mesh, phi)
    errs["phi"] = float(np.sqrt(sum(
        l2_error(mesh, phi, ex(mms.exact_phi[s]), subdomain=s, shift=-shift) ** 2
        for s in (0, 1))))
    return errs


def mms_rates(xs, errs, key):
    es = np.array([e[key] for e in errs])
    return np.log(es[1:] / es[:-1]) / np.log(np.array(xs[1:]) / np.array(xs[:-1]))


def mms_check_errors(label, errs, ref):
    """The card's errors against the JAX package's CPU ones, rel MMS_ERROR_TOL."""
    worst = max(abs(errs[k] - ref[k]) / ref[k] for k in ref)
    print(f"mms     {label}: max rel diff of the errors from the JAX package's "
          f"{worst:.3e} (tol {MMS_ERROR_TOL:.0e}) {'ok' if worst <= MMS_ERROR_TOL else 'FAIL'}")
    if not worst <= MMS_ERROR_TOL:
        raise AssertionError(f"MMS {label}: errors differ from the JAX package's")


def mms_kernel_phase(results):
    """The 2D rows at the MMS path's largest shapes, mms_square(7)'s (32,768
    triangles): K1 at nd = 3, K = 4, K5 and K6 at nd = 3 on the EMI operator
    and each ion's KNP operator of the space problem at the initial state,
    their rhs, the EMI apply's two-level operands (As, compartment
    one-hots) as make_two_level builds them, K6 also checked on a KNP ion's
    operands (no fields, no As); then K10, K11 and K14 (assembly_phase) on
    that solver's cell axis, and K8 and K9 (krylov_phase) at its EMI vector
    and one KNP system of n = 3 x 32,768."""
    from knpemidg_tpu_torch.ops import coarse, spmv
    from knpemidg_tpu_torch.solvers.twolevel import build_two_level

    S, _ = mms_solver(MMS_SPACE_RES[-1], MMS_DT_SPACE, "space")
    S.splitting_scheme = False
    sp = mms_params_direct()
    st = S.attach_pc(S._initial_state(0.0), sp)
    pM, _, It = S._pads(st)
    blocks, rhs, Pd = S._assemble_emi(st["c"], st["c_elim"], pM, It, st["t"])
    blocksK, rhsK = S._knp_assemble_mms(st["c"], st["phi"], st["t"])
    nbr = S.g["nbr"]
    oh, ids = S._comp_arrays()
    print(f"shapes  mms: EMI blocks {tuple(blocks.shape)}  KNP blocks {tuple(blocksK.shape)}  "
          f"{S.n_mem} membrane facets")
    for dtype in (torch.float32, torch.float64):
        B, x = blocks.to(dtype), rhs.to(dtype)
        BK, xK = blocksK.to(dtype), rhsK.to(dtype)
        systems = [(B, x)] + [(BK[k], xK[k]) for k in range(BK.shape[0])]
        cells = lambda v: v.t().reshape(-1)
        lib = bsr_library("bell_matvec_nd3", dtype, [
            (lambda B_=B_: bell_bsr(B_, nbr), cells(v), cells(spmv.bell_matvec_plain(B_, nbr, v)))
            for B_, v in systems])
        compare("bell_matvec_nd3", dtype,
                lambda: [spmv.bell_matvec(B_, nbr, v) for B_, v in systems],
                lambda: [spmv.bell_matvec_plain(B_, nbr, v) for B_, v in systems],
                lambda ref: [spmv.bell_matvec_plain(B_.abs(), nbr, v.abs())
                             for B_, v in systems], results,
                inputs=[t for B_, v in systems for t in (B_, nbr, v)],
                flops=sum(2.0 * B_.numel() for B_, _ in systems), library_fn=lib, graph=True)
        Ps = [Pd.to(dtype).contiguous()] + [BK[k, 0].contiguous() for k in range(BK.shape[0])]
        compare("block_jacobi_inverse_nd3", dtype,
                lambda: [spmv.block_jacobi_inverse(P) for P in Ps],
                lambda: [spmv.block_jacobi_inverse_plain(P) for P in Ps],
                lambda ref: [inv_scale(P, i) for P, i in zip(Ps, ref)], results, inputs=Ps,
                flops=sum(bj_inv_flops(P) for P in Ps),
                library_fn=lambda: [lib_inv(P) for P in Ps], graph=True)
        invs = [spmv.block_jacobi_inverse(P) for P in Ps]
        ops = [spmv.block_jacobi_operands(i) for i in invs]
        vs = [v for _, v in systems]
        compare("block_jacobi_apply_nd3", dtype,
                lambda: [spmv.block_jacobi_apply(op, v) for op, v in zip(ops, vs)],
                lambda: [spmv.block_jacobi_apply_plain(i, v) for i, v in zip(invs, vs)],
                lambda ref: [spmv.block_jacobi_apply_plain(i.abs(), v.abs())
                             for i, v in zip(invs, vs)], results,
                inputs=invs + vs, flops=sum(bj_apply_flops(i) for i in invs),
                library_fn=lambda: [lib_apply(i, v) for i, v in zip(invs, vs)], graph=True)
        emi = build_two_level(B, nbr, AGG, sym=True, comp_onehot=oh.to(dtype), comp_ids=ids,
                              extra_diag=Ps[0] - B[0], ridge=1e-5)
        coarse_phase("mms", coarse.operands(emi, AGG, batched=False), x[None], results)
        knp = build_two_level(BK[0], nbr, AGG, sym=False,
                              mass_diag=(S.g["vol"] / S.params.dt).to(dtype), ridge=1e-5)
        coarse_phase("mms", coarse.operands(knp, AGG, batched=False), xK[0][None].contiguous(),
                     results, record=False)
    assembly_phase(S, st, results, "mms")
    krylov_phase(S, results, "mms")


def mms_space_phase():
    """The space table: res 2-7, two direct steps of dt 1e-10; the
    nightly gate (the mean of the last three rates of a, b, c and phi above
    1.85) and the errors at res 2-5 against the JAX package's."""
    hs, errs = [], []
    for res in MMS_SPACE_RES:
        t0 = time.perf_counter()
        S, mms = mms_solver(res, MMS_DT_SPACE, "space")
        st = S.solve_system_passive(2 * MMS_DT_SPACE, 0.0, mms_params_direct())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hs.append(S.mesh.hmin())
        errs.append(mms_errors(S, mms, st))
        print(f"mms     space res {res}: {S.n_cells} cells, " + "  ".join(
            f"{k} {v:.6e}" for k, v in errs[-1].items()) + f"  ({wall:.2f} s)")
        if res in MMS_SPACE_ERRORS:
            mms_check_errors(f"space res {res}", errs[-1], MMS_SPACE_ERRORS[res])
    for key in ("a", "b", "c", "phi"):
        rs = mms_rates(hs, errs, key)
        gate = float(rs[-3:].mean())
        print(f"mms     space rates {key}: {np.array2string(rs, precision=4)}  mean of the "
              f"last three {gate:.4f} (gate > 1.85)")
        if not gate > 1.85:
            raise AssertionError(f"MMS space rates of {key} fail the gate")


def mms_time_phase():
    """The time table: res 4, dt = 1e-2 / 2^i for i = 1..7 to Tstop 2e-2,
    direct; the nightly gate (the mean of the first four rates of a, b, c
    above 0.9) and every dt's errors against the JAX package's."""
    dts, errs = [], []
    for i in range(1, MMS_TIME_HALVINGS + 1):
        dt = 1e-2 / 2 ** i
        t0 = time.perf_counter()
        S, mms = mms_solver(MMS_TIME_RES, dt, "time")
        st = S.solve_system_passive(MMS_TSTOP, 0.0, mms_params_direct())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        T = float(st["t"])
        if abs(T - MMS_TSTOP) > 1e-12:
            raise AssertionError(f"MMS time run ended at t = {T}")
        dts.append(dt)
        errs.append(mms_errors(S, mms, st, T))
        print(f"mms     time dt {dt:.4e} ({len(S.stats.emi_niters)} steps): " + "  ".join(
            f"{k} {v:.6e}" for k, v in errs[-1].items()) + f"  ({wall:.2f} s)")
        mms_check_errors(f"time dt 1e-2/2^{i}", errs[-1], MMS_TIME_ERRORS[i])
    for key in ("a", "b", "c"):
        rs = mms_rates(dts, errs, key)
        gate = float(rs[:4].mean())
        print(f"mms     time rates {key}: {np.array2string(rs, precision=4)}  mean of the "
              f"first four {gate:.4f} (gate > 0.9)")
        if not gate > 0.9:
            raise AssertionError(f"MMS time rates of {key} fail the gate")


def mms_iterative_phase():
    """The iterative path at res 3 and 5 (the launch counters reset before
    the first iterative run, read after the last): each against its direct
    run (c to atol 1e-8, the mean-shifted phi to 1e-4), its counts beside
    the JAX package's and equal to the card's recorded ones, every kernel
    of the path launched.  Returns the launches."""
    from knpemidg_tpu_torch import _cuda

    direct = {}
    for res in MMS_ITER_RES:
        S, _ = mms_solver(res, MMS_DT_SPACE, "space")
        direct[res] = S.solve_system_passive(2 * MMS_DT_SPACE, 0.0, mms_params_direct())
    torch.cuda.synchronize()
    _cuda.reset_launches()
    counts = {}
    for res in MMS_ITER_RES:
        t0 = time.perf_counter()
        S, _ = mms_solver(res, MMS_DT_SPACE, "space")
        st = S.solve_system_passive(2 * MMS_DT_SPACE, 0.0, mms_params_iterative())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ref = direct[res]
        dc = float((st["c"] - ref["c"]).abs().max())
        dphi = float(((st["phi"] - st["phi"].mean()) - (ref["phi"] - ref["phi"].mean()))
                     .abs().max())
        counts[res] = (S.stats.emi_niters, S.stats.knp_niters)
        print(f"mms     iterative res {res}: {S.n_cells} cells, EMI {counts[res][0]} KNP "
              f"{counts[res][1]} (the JAX package on the CPU: EMI {MMS_JAX_COUNTS[res][0]} "
              f"KNP {MMS_JAX_COUNTS[res][1]}), {wall:.2f} s, {sum(counts[res][0])} PCG "
              f"iterations: {1e3 * wall / max(1, sum(counts[res][0])):.4f} ms an iteration "
              f"with the set-up and the assemblies; |c - direct| {dc:.3e} (tol 1e-8), "
              f"|phi - direct| {dphi:.3e} (tol 1e-4)")
        if not (dc < 1e-8 and dphi < 1e-4):
            raise AssertionError(f"MMS iterative res {res} disagrees with the direct solve")
        if counts[res] != MMS_COUNTS[res]:
            raise AssertionError(f"MMS iterative res {res} counts {counts[res]} differ from "
                                 f"the recorded {MMS_COUNTS[res]}")
    launches = dict(_cuda.LAUNCHES)
    print(f"mms     launches {launches}")
    missing = [k for k in PATH_KERNELS["mms"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the mms path: {missing}")
    if launches["alpha_sum"] or launches["bell_matvec"] or launches["two_level_coarse"]:
        raise AssertionError("the mms path launched a kernel of the 3D paths")
    return launches


def mms_phase(results):
    """The MMS verification path: its 2D kernel rows, the space and time
    tables and the iterative runs.  Returns the iterative runs' launches."""
    t0 = time.perf_counter()
    mms_kernel_phase(results)
    mms_space_phase()
    mms_time_phase()
    launches = mms_iterative_phase()
    print(f"mms     phase {time.perf_counter() - t0:.1f} s")
    return launches


def rank_kernels(results, launches_of=None):
    """The redesign order: first every kernel slower than its library call
    in either dtype, the largest ratio first; then the rest by launches in
    their window times (ms - bound ms) per launch, float64."""
    slower, rest = [], []
    for name, (_, _, path, *_) in KERNELS.items():
        ratios = [(r["ms"] / r["library_ms"], dt) for dt, r in results[name].items()
                  if r["library_ms"]]
        worst = max(ratios, default=(0.0, None))
        if worst[0] > 1.0:
            slower.append((worst[0], name, worst[1]))
        else:
            r = results[name][MAIN_DTYPE]
            n = (launches_of or {}).get(name, 0)
            per = LAUNCHES_PER_TIMING.get(name, 1)
            rest.append((n * (r["ms"] - r["bound_ms"]) / per, name, n))
    for ratio, name, dt in sorted(slower, reverse=True):
        r = results[name][dt]
        print(f"rank    slower than library: {name:32s} {str(dt):14s} kernel {r['ms']:.4f} ms "
              f"library {r['library_ms']:.4f} ms ({ratio:.2f}x)")
    for cost, name, n in sorted(rest, reverse=True):
        print(f"rank    launches x (ms - bound): {name:32s} {n:4d} x -> {cost:.3f} ms")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is False")
    from knpemidg_tpu_torch import _cuda, emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    t_start = time.perf_counter()
    card = gpu_line()
    print(f"gpu     {card}")
    print(f"torch   {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    build_s = _cuda.build()
    _cuda.lib()
    print(f"build   {build_s:.2f} s compiling ({time.perf_counter() - t0:.2f} s incl. load)")

    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2          # m -> cm (EMIx units)
    sp = emix.solver_params()
    results, launches, walls = {}, {}, {}
    for layout in ("cell", "pair"):
        t0 = time.perf_counter()
        S = emix.build_solver(mesh, dtype=MAIN_DTYPE, device="cuda", pair=layout == "pair")
        extra = (f", {S.pairs['int_f'].shape[0]} pairs, {S.n_cells_pad} padded cells"
                 if layout == "pair" else "")
        print(f"setup   {layout}: {S.n_cells} cells, {S.n_mem} membrane points{extra}, "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        state0 = S.attach_pc(S._initial_state(0.0), sp)
        torch.cuda.synchronize()
        print(f"pc      {layout} built in {time.perf_counter() - t0:.2f} s")
        (kernel_phase if layout == "cell" else pair_kernel_phase)(S, state0, results)
        assembly_phase(S, state0, results, layout)
        krylov_phase(S, results, layout)
        small_reference_phase(layout)
        launches[layout], med, ode = window(S, sp, layout)
        walls[layout] = (med, ode)
        if layout == "cell":
            report_run(S, emix.solver_params(emi_ritz=0), MAIN_DTYPE, "cell", "-r0")
            launches["rl"] = rl_window(S, sp)
        del S, state0
        f32_window(mesh, layout)
        torch.cuda.empty_cache()
    probe_phase(results, launches)
    launches["mms"] = mms_phase(results)
    print(f"layouts float64 median ms/step: cell {walls['cell'][0]:.2f}, pair "
          f"{walls['pair'][0]:.2f}; ODE {walls['cell'][1]:.2f} / {walls['pair'][1]:.2f}")

    kernels = []
    launches_of = {name: launches[path][counter(name)]
                   for name, (_, _, path, *_) in KERNELS.items()}
    for name, (src, repl, path, *_) in KERNELS.items():
        r = results[name][MAIN_DTYPE]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[path][counter(name)],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "device_us": r["device_us"]})
    rank_kernels(results, launches_of)
    print(f"total   {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
