"""Phase profile of the port's splitting step on one CUDA card.

Sets up the EMIx solver on box_3d_axons(1, length_factor=2) scaled to cm
(124,416 tets, the cell of ``chip_smoke.py``) at emix.solver_params() (AUTO
Ritz: 24 fields on the cell layout) on the cell layout, or with ``--pair``
on the interleaved pair layout; times the preconditioner build (with the
Ritz harvest), runs WARMUP steps, then profiles
STEPS steady steps (``run_block``) twice:

1. phases: a device synchronise and the host clock around each of the six
   phases of a step (ODE, EMI assembly, EMI solve, KNP assembly, KNP solve,
   finalize), in ms per step;
2. trace: the same number of steps under ``torch.profiler`` with one
   synchronise at the end: the wall, the device busy time (the union of the
   device kernel intervals), the number of device events and of
   aten::copy_ calls, and the operators with the most device time, each as
   a share of the busy time
   (an aten operator's row holds the kernels it launched, which also have
   rows of their own, so the shares add up to more than 1), and the
   device time per launch of each hand-written kernel (csrc/), with the
   two-level restrict, reduce and prolong kernels also split into K6's
   (the EMI apply, one system) and K7's (the KNP apply, one system per
   ion) by the grid's y extent in the exported trace.  The profiler's own
   cost is in the wall, so the busy share it gives is a lower bound;
3. census: one more step with every aten operator call counted per phase
   (a dispatch mode, so nothing is timed here): the calls a phase makes
   beside its hand-written kernels, how many of them are matrix products
   (bmm / mm, which is what an einsum lowers to), how many read a
   value back to the host (``_local_scalar_dense``: ``bool``, ``int``,
   ``float`` or ``item`` of a device tensor), and how many are
   ``aten::mul`` (the pair layout's live mask is applied inside the
   two-level prolong kernels, not by a multiplication).

Usage (needs a CUDA card):

    python -m knpemidg_tpu_torch.profile_step [--dtype float64|float32]
        [--pair] [--json FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from . import emix
from .mesh.generators import box_3d_axons

WARMUP, STEPS = 3, 3     # steps before the profile, steps per profile
TOP = 12                 # operators listed by device time
# the __global__ functions of csrc/, as the profiler names their launches
HAND_KERNELS = ("bell_matvec_kernel", "bj_inverse_kernel", "bj_inverse_halves_kernel",
                "bj_apply_kernel",
                "membrane_step_kernel", "pair_matvec_kernel", "to_pair_kernel",
                "from_pair_kernel", "pair_emit_kernel",
                "tl_restrict_kernel", "tl_reduce_kernel", "tl_solve_kernel",
                "tl_prolong_kernel", "tl_coarse_kernel",
                "emi_cell_kernel", "emi_facet_kernel", "emi_emit_cell_kernel",
                "alpha_sum_kernel", "ion_cell_kernel", "ion_facet_scalars_kernel",
                "ion_facet_kernel", "ion_membrane_emit_kernel", "ion_membrane_emit_rows_kernel",
                "membrane_trace_kernel", "eliminated_kernel",
                "gm_dot_kernel", "gm_arnoldi_kernel",
                "gm_start_kernel", "gm_backsolve_kernel",
                "gm_xupdate_kernel", "pcg_dot_kernel",
                "pcg_update_kernel", "pcg_dot2_direction_kernel",
                "bi_start_kernel", "bi_alpha_kernel", "bi_omega_kernel")
PHASES = ("_ode_step", "_assemble_emi", "_emi_solve_iterative",
          "_knp_assemble_all", "_knp_solve_all", "_finalize_step")


def _timed_phases(S, walls):
    """Wrap the six phase methods of solver ``S`` (instance attributes) so
    each call ends in a synchronise and appends its ms to walls[name]."""
    for name in PHASES:
        fn = getattr(S, name)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            walls[_name].append(1e3 * (time.perf_counter() - t0))
            return out

        setattr(S, name, wrapped)


def _untimed(S):
    for name in PHASES:
        delattr(S, name)


def _op_census(S, state, sp):
    """One step with the aten operator calls of each phase counted:
    {phase: {"aten_ops": n, "matrix_products": n, "host_reads": n,
    "muls": n}}."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {name: {"aten_ops": 0, "matrix_products": 0, "host_reads": 0, "muls": 0}
              for name in PHASES}

    class Count(TorchDispatchMode):
        def __init__(self, slot):
            super().__init__()
            self.slot = slot

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.slot["aten_ops"] += 1
            op = func.__name__.split(".")[0]
            if op in ("bmm", "mm", "addmm", "baddbmm", "einsum"):
                self.slot["matrix_products"] += 1
            elif op == "_local_scalar_dense":
                self.slot["host_reads"] += 1
            elif op == "mul":
                self.slot["muls"] += 1
            return func(*args, **(kwargs or {}))

    for name in PHASES:
        fn = getattr(S, name)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            with Count(counts[_name]):
                return _fn(*args, **kw)

        setattr(S, name, wrapped)
    _, st = S.run_block(state, sp, 1)
    _untimed(S)
    torch.cuda.synchronize()
    return counts, {"emi_iters": st["emi_iters"], "knp_iters": st["knp_iters"]}


def _device_events(prof):
    """Device (kernel, memcpy, memset) events of a finished profile as
    (start_us, end_us) intervals."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == cuda]


def _union_us(intervals):
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


# the two-level kernels whose grid's y extent is the system count m
SPLIT_KERNELS = ("tl_restrict_kernel", "tl_reduce_kernel", "tl_prolong_kernel")


def _coarse_split(prof):
    """{"K6 <kernel>" or "K7 <kernel>": {"calls", "device_us_per_call"}} of
    the SPLIT_KERNELS launches in a finished profile, K6 where the grid's y
    extent is 1 (the EMI apply), K7 otherwise (one system per ion), read
    from the exported trace's kernel events; None when they carry no
    grid."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    durs = {}
    for e in events:
        kern = next((k for k in SPLIT_KERNELS if k in e.get("name", "")), None)
        if e.get("cat") != "kernel" or kern is None:
            continue
        grid = (e.get("args") or {}).get("grid")
        if not grid:
            return None
        durs.setdefault(f"{'K6' if grid[1] == 1 else 'K7'} {kern}", []).append(float(e["dur"]))
    return {k: {"calls": len(v), "device_us_per_call": sum(v) / len(v)}
            for k, v in sorted(durs.items())}


def _self_device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def profile(dtype=torch.float64, pair=False):
    """Set up the cell (on the pair layout with ``pair``), warm up, and
    return the phase and trace readings as a dict (times in ms)."""
    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2
    S = emix.build_solver(mesh, dtype=dtype, device="cuda", pair=pair)
    sp = emix.solver_params(error_if_not_converged=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = S.attach_pc(S._initial_state(0.0), sp)      # with the Ritz harvest
    torch.cuda.synchronize()
    pc_ms = 1e3 * (time.perf_counter() - t0)
    state = S._ode_step(state, first_step=True)       # the first-step V seed
    state, _ = S._pde_step(state, sp)
    state, _ = S.run_block(state, sp, WARMUP - 1)
    torch.cuda.synchronize()

    walls = {name: [] for name in PHASES}
    _timed_phases(S, walls)
    state, st_phase = S.run_block(state, sp, STEPS)
    _untimed(S)

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, st_trace = S.run_block(state, sp, STEPS)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    census, census_iters = _op_census(S, state, sp)
    dev = _device_events(prof)
    # None when the profiler saw no device activity (not measured)
    busy_ms = 1e-3 * _union_us(dev) if dev else None
    ops = sorted(prof.key_averages(), key=_self_device_us, reverse=True)
    hand = [{"name": e.key, "calls": e.count,
             "device_us_per_call": _self_device_us(e) / max(e.count, 1)}
            for e in ops if any(k in e.key for k in HAND_KERNELS)]
    split = _coarse_split(prof)
    return {
        "cells": S.n_cells, "layout": "pair" if pair else "cell",
        "dtype": str(dtype), "warmup": WARMUP, "steps": STEPS, "pc_build_ms": pc_ms,
        "ritz_fields": int(state["pc"]["emi"]["ritz_W"].shape[0])
        if "ritz_W" in state["pc"]["emi"] else 0,
        "phases": {"emi_iters": st_phase["emi_iters"],
                   "knp_iters": st_phase["knp_iters"],
                   "ms": {name.strip("_"): walls[name] for name in PHASES}},
        "census": {name.strip("_"): census[name] for name in PHASES},
        "census_iters": census_iters,
        "trace": {"emi_iters": st_trace["emi_iters"],
                  "knp_iters": st_trace["knp_iters"],
                  "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                  "device_busy_share": None if busy_ms is None else busy_ms / wall_ms,
                  "device_events": len(dev),
                  "copy_calls": sum(e.count for e in ops if e.key == "aten::copy_"),
                  "top_ops": [{"name": e.key, "self_device_ms": 1e-3 * _self_device_us(e),
                               "share": (None if busy_ms is None else
                                         1e-3 * _self_device_us(e) / busy_ms),
                               "calls": e.count} for e in ops[:TOP]],
                  "hand_kernels": hand, "coarse_split": split},
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    ap.add_argument("--pair", action="store_true",
                    help="profile the interleaved pair layout")
    ap.add_argument("--json", help="also write the readings to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    out = profile(getattr(torch, args.dtype), pair=args.pair)
    print(f"{out['cells']} cells, {out['layout']} layout, {out['dtype']}, steps {WARMUP + 1}-"
          f"{WARMUP + STEPS} phased, the next {STEPS} traced")
    print(f"pc build {out['pc_build_ms']:.1f} ms with {out['ritz_fields']} Ritz fields")
    ph = out["phases"]
    print(f"phases  EMI iters {ph['emi_iters']}  KNP iters {ph['knp_iters']}")
    for name, ms in ph["ms"].items():
        print(f"  {name:22s} " + " ".join(f"{v:8.3f}" for v in ms) + "  ms")
    print(f"aten operator calls per phase in one step (EMI iters "
          f"{out['census_iters']['emi_iters']}, KNP iters {out['census_iters']['knp_iters']}; "
          f"matrix products, host reads, aten::mul among them):")
    for name, cnt in out["census"].items():
        print(f"  {name:22s} {cnt['aten_ops']:6d} ({cnt['matrix_products']}, "
              f"{cnt['host_reads']}, {cnt['muls']})")
    tr = out["trace"]
    print(f"trace   EMI iters {tr['emi_iters']}  KNP iters {tr['knp_iters']}")
    busy = ("device busy not measured (no device events in the trace)"
            if tr["device_busy_ms"] is None else
            f"device busy {tr['device_busy_ms']:.3f} ms "
            f"({100 * tr['device_busy_share']:.1f}%)")
    print(f"  wall {tr['wall_ms']:.3f} ms, {busy}, {tr['device_events']} device events, "
          f"{tr['copy_calls']} aten::copy_ calls")
    for op in tr["top_ops"]:
        share = "" if op["share"] is None else f"{100 * op['share']:5.1f}%"
        print(f"  {op['self_device_ms']:9.3f} ms {share:>6s} {op['calls']:6d}x  "
              f"{op['name'][:90]}")
    print("hand-written kernels, device time per launch in the trace:")
    for k in tr["hand_kernels"]:
        print(f"  {k['device_us_per_call']:9.2f} us {k['calls']:6d}x  {k['name'][:90]}")
    split = tr["coarse_split"]
    print("two-level kernels by apply, device time per launch in the trace:"
          + (" not measured (no grid in the trace)" if split is None else ""))
    for name, k in (split or {}).items():
        print(f"  {k['device_us_per_call']:9.2f} us {k['calls']:6d}x  {name}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
