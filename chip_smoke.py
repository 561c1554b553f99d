#!/usr/bin/env python3
"""Smoke run of knpemidg_tpu_torch on one NVIDIA GPU.

Drives the port's main path -- StandardSolver setup, then
solve_system_active over the 10-step reference protocol (Tstop 1 ms,
dt 0.1 ms) -- on the 124,416-tet box_3d_axons(1, length_factor=2) mesh
(scaled to cm) with the EMIx physics.  On the way it:

  1. requires a CUDA card and prints its name and power limit;
  2. builds the CUDA kernels from csrc/ and prints the build seconds;
  3. compares every kernel with its plain torch version at the main
     path's shapes, in float32 and float64, and times both;
  4. checks the result on a small input against the reference iteration
     counts of the JAX package and the port's own CPU run;
  5. runs the protocol in float64 with every launch counter reset first,
     and fails unless every solve converged, the fields are finite and
     every kernel was launched;
  6. runs the same protocol in float32 and reports its Krylov counts and
     whether each solve converged.  At the production tolerances the
     float32 EMI solve can stall at the iteration cap on this mesh (so can
     the JAX package's float32 program on the CPU), so this phase reports
     and does not assert convergence.

Usage:  python3 chip_smoke.py      (exits non-zero on any failure)
The last line is {"ok": true, "device": {...}}; the line before it the
per-kernel JSON summary.
"""
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
# matvec and the block-Jacobi apply, |P^-1| |P| |P^-1| for the inverse, and
# each state's / parameter's own size for the ODE step (ode_scale).
# float32: sums in another order and fused multiply-adds change the last
# bits, and the 100-evaluation ODE step carries them through the stiff
# gating dynamics.
TOL = {torch.float32: {"bell_matvec": 1e-5, "block_jacobi_apply": 1e-5,
                       "block_jacobi_inverse": 1e-5, "membrane_rk4": 1e-4},
       torch.float64: {"bell_matvec": 1e-12, "block_jacobi_apply": 1e-12,
                       "block_jacobi_inverse": 1e-12, "membrane_rk4": 1e-12}}
# dtype of the asserted protocol run: float64 converges in a few Krylov
# iterations per step; float32 at the same tolerances can stall (step 6)
MAIN_DTYPE = torch.float64
# the small-input reference: box_3d_axons(0, 1) x 1e2, EMIx setup, f64,
# two steps (counts of the JAX package, tests/test_torch_slice.py)
REF_EMI = [7, 4]
REF_KNP = [[4, 3], [2, 2]]

KERNELS = {
    "bell_matvec": ("knpemidg_tpu_torch/csrc/bell_matvec.cu",
                    "knpemidg_tpu/ops/spmv.py:17"),
    "block_jacobi_inverse": ("knpemidg_tpu_torch/csrc/block_jacobi.cu",
                             "knpemidg_tpu/ops/spmv.py:102"),
    "block_jacobi_apply": ("knpemidg_tpu_torch/csrc/block_jacobi.cu",
                           "knpemidg_tpu/ops/spmv.py:131"),
    "membrane_rk4": ("knpemidg_tpu_torch/csrc/membrane_rk4.cu",
                     "knpemidg_tpu/membrane/engine.py:93"),
}


def report_window(S, dtype):
    """Print the per-step Krylov counts and walls of a finished
    solve_system_active run."""
    steps_ms = [1e3 * (a + b) for a, b in zip(S.ode_walls, S.stats.step_walls)]
    tag = "run" if dtype == MAIN_DTYPE else "f32"
    print(f"{tag:7s} {dtype} emi iters {S.stats.emi_niters}")
    print(f"{tag:7s} {dtype} knp iters {S.stats.knp_niters}")
    print(f"{tag:7s} {dtype} ms/step {[round(v, 2) for v in steps_ms]}")
    print(f"{tag:7s} {dtype} median {statistics.median(steps_ms):.2f} ms/step "
          f"(ODE median {1e3 * statistics.median(S.ode_walls):.2f} ms)")


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


def err(got, ref, scale):
    """(max |got - ref|, max |got - ref| / scale) over the elements."""
    d = (got.double() - ref.double()).abs()
    scale = scale.double().expand_as(d)
    rel = torch.where(scale > 0, d / torch.where(scale > 0, scale, 1.0),
                      torch.where(d > 0, torch.inf, 0.0))
    return float(d.max()), float(rel.max())


def compare(name, dtype, kernel_fn, plain_fn, scale_fn, results):
    """Check one kernel against its plain version; record the error and
    both times per dtype.  kernel_fn/plain_fn return a list of tensors,
    scale_fn maps the plain outputs to the error scales (see TOL)."""
    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    errs = [err(a, b, sc) for a, b, sc in zip(got, ref, scale_fn(ref))]
    abs_e, rel_e = max(e[0] for e in errs), max(e[1] for e in errs)
    ok = bool(np.isfinite(rel_e)) and rel_e <= TOL[dtype][name]
    print(f"compare {name:22s} {str(dtype):14s} max_abs_err {abs_e:.3e} "
          f"rel {rel_e:.3e} (tol {TOL[dtype][name]:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version in {dtype}")
    entry = results.setdefault(name, {}).setdefault(dtype, {})
    entry["max_abs_err"] = abs_e
    entry["ms"] = cuda_ms(kernel_fn)
    entry["plain_ms"] = cuda_ms(plain_fn)
    print(f"time    {name:22s} {str(dtype):14s} kernel {entry['ms']:.4f} ms  "
          f"plain {entry['plain_ms']:.4f} ms")


def kernel_phase(S, state, results):
    from knpemidg_tpu_torch.membrane import engine
    from knpemidg_tpu_torch.ops import spmv

    nbr = S.g["nbr"]
    pM, Ich, Itot = S._pads(state)
    blocks, rhs, Pd = S._assemble_emi(state["c"], state["c_elim"], pM, Itot, state["t"])
    blocksK, rhsK = S._knp_assemble_all(state["c"], state["c_elim"], state["phi"],
                                        pM, Ich, Itot, state["t"], state["c"])
    mem = S._ode_inputs(state, first_step=True)
    print(f"shapes  EMI blocks {tuple(blocks.shape)}  KNP blocks "
          f"{tuple(blocksK.shape)}  membrane points "
          f"{ {tag: mm.states.shape[1] for tag, mm in mem.items()} }")

    def ode_all(step, mms, t):
        outs = [step(mm, t, S.params.dt, S.params.n_steps_ODE) for mm in mms.values()]
        return [v for o in outs for v in (o.states, o.params)]

    def inv_scale(P, inv):           # componentwise bound of a block inverse
        return torch.einsum("...ikc,...klc,...ljc->...ijc", inv.abs(), P.abs(), inv.abs())

    def ode_scale(mms, ref):
        """Each state row against its own max |plain| (a gating variable is
        not measured against V); each parameter row against its own max
        |plain| floored at the tag's largest leak term g_leak |V - E|: the
        written-back channel currents are sums of such terms that cancel
        to ~1e-10 at rest."""
        out = []
        for mm, ys, ps in zip(mms.values(), ref[0::2], ref[1::2]):
            P, V = mm.model.PARAMS, ys[mm.model.STATES["V"]]
            leak = torch.maximum(
                (ps[P["g_leak_Na"]] * (V - ps[P["E_Na"]])).abs().max(),
                (ps[P["g_leak_K"]] * (V - ps[P["E_K"]])).abs().max())
            out += [ys.abs().amax(dim=-1, keepdim=True),
                    torch.maximum(ps.abs().amax(dim=-1, keepdim=True), leak)]
        return out

    # each timed call is one application per system of the step: the EMI
    # (m = 1) and the KNP (m = 2) operator, both membrane tags
    for dtype in (torch.float32, torch.float64):
        B, x = blocks.to(dtype), rhs.to(dtype)
        BK, xK = blocksK.to(dtype), rhsK.to(dtype)
        P, PK = Pd.to(dtype).contiguous(), BK[:, 0].contiguous()
        compare("bell_matvec", dtype,
                lambda: [spmv.bell_matvec(B, nbr, x), spmv.bell_matvec_multi(BK, nbr, xK)],
                lambda: [spmv.bell_matvec_plain(B, nbr, x),
                         spmv.bell_matvec_multi_plain(BK, nbr, xK)],
                lambda ref: [spmv.bell_matvec_plain(B.abs(), nbr, x.abs()),
                             spmv.bell_matvec_multi_plain(BK.abs(), nbr, xK.abs())],
                results)
        compare("block_jacobi_inverse", dtype,
                lambda: [spmv.block_jacobi_inverse(P), spmv.block_jacobi_inverse(PK)],
                lambda: [spmv.block_jacobi_inverse_plain(P),
                         spmv.block_jacobi_inverse_plain(PK)],
                lambda ref: [inv_scale(P, ref[0]), inv_scale(PK, ref[1])], results)
        inv, invK = spmv.block_jacobi_inverse(P), spmv.block_jacobi_inverse(PK)
        compare("block_jacobi_apply", dtype,
                lambda: [spmv.block_jacobi_apply(inv, x),
                         spmv.block_jacobi_apply(invK, xK)],
                lambda: [spmv.block_jacobi_apply_plain(inv, x),
                         spmv.block_jacobi_apply_plain(invK, xK)],
                lambda ref: [spmv.block_jacobi_apply_plain(inv.abs(), x.abs()),
                             spmv.block_jacobi_apply_plain(invK.abs(), xK.abs())],
                results)
        mms = {tag: engine.MembraneState(mm.states.to(dtype), mm.params.to(dtype),
                                         mm.model) for tag, mm in mem.items()}
        t = state["t"].to(dtype)
        compare("membrane_rk4", dtype, lambda: ode_all(engine.ode_step, mms, t),
                lambda: ode_all(engine.ode_step_plain, mms, t),
                lambda ref: ode_scale(mms, ref), results)


def small_reference_phase():
    """Two f64 steps of the small EMIx fixture on the card: the JAX
    package's Krylov counts, and the port's CPU run's fields."""
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    runs = {}
    for dev in ("cuda", "cpu"):
        mesh = box_3d_axons(0, length_factor=1)
        mesh.vertices *= 1e2
        S = emix.build_solver(mesh, dtype=torch.float64, device=dev)
        st = S.solve_system_active(0.2, 0.0, emix.solver_params())
        runs[dev] = (S, st)
    Sg, sg = runs["cuda"]
    Sc, sc = runs["cpu"]
    print(f"small   cuda emi {Sg.stats.emi_niters} knp {Sg.stats.knp_niters}  "
          f"cpu emi {Sc.stats.emi_niters} knp {Sc.stats.knp_niters}")
    if Sg.stats.emi_niters != REF_EMI or Sg.stats.knp_niters != REF_KNP:
        raise AssertionError("small-input Krylov counts differ from the reference")
    for key in ("phi", "c", "c_elim", "phi_M"):
        a, b = sg[key].cpu(), sc[key]
        r = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        print(f"small   {key:7s} rel diff cuda vs cpu {r:.3e}")
        if not r < 1e-8:
            raise AssertionError(f"small-input field {key} differs from the CPU run")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is False")
    from knpemidg_tpu_torch import _cuda, emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    card = gpu_line()
    print(f"gpu     {card}")
    print(f"torch   {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    build_s = _cuda.build()
    _cuda.lib()
    print(f"build   {build_s:.2f} s compiling ({time.perf_counter() - t0:.2f} s incl. load)")

    t0 = time.perf_counter()
    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2          # m -> cm (EMIx units)
    S = emix.build_solver(mesh, dtype=MAIN_DTYPE, device="cuda")
    sp = emix.solver_params()
    print(f"setup   {S.n_cells} cells, {S.n_mem} membrane points, "
          f"{time.perf_counter() - t0:.1f} s")

    results = {}
    t0 = time.perf_counter()
    state0 = S.attach_pc(S._initial_state(0.0), sp)
    torch.cuda.synchronize()
    print(f"pc      built in {time.perf_counter() - t0:.2f} s")
    kernel_phase(S, state0, results)
    small_reference_phase()

    # the reference protocol through the user entry point
    S.stats.__init__()
    _cuda.reset_launches()
    state = S.solve_system_active(1.0, 0.0, sp)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    report_window(S, MAIN_DTYPE)
    print(f"run     launches {launches}")
    for key in ("c", "c_elim", "phi", "phi_M", "I_ch"):
        v = state[key]
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite values in {key}")
    if state["c"].shape != (S.N_ions, S.nd, S.n_cells) or len(S.stats.emi_niters) != 10:
        raise AssertionError("unexpected output shape or step count")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    del S, state, state0

    # the same protocol in float32: reported, convergence not asserted
    S32 = emix.build_solver(mesh, dtype=torch.float32, device="cuda")
    state32 = S32.solve_system_active(
        1.0, 0.0, emix.solver_params(error_if_not_converged=False))
    torch.cuda.synchronize()
    report_window(S32, torch.float32)
    finite = all(bool(torch.isfinite(state32[k]).all()) for k in ("c", "phi", "phi_M"))
    print(f"f32     fields finite: {finite}")

    kernels = []
    for name, (src, repl) in KERNELS.items():
        r = results[name][MAIN_DTYPE]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
