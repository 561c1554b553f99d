#!/usr/bin/env python3
"""Time the redesigned kernel wrappers as the solver calls them, in float32
and float64, beside the library calls chip_smoke.py holds them to:

  k8   K8's entries pcg_dot, pcg_update (the cell layout's mean projection,
       the pair layout's masked one) and pcg_dot2_direction (a tree without
       it: pcg_dot2 alone and pcg_dot2 + pcg_direction), on one live work
       built once per solve, at the EMI vector shapes (cell (4, 124416),
       pair (8, 63558)), beside torch.dot, torch.mv on the stacked pair, and
       torch.mv + torch.addcmul into a preallocated buffer; pcg_update's
       bound (x, r, p, Ap and the mask read once, x and r written once) is
       printed beside it;
  k9   K9's work of one Arnoldi step after the matvec, as the solver makes
       it, on the KNP batch (two ions) of the cell (4 x 124,416 entries a
       system) and pair (8 x 63,558) layouts at 1, 4 and 16 populated basis
       rows, on one work built once per solve: this tree's one
       gmres_arnoldi call; a tree without it the six calls its solver
       makes (gmres_cgs_dot, gmres_cgs_update twice each, gmres_next,
       gmres_givens); and the dot gmres_cgs_dot at 1 populated row (the
       solve's tolerance, as the solver calls it on bz[None]) and at 4,
       beside one torch.bmm of the populated rows into a preallocated
       output, with its bound (the rows and w read once);
  k6   K6 (m = 1, with As and the compartment, moment and Ritz groups)
       and K7 (m = 2, no As, no groups) at the coarse sizes of the cell
       (1,944 chunks of 64 cells) and pair (1,987 chunks of 32 pairs)
       layouts, each entry as the apply calls it: restrict, the coarse
       solve on restrict's outputs beside dense_gemvs (cuBLAS: torch.mv per
       product, one batched torch.matmul for m systems), and prolong_add
       into a preallocated output on the solve's; on the cell layout K6's
       prolong-add with kernel B's apply folded in (a tree with the fold)
       beside kernel B's apply followed by prolong_add; for K6 also torch.mv of
       the (nf, nd nc) field stack (the one-hots repeated over nd) on r, the
       dense projection a partial yardstick of restrict (no chunk sums).
       Each moment field is zero outside its compartment (5 compartments
       of equal cell ranges), as the solver's are;
  k6t  K6's three-level solve (m = 1, with As and the compartment, moment
       and Ritz groups: 5, 95 and 24 fields) at the 995,328-tet mesh's cell
       sizes (15,552 chunks of 64 cells in 3,888 super-chunks of 4), on
       restrict's outputs, beside its yardstick (the super-chunk sums,
       then torch.mv per product);
  k7t  K7's three-level one-launch apply of two ions (no As, no groups) at
       those sizes into a block-Jacobi output in place, unmasked and with a
       live mask, and with kernel B's apply folded in, beside the
       yardstick (one batched torch.matmul on the super-chunk sums);
  k4   to_pair of the EMI solve's 3 vectors (4, 127116) and the KNP solve's
       2 (2, 4, 127116), beside one torch.mul into a preallocated buffer;
       from_pair back as the solver calls it (the EMI solution with the
       guess added in pair form, the KNP one added to c in cell form; a
       tree without the add forms: the relayout and a separate add), beside
       one torch.add of the relayout views into a preallocated buffer;
  k1   K1 bell_matvec on the EMI system (m = 1) and bell_matvec_multi on
       the KNP batch (m = 2) with the neighbour table of chip_smoke.py's
       cell layout (124,416 cells, random blocks and vectors), beside one
       torch.sparse_bsr_tensor product per system (cuSPARSE, built outside
       the timing); and two ablations of the EMI call: the table replaced
       by the cell itself in every slot (the gathers then coalesced), and
       the first half of the cells alone (half the work at the same depth
       of dependent loads);
  k14  K14 as the solver calls it at chip_smoke.py's configuration: a
       step's ODE-input traces (a tree with membrane_traces_m: that one
       call; a tree without it: the one-field calls its solver makes, one
       Nernst potential per (tag, ion) and the plus and minus averages of
       StandardSolver's update_ode per tag, each over all membrane facets)
       and the finalize jump, in both dtypes; and the pushes of a step as
       the solver makes them in float64 (this tree: Solver._ode_pushes, the
       traces and every tag's push sources; a tree without it:
       Solver._ode_inputs, the traces with every tag's parameters cloned
       and set), host time included; no graph;
  k5   K5's block-Jacobi inverse as the step calls it, on the EMI (m = 1)
       and KNP (m = 2) diagonals of the cell layout (the KNP one slot 0 of
       the (2, 5, 4, 4, nc) operator) and the pair layout (unmasked): this
       tree into the step's buffer, the KNP cell diagonal read in place,
       the pair layout's in the halves form; a tree without that route
       the solver's slot-0 copy or mask product, then the inverse; beside
       chip_smoke.lib_inv, with the bound of the work's bytes.  Then K5's
       block-Jacobi apply as the two-level apply calls it, on the
       EMI (m = 1) and KNP (m = 2) systems of the cell layout (nd = 4,
       124,416 cells) and the pair layout (2nd = 8, 63,558 pairs, the
       inverse zero off its two diagonal 4 x 4 blocks): this tree's
       operands checked once (the pair layout's halves form writing into
       its buffer), and on the pair layout also its full form; a tree
       without them its block_jacobi_apply(Pinv, r), the full form; beside
       chip_smoke.lib_apply (one batched torch.matmul);
  k11  K11 knp_facet on chip_smoke.py's cell-layout facet tables at a
       seeded potential's gradient, both dtypes, with a digest of its
       outputs;
  k11e K11's membrane rhs and emit as the step calls them at a seeded
       state, on chip_smoke.py's cell tables and pair maps, both dtypes:
       this tree's one knp_membrane_emit call into buffers made once, or
       in a tree without it the separate knp_membrane_rhs + knp_emit_cell
       calls;
  k12  K12 as the step calls it on chip_smoke.py's pair maps: the EMI
       emit with reg (m = 1) and the KNP emit with the static operator
       (m = 2, zero outside the owner halves), random inputs; this tree
       into buffers made once (emit_buffers), a tree without them
       allocating its outputs;
  k7   K7's coarse apply as the KNP solve calls it (two ions, no As, no
       deflation) at the cell and pair coarse sizes, into an output in
       place, on pairs with a live mask: this tree's one call (one launch)
       beside its three entry points composed; a tree without the mask
       argument its three calls and, on pairs, the product with the mask;
       on the cell layout also the one call with kernel B's apply folded
       in (a tree with the fold) beside kernel B's apply followed by the
       one call;
  k10e K10's EMI emit as the step calls it on seeded facet blocks and rhs
       parts, on chip_smoke.py's cell tables (124,416 cells) and pair
       layout (127,116 padded cells), both dtypes: this tree's call with
       the solver's packed slot words into buffers made once, or in a tree
       without them its one call;
  k10c K10's emi_cell (k10c) and K11's knp_cell (k11c) as the step calls
  k11c them at a seeded state (c perturbed, a seeded potential), on
       chip_smoke.py's cell tables (124,416 cells) and pair layout (127,116
       padded cells), both dtypes: this tree's calls with the cell tables
       built once (assembly.cell_tables) into the step's buffers (made
       once); or in a tree without them its public call, which checks its
       tables and allocates its outputs; each with its bound (every input
       read once, every output written once) and its device microseconds
       a launch read by the profiler over 20 calls (``dev_us``);
  k11a K11's alpha_sum (k11a) and K14's eliminated_concentration (k14z)
  k14z as the step calls them at a seeded state (c and c_elim perturbed)
       on chip_smoke.py's cell tables (124,416 cells) and pair layout
       (127,116 padded cells), both dtypes: this tree's step route (the
       solver's z, D and rho checked once in assembly.cell_tables; alpha
       read from c and c_elim apart into the step's buffer, made once; a
       new c_elim each call), and eliminated_concentration's route on
       inputs one element off their alignment (``one``: one node a thread,
       as float64 always runs) beside it; in a tree
       without the route, the calls its step makes (the torch.cat of c and
       c_elim, then the public alpha_sum; the public
       eliminated_concentration on z[:-1]); in every tree also the public
       call on ready inputs; each with its bound (every input read once,
       every output written once) and its device microseconds a launch
       (``dev_us``, the profiler over 20 calls);
  k9s  K9's cycle start on the KNP batch (two ions) of the cell (4 x
       124,416 entries a system) and pair (8 x 63,558) layouts, both
       dtypes, on one work built once per solve;
  k9u  K9's cycle end (triangular solve and update) on the same batches at
       4 and 16 populated rows a system: this tree's one launch, a
       parent's two launches, beside one
       torch.baddbmm over the populated rows (partial: no triangular
       solve), with the bound;
  k13  Solver._ode_step itself in float64 under each scheme at
       chip_smoke.py's configuration: the pushes, every tag's ODE step and
       the pulls (this tree: one K13 launch; a tree with the per-tag
       kernels: one launch a tag and the torch pushes and pulls around
       them), host time and graph replay ("not measured" where the step
       reads a value back to the host, which a graph cannot capture); and,
       on a tree with the one launch, each tag's launch alone in both
       dtypes (its model's chain without the other beside it).

The data is random (seeded) at those shapes: only times are read.  The
package is imported from ``--root`` (default: this file's directory), so
the same measurement reads another tree, such as an unpacked parent
commit, in the same call: run it for parent, change, change, parent.  Each
entry is called as that tree's solver calls it: a tree whose krylov_ops
has no ``pcg_work`` gets a work built by hand, a tree whose coarse
operands carry no workspace gets fresh outputs from its restrict, a tree
whose to_pair takes no list gets the torch.stack its solver makes, and a
tree without pcg_dot2_direction, gmres_arnoldi or from_pair's add forms
gets the separate calls its solver makes.

Per entry it prints the median of 20 CUDA-event timings of one call
(``ms``, the yardstick of chip_smoke.py), the host microseconds per call
to enqueue 200 calls (``host_us``: the wrapper alone), the microseconds
per call of a loop of 1,000 calls closed by one synchronise (``loop_us``:
the larger of host and device time), and the
device microseconds per call of 100 calls replayed as one CUDA graph
(``graph_us``: the kernels and the gaps between them, no host; "not
measured" where the call cannot be captured).  It also prints the cost of
reading the current stream both ways.

Usage:  python3 time_wrappers.py [--root DIR]
            [--only k8,k9,k9s,k9u,k6,k4,k1,k14,k13,k5,k11,k11e,k10e,k10c,k11c,k11a,k14z,k12,k7,
                    k6t,k7t]
        (needs a CUDA card)
"""
import argparse
import inspect
import os
import statistics
import subprocess
import sys
import time

import torch

from chip_smoke import dense_gemvs, graph_ms, lib_apply, three_gemvs

SHAPES = {"cell": (4, 124416), "pair": (8, 63558)}
# coarse sizes: (cells of the layout's r, dofs, chunk size, compartment,
# moment and Ritz fields) as chip_smoke.py's pcs give them
COARSE = {"cell": (124416, 4, 64, 5, 45, 24), "pair": (63558, 8, 32, 5, 45, 0)}
NPAIR, ND, IONS = 63558, 4, 2
LOOP = 1000


def cuda_ms(fn, reps=20):
    """Median milliseconds of one fn() by CUDA events, warmed up."""
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


def loop_us(fn, calls=LOOP):
    """Host microseconds per call of ``calls`` back-to-back calls closed by
    one synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def graph_us(fn, calls=100, replays=5):
    """Device microseconds per call with the host out of the way: ``calls``
    calls captured in one CUDA graph, its replay timed by CUDA events
    (median of ``replays``; chip_smoke.graph_ms); None where the call
    cannot be captured."""
    try:
        return 1e3 * graph_ms(fn, calls, replays)
    except RuntimeError as exc:
        print(f"time    not captured: {exc}".splitlines()[0])
        return None


def stream_lookup_us(calls=100000):
    """Microseconds per read of the current stream's handle: through a
    stream object, and as the raw handle."""
    out = {}
    reads = {"current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream}
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        reads["_cuda_getCurrentRawStream"] = lambda: raw(torch._C._cuda_getDevice())
    for name, fn in reads.items():
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t0) / calls
    if raw is not None:
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            same = raw(torch._C._cuda_getDevice()) == s.cuda_stream
        out["raw handle follows torch.cuda.stream"] = same
    return out


def host_us(fn, calls=200):
    """Host microseconds per call to enqueue ``calls`` calls, the device
    idle before them; fewer calls than the launch queue holds, so the host
    does not wait for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def report(tag, name, fn, graph=True):
    g = graph_us(fn) if graph else None
    print(f"{tag}  {name:44s} ms {cuda_ms(fn):.4f}  host_us {host_us(fn):.2f}  "
          f"loop_us {loop_us(fn):.2f}  graph_us " + ("not measured" if g is None else f"{g:.2f}"))


def time_dots(ko, dev, gen):
    factory = hasattr(ko, "pcg_work")
    fused = hasattr(ko, "pcg_dot2_direction")
    print(f"k8time  pcg_work {factory}  pcg_dot2_direction {fused}")
    for layout, shape in SHAPES.items():
        for dtype in (torch.float32, torch.float64):
            r, z, p, Ap = (torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                           for _ in range(4))
            n = r.numel()
            wsum = torch.tensor(float(n), dtype=dtype, device=dev)
            zero = torch.zeros_like(wsum)
            sc = torch.stack([(r * z).sum(), (z * z).sum(), zero, zero, zero, wsum])
            # a live work: this tree's entries write nothing once the flag is 0
            flag = torch.ones(1, dtype=torch.int32, device=dev)
            mode = 2 if layout == "pair" else 1
            mask = (torch.rand(shape, generator=gen, device=dev) > 0.1).to(dtype)
            if mode == 2:
                sc[-1] = mask.sum()
            wk = (ko.pcg_work(sc, flag, mask if mode == 2 else None, mode, n) if factory
                  else ko.PcgWork(sc=sc, flag=flag, w=mask if mode == 2 else None, mode=mode))
            x, res = torch.randn_like(p), torch.randn_like(p)
            stack = torch.stack([r.view(-1), z.view(-1)])
            beta, buf = sc[0] / sc[1], torch.empty_like(p)
            calls = {"pcg_dot": lambda: ko.pcg_dot(p, Ap, wk),
                     "pcg_update": lambda: ko.pcg_update(x, res, p, Ap, wk)}
            if fused:
                calls["pcg_dot2_direction"] = lambda: ko.pcg_dot2_direction(r, z, p, wk)
            else:
                calls["pcg_dot2"] = lambda: ko.pcg_dot2(r, z, wk)
                calls["pcg_dot2 + pcg_direction"] = lambda: ko.pcg_direction(
                    p, z, ko.pcg_dot2(r, z, wk))
            calls.update({"torch.dot": lambda: torch.dot(p.view(-1), Ap.view(-1)),
                          "torch.mv": lambda: torch.mv(stack, z.view(-1)),
                          "torch.mv + torch.addcmul out=": lambda: (
                              torch.mv(stack, z.view(-1)),
                              torch.addcmul(z, beta, p, out=buf))})
            for name, fn in calls.items():
                report("k8time", f"{layout} {str(dtype):14s} {name}", fn)
            vec = n * p.element_size()
            print(f"k8time  {layout} {str(dtype):14s} pcg_update bound "
                  f"{bound_us((6 + (mode == 2)) * vec):.2f} us (bytes)")


def time_arnoldi(ko, dev, gen):
    fused = hasattr(ko, "gmres_arnoldi")
    print(f"k9time  gmres_arnoldi {fused}")
    for layout, (nd, nc) in (("cell", (4, 124416)), ("pair", (8, NPAIR))):
        n = nd * nc
        for dtype in (torch.float32, torch.float64):
            wk = ko.gmres_work(IONS, n, 30, dtype, dev)
            w = torch.randn((IONS, n), generator=gen, device=dev, dtype=dtype)
            for rows in (1, 4, 16):
                j = rows - 1
                wk.V[:rows] = torch.randn((rows, IONS, n), generator=gen, device=dev,
                                          dtype=dtype) / n ** 0.5
                # every system live in every call (tol below any |g|): a
                # tree whose step writes nothing once the flag is 0 would
                # otherwise time frozen steps
                wk.tol.fill_(-1.0)
                wk.g[:, j] = 1.0
                if fused:
                    name = "gmres_arnoldi"
                    fn = lambda j=j: ko.gmres_arnoldi(w, wk, j)
                else:
                    name = "the six calls"

                    def fn(j=j, rows=rows):
                        ko.gmres_cgs_dot(wk.V, w, rows, wk.h1)
                        ko.gmres_cgs_update(wk.V, w, wk.h1, rows)
                        ko.gmres_cgs_dot(wk.V, w, rows, wk.h2)
                        ko.gmres_cgs_update(wk.V, w, wk.h2, rows)
                        ko.gmres_next(w, wk, j)
                        ko.gmres_givens(wk, j)
                report("k9time", f"{layout} {str(dtype):14s} {rows:2d} rows {name}", fn)
            time_cgs_dot(ko, wk, w, layout, dtype)


def time_solve_update(ko, dev, gen):
    """K9's cycle end (the triangular solve and x += sum_k y_k V[k]) on one
    work of each layout's KNP batch at 4 and 16 populated rows a system:
    this tree's one launch (a block a chunk, each solving its system); a
    parent's two launches (the back substitution, then the update); beside one torch.baddbmm over the
    populated rows into a preallocated output (partial: no triangular
    solve), with the bound (the rows and x read once, x written once)."""
    for layout, (nd, nc) in (("cell", (4, 124416)), ("pair", (8, NPAIR))):
        n = nd * nc
        for dtype in (torch.float32, torch.float64):
            rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            wk = ko.gmres_work(IONS, n, 30, dtype, dev)
            R = rnd(IONS, 31, 30)
            R[:, range(30), range(30)] += 4.0
            g, x = rnd(IONS, 31), rnd(IONS, n)
            out = torch.empty((IONS, 1, n), dtype=dtype, device=dev)
            for rows in (4, 16):
                V = rnd(rows, IONS, n) / n ** 0.5
                wk.V[:rows] = V
                wk.R.copy_(R)
                wk.g.copy_(g)
                wk.ks.fill_(rows)
                report("k9utime", f"{layout} {str(dtype):14s} {rows:2d} rows gmres_solve_update",
                       lambda: ko.gmres_solve_update(wk, x))
                Vr, y = V.transpose(0, 1).contiguous(), rnd(IONS, 1, rows)
                report("k9utime", f"{layout} {str(dtype):14s} {rows:2d} rows torch.baddbmm "
                       f"(partial)", lambda: torch.baddbmm(x[:, None], y, Vr, out=out))
                print(f"k9utime {layout} {str(dtype):14s} {rows:2d} rows gmres_solve_update bound "
                      f"{bound_us((rows + 2) * IONS * n * x.element_size()):.2f} us (bytes)")
                del V, Vr


def bound_us(nbytes):
    """Microseconds to move ``nbytes`` at the H100's 3.35 TB/s."""
    return 1e6 * nbytes / 3.35e12


def time_cgs_dot(ko, wk, w, layout, dtype):
    """K9's tolerance dot as the solver calls it (1 row: bz[None], out the
    work's h1) and at 4 rows of the work's basis, beside one torch.bmm of
    the populated rows in the reference's (mb, rows, n) layout."""
    mb, n = w.shape
    for rows in (1, 4):
        V = w[None] if rows == 1 else wk.V
        Vr = V[:rows].transpose(0, 1).contiguous()
        out = torch.empty((mb, rows, 1), dtype=dtype, device=w.device)
        report("k9time", f"{layout} {str(dtype):14s} {rows:2d} rows gmres_cgs_dot",
               lambda: ko.gmres_cgs_dot(V, w, rows, wk.h1, wk))
        report("k9time", f"{layout} {str(dtype):14s} {rows:2d} rows torch.bmm",
               lambda: torch.bmm(Vr, w[..., None], out=out))
        print(f"k9time  {layout} {str(dtype):14s} {rows:2d} rows gmres_cgs_dot bound "
              f"{bound_us((rows + 1) * mb * n * w.element_size()):.2f} us (bytes)")


def coarse_data(layout, batched, dtype, dev, gen):
    """Random two-level data of the layout's shapes: K6 with As and its
    deflation groups, K7 for two ions without either."""
    nc, nd, agg, n_comp, nw, nr = COARSE[layout]
    n, m = -(-nc // agg), IONS if batched else 1
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    lead = (m,) if batched else ()
    d = {"inv": rnd(*lead, n, n) / n, "s": 1.0 + rnd(*lead, n).abs()}
    if not batched:
        d["As"] = rnd(n, n) / n
        for key, k in (("comp", n_comp), ("mom", nw), ("ritz", nr)):
            if k:
                d[f"{key}_inv"], d[f"{key}_s"] = rnd(k, k) / k, 1.0 + rnd(k).abs()
        d["comp_As"] = rnd(n_comp, n_comp) / n_comp
        comp = torch.arange(nc, device=dev) * n_comp // nc
        d["comp_onehot"] = (comp == torch.arange(n_comp, device=dev)[:, None]).to(dtype)
        owner = torch.arange(nw, device=dev) // (nw // n_comp)
        d["mom_W"] = rnd(nw, nd, nc) * (comp == owner[:, None, None])
        if nr:
            d["ritz_W"] = rnd(nr, nd, nc)
    return d, agg, rnd(m, nd, nc)


def cell_bj(spmv, r, gen):
    """Block-Jacobi operands of a random dominant nd = 4 inverse for r
    (m, 4, nc): one system's without a leading axis, m systems' with."""
    m, nd, nc = r.shape
    Pinv = 0.3 * torch.randn((m, nd, nd, nc), generator=gen, device=r.device, dtype=r.dtype)
    Pinv += 4.0 * torch.eye(nd, device=r.device, dtype=r.dtype)[:, :, None]
    return spmv.block_jacobi_operands(Pinv if m > 1 else Pinv[0])


def fold_calls(coarse, spmv, co, r, out, gen, zc=None, coef=None):
    """The cell layout's apply with kernel B's apply: this tree's folded
    call (coarse_add with the operands, or with ``zc`` and ``coef``
    prolong_add with them) and in every tree kernel B's apply, then the
    unfolded call (the two launches of a tree without the fold)."""
    bj = cell_bj(spmv, r, gen)
    rb = r if r.shape[0] > 1 else r[0]
    fold = "bj" in inspect.signature(coarse.coarse_add).parameters
    if zc is None:
        two = lambda: coarse.coarse_add(co, spmv.block_jacobi_apply(bj, rb).view(r.shape), r)
        one = lambda: coarse.coarse_add(co, out, r, None, bj)
    else:
        two = lambda: coarse.prolong_add(co, spmv.block_jacobi_apply(bj, rb).view(r.shape), zc,
                                         coef)
        one = lambda: coarse.prolong_add(co, out, zc, coef, bj=bj, r=r)
    return ({"folded (one call)": one} if fold else {}) | {"block_jacobi_apply, then": two}


def time_coarse(coarse, dev, gen):
    from knpemidg_tpu_torch.ops import spmv

    for layout in COARSE:
        for batched in (False, True):
            for dtype in (torch.float32, torch.float64):
                d, agg, r = coarse_data(layout, batched, dtype, dev, gen)
                co = coarse.operands(d, agg, batched)
                rc, proj = coarse.restrict(co, r)
                x = co.s * rc
                zc, coef = coarse.solve(co, rc, proj)
                out = torch.zeros_like(r)
                kind = "K7" if batched else "K6"
                tag = f"{layout} {kind} {str(dtype):14s}"
                report("k6time", f"{tag} restrict", lambda: coarse.restrict(co, r))
                report("k6time", f"{tag} solve", lambda: coarse.solve(co, rc, proj))
                report("k6time", f"{tag} dense_gemvs", lambda: dense_gemvs(co, x))
                report("k6time", f"{tag} prolong_add",
                       lambda: coarse.prolong_add(co, out, zc, coef))
                if layout == "cell" and not batched:
                    for name, fn in fold_calls(coarse, spmv, co, r, out, gen, zc,
                                               coef).items():
                        report("k6time", f"{tag} prolong_add {name}", fn)
                if not batched:
                    m_, nd, nc = r.shape
                    stack = torch.cat([co.OH[:, None].expand(-1, nd, nc).reshape(-1, nd * nc)]
                                      + [t.reshape(t.shape[0], -1) for t in (co.W, co.Wr)
                                         if t is not None])
                    report("k6time", f"{tag} torch.mv field stack (partial yardstick)",
                           lambda: torch.mv(stack, r.view(-1)))
                    del stack
                del co, d, r, rc, proj, x, zc, coef, out
                torch.cuda.empty_cache()


# the 995,328-tet mesh's cell layout: cells, chunks of 64, super-chunks of 4
SCALE = (995328, 64, 4)


def three_level_data(batched, dtype, dev, gen):
    """Random three-level data at SCALE: K6's (As; 5 compartments, 95
    moment fields each zero outside its compartment, 24 Ritz fields) or
    K7's (two ions, neither), with r (m, 4, nc)."""
    nc, agg, k2 = SCALE
    n_agg = nc // agg
    n2 = n_agg // k2
    m = IONS if batched else 1
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    lead = (m,) if batched else ()
    d = {"inv": rnd(*lead, n2, n2) / n2, "s": 1.0 + rnd(*lead, n2).abs(),
         "d1inv": 1.0 + rnd(*lead, n_agg).abs()}
    if not batched:
        n_comp, nw, nr = 5, 95, 24
        d["As"] = rnd(n2, n2) / n2
        for key, k in (("comp", n_comp), ("mom", nw), ("ritz", nr)):
            d[f"{key}_inv"], d[f"{key}_s"] = rnd(k, k) / k, 1.0 + rnd(k).abs()
        d["comp_As"] = rnd(n_comp, n_comp) / n_comp
        comp = torch.arange(nc, device=dev) * n_comp // nc
        d["comp_onehot"] = (comp == torch.arange(n_comp, device=dev)[:, None]).to(dtype)
        owner = torch.arange(nw, device=dev) // (nw // n_comp)
        d["mom_W"] = rnd(nw, 4, nc) * (comp == owner[:, None, None])
        d["ritz_W"] = rnd(nr, 4, nc)
    return d, agg, rnd(m, 4, nc)


def time_three_level(coarse, dev, gen, batched):
    """The k6t / k7t sections (see the module docstring)."""
    from knpemidg_tpu_torch.ops import spmv

    if not hasattr(coarse, "solve_ordered_plain"):
        print(f"k{7 if batched else 6}ttime  no three-level forms in this tree")
        return
    for dtype in (torch.float32, torch.float64):
        d, agg, r = three_level_data(batched, dtype, dev, gen)
        co = coarse.operands(d, agg, batched)
        rc, proj = coarse.restrict(co, r)
        tag = f"cell {'K7' if batched else 'K6'} three-level {str(dtype):14s}"
        if not batched:
            report("k6ttime", f"{tag} solve", lambda: coarse.solve(co, rc, proj))
            report("k6ttime", f"{tag} super-chunk sums + dense_gemvs",
                   lambda: three_gemvs(co, rc))
        else:
            out = torch.zeros_like(r)
            lm = (torch.rand(r.shape[1:], generator=gen, device=dev) < 0.98).to(dtype)
            report("k7ttime", f"{tag} coarse_add (one launch)", lambda: coarse.coarse_add(co, out, r))
            report("k7ttime", f"{tag} coarse_add (one launch, masked)",
                   lambda: coarse.coarse_add(co, out, r, lm))
            bj = cell_bj(spmv, r, gen)
            report("k7ttime", f"{tag} coarse_add (kernel B folded in)",
                   lambda: coarse.coarse_add(co, out, r, None, bj))
            report("k7ttime", f"{tag} super-chunk sums + dense_gemvs",
                   lambda: three_gemvs(co, rc))
        del co, d, r, rc, proj
        torch.cuda.empty_cache()


def time_emit(pairs, dev, gen):
    """K12 as the step calls it on chip_smoke.py's pair maps (63,558
    pairs): the EMI emit (m = 1, with reg) and the KNP emit (m = 2, with
    the static operator, zero outside the owner halves), random inputs;
    a tree with emit_buffers writes into buffers made once, a tree without
    it allocates its outputs each call."""
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2
    S = emix.build_solver(mesh, dtype=torch.float64, device="cuda", pair=True)
    pm, nd, nc = S.pairs, S.nd, S.n_cells_pad
    nf1 = S.g["f_area"].shape[0]
    npair = pm["int_f"].shape[0]
    buffered = hasattr(pairs, "emit_buffers")
    print(f"k12time emit into buffers {buffered}  ({npair} pairs, {nf1} facets)")
    for elt in (8, 4):
        fr, two, one = sector_census(S.pairs_host, elt)
        print(f"k12census {elt}-byte values: facet gathers fetch {fr:.2f}x the bytes they "
              f"use in 32-byte sectors; the cell gathers {two:.2f}x as two loads, "
              f"{one:.2f}x as one load a pair")
    own = pairs.owner_half_rows(pm, nd)
    for dtype in (torch.float32, torch.float64):
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        A, Ms = rnd(IONS, nd, nd, nc), [rnd(IONS, nd, nd, nf1) for _ in range(4)]
        add = (rnd(IONS, 2 * nd, 2 * nd, npair), (rnd(IONS, 6, 2 * nd, nd, npair) * own))
        reg = rnd(nd, nd, nc)
        one = [A[0].contiguous()] + [M[0].contiguous() for M in Ms]
        kw_e, kw_k = {}, {}
        if buffered:
            kw_e["out"] = pairs.emit_buffers(pm, nd, dtype, dev, diag=True)
            kw_k["out"] = pairs.emit_buffers(pm, nd, dtype, dev, m=IONS)
        emi = lambda: pairs.gather_blocks_pair(None, pm, *one, reg=reg, **kw_e)
        knp = lambda: pairs.gather_blocks_pair_multi(None, pm, A, *Ms, add=add, **kw_k)
        for name, fn in (("EMI emit (m = 1, reg)", emi), ("KNP emit (m = 2, add)", knp),
                         ("EMI + KNP emit", lambda: (emi(), knp()))):
            report("k12time", f"{str(dtype):14s} {name}", fn)
        del A, Ms, add, reg, one, kw_e, kw_k
        torch.cuda.empty_cache()


def sector_census(pmh, elt):
    """32-byte sectors a warp's facet-block gathers fetch, over the bytes
    its lanes use, for one (i, j) plane of one system (the arrays' bases
    sector-aligned), warps of 32 consecutive pairs on the host maps: the
    four interior loads (int_f) and the two loads a slot (ext_f, the array
    chosen by ext_isp; the arrays apart), and the cell gathers at cop done
    as two loads (cop[0], then cop[1]) or as one load of the pair's two
    adjacent cells.  Returns (facet ratio, two-load cell ratio, one-load
    cell ratio)."""
    import numpy as np

    npair = pmh["int_f"].shape[0]
    fetched = used = 0

    def count(idx, arr):               # one load instruction over the warps
        nonlocal fetched, used
        for w in range(0, npair, 32):
            sec = set(zip(arr[w:w + 32].tolist(), (idx[w:w + 32] * elt // 32).tolist()))
            fetched += 32 * len(sec)
            used += elt * len(idx[w:w + 32])

    zero = np.zeros(npair, dtype=np.int64)
    for a in range(4):
        count(np.asarray(pmh["int_f"], dtype=np.int64), zero + a)
    for t in range(pmh["ext_f"].shape[0]):
        f = np.asarray(pmh["ext_f"][t], dtype=np.int64)
        isp = np.asarray(pmh["ext_isp"][t], dtype=np.int64)
        count(f, isp)                   # Mpp or Mmm
        count(f, 2 + isp)               # Mpm or Mmp
    facet = fetched / used
    fetched = used = 0
    for h in range(2):
        count(np.asarray(pmh["cop"][h], dtype=np.int64), zero)
    two = fetched / used
    fetched = used = 0
    for w in range(0, npair, 32):       # cells 2p, 2p + 1: one vector a lane
        n = min(32, npair - w)
        lo, hi = 2 * w * elt // 32, (2 * (w + n) * elt - 1) // 32
        fetched += 32 * (hi - lo + 1)
        used += 2 * elt * n
    return facet, two, fetched / used


def time_coarse_apply(coarse, dev, gen):
    """K7's coarse apply as the KNP solve calls it, on random K7 data (two
    ions, no As, no deflation) at the cell and pair layouts' coarse sizes,
    into a block-Jacobi output in place (on pairs with a live mask): a tree
    whose coarse_add takes the mask makes one call (the one-launch apply);
    a tree without it its three calls and, on pairs, the product with the
    mask.  This tree also times its three entry points composed (restrict,
    solve, prolong_add with the mask) beside the one launch."""
    from knpemidg_tpu_torch.ops import spmv

    masked = "mask" in inspect.signature(coarse.coarse_add).parameters
    print(f"k7time  mask in the apply {masked}")
    for layout in COARSE:
        for dtype in (torch.float32, torch.float64):
            d, agg, r = coarse_data(layout, True, dtype, dev, gen)
            co = coarse.operands(d, agg, True)
            out = torch.zeros_like(r)
            lm = None
            if layout == "pair":
                lm = (torch.rand(r.shape[1:], generator=gen, device=dev) < 0.98).to(dtype)
            tag = f"{layout} K7 {str(dtype):14s}"
            if masked:
                one = lambda: coarse.coarse_add(co, out, r, lm)
                report("k7time", f"{tag} coarse_add (one launch{', masked' if lm is not None else ''})",
                       one)
                three = lambda: coarse.prolong_add(co, out, *coarse.solve(
                    co, *coarse.restrict(co, r)), lm)
                report("k7time", f"{tag} restrict + solve + prolong_add", three)
                if layout == "cell":
                    for name, fn in fold_calls(coarse, spmv, co, r, out, gen).items():
                        report("k7time", f"{tag} coarse_add {name}", fn)
            elif lm is None:
                report("k7time", f"{tag} coarse_add (three calls)",
                       lambda: coarse.coarse_add(co, out, r))
            else:
                report("k7time", f"{tag} coarse_add (three calls) * mask",
                       lambda: coarse.coarse_add(co, out, r) * lm)
            del co, d, r, out
            torch.cuda.empty_cache()


def time_to_pair(pairs, dev, gen):
    list_form = "out" in inspect.signature(pairs.to_pair).parameters
    add_forms = "add" in inspect.signature(pairs.from_pair).parameters
    print(f"k4time  list form {list_form}  from_pair add forms {add_forms}")
    pm = {"live1": torch.rand(NPAIR, generator=gen, device=dev) < 0.98}
    for dtype in (torch.float32, torch.float64):
        vecs = [torch.randn((ND, 2 * NPAIR), generator=gen, device=dev, dtype=dtype)
                for _ in range(3)]
        vecsK = [torch.randn((IONS, ND, 2 * NPAIR), generator=gen, device=dev, dtype=dtype)
                 for _ in range(2)]
        stack, stackK = torch.stack(vecs), torch.stack(vecsK)
        mask = torch.cat([torch.ones(ND, NPAIR, dtype=dtype, device=dev),
                          pm["live1"].to(dtype).expand(ND, NPAIR)]).reshape(2, ND, NPAIR)
        bufs = [torch.empty(t.shape[:-2] + (2 * ND, NPAIR), dtype=dtype, device=dev)
                for t in (stack, stackK)]
        if list_form:
            solver = lambda: [pairs.to_pair(pm, vecs), pairs.to_pair(pm, vecsK)]
        else:
            solver = lambda: [pairs.to_pair(pm, torch.stack(vecs)),
                              pairs.to_pair(pm, torch.stack(vecsK))]
        calls = {"to_pair (as the solver)": solver,
                 "torch.mul out= (stacked)": lambda: [
                     torch.mul(torch.movedim(t.reshape(-1, ND, NPAIR, 2), -1, 1), mask,
                               out=b.view(-1, 2, ND, NPAIR))
                     for t, b in zip((stack, stackK), bufs)]}
        if list_form:
            calls["to_pair out="] = lambda: [pairs.to_pair(pm, vecs, out=bufs[0]),
                                             pairs.to_pair(pm, vecsK, out=bufs[1])]
        for name, fn in calls.items():
            report("k4time", f"{str(dtype):14s} {name}", fn)

        # back: the EMI solution (ND * 2, NPAIR) plus its guess, the KNP one
        # (IONS, ND * 2, NPAIR) added to c
        xp, guess = bufs[0][1], bufs[0][2]
        xpK, cK = bufs[1][1], vecsK[1]
        cells = lambda v: torch.movedim(v.reshape(*v.shape[:-2], 2, ND, NPAIR), -3, -1)
        obufs = [torch.empty_like(vecs[0]), torch.empty_like(cK)]
        if add_forms:
            solver = lambda: [pairs.from_pair(pm, xp, add=guess),
                              pairs.from_pair(pm, xpK, base=cK)]
        else:
            solver = lambda: [pairs.from_pair(pm, guess + xp), cK + pairs.from_pair(pm, xpK)]
        calls = {"from_pair (as the solver)": solver,
                 "torch.add out= (views)": lambda: [
                     torch.add(cells(xp), cells(guess), out=obufs[0].view(ND, NPAIR, 2)),
                     torch.add(cK.view(-1, ND, NPAIR, 2), cells(xpK),
                               out=obufs[1].view(-1, ND, NPAIR, 2))]}
        if add_forms:
            calls["from_pair out="] = lambda: [
                pairs.from_pair(pm, xp, add=guess, out=obufs[0]),
                pairs.from_pair(pm, xpK, base=cK, out=obufs[1])]
        for name, fn in calls.items():
            report("k4time", f"{str(dtype):14s} {name}", fn)


def bj_diagonals(layout, m, dtype, dev, gen):
    """The diagonal blocks a step hands K5's inverse, random and dominant:
    cell, the EMI's (4, 4, nc) or slot 0 of the KNP operator (m, 5, 4, 4,
    nc) as a view; pair, the unmasked (m,) 8 x 8 pair diagonals."""
    nd, nc = SHAPES[layout]
    lead = () if m == 1 else (m,)
    eye = torch.eye(nd, device=dev, dtype=dtype)[:, :, None]
    if layout == "cell" and m > 1:
        B = 0.3 * torch.randn((m, 5, nd, nd, nc), generator=gen, device=dev, dtype=dtype)
        B[:, 0] += 4.0 * eye
        return B[:, 0]
    return 0.3 * torch.randn(lead + (nd, nd, nc), generator=gen, device=dev, dtype=dtype) + \
        4.0 * eye


def time_bj(spmv, dev, gen):
    """K5: the inverse as the step calls it (this tree: into the step's
    buffer, from slot 0 of the KNP operator in place, the pair layout's
    halves form on the unmasked diagonal; a tree without that route: the
    solver's slot-0 copy or mask product, then the inverse into a new
    tensor), beside chip_smoke.lib_inv and with its bound; then the apply
    as the two-level apply calls it (see the module's docstring)."""
    from chip_smoke import lib_inv

    operands = hasattr(spmv, "block_jacobi_operands")
    route = "halves" in inspect.signature(spmv.block_jacobi_inverse).parameters
    print(f"k5time  operands and halves form {operands}  the step's inverse route {route}")
    halves_mask = lambda dtype: torch.kron(torch.eye(2, device=dev, dtype=dtype),
                                           torch.ones(4, 4, device=dev, dtype=dtype))[..., None]
    for layout, (nd, nc) in SHAPES.items():
        pair = layout == "pair"
        for dtype in (torch.float32, torch.float64):
            for m in (1, IONS):
                P = bj_diagonals(layout, m, dtype, dev, gen)
                calls = {}
                if route:
                    out = torch.zeros(P.shape, device=dev, dtype=dtype)
                    calls["block_jacobi_inverse (the step's route)"] = (
                        lambda P=P, out=out: spmv.block_jacobi_inverse(P, pair, out))
                elif pair:
                    calls["block_jacobi_inverse (the step's route)"] = (
                        lambda P=P: spmv.block_jacobi_inverse(
                            (P * halves_mask(dtype)).contiguous()))
                else:
                    calls["block_jacobi_inverse (the step's route)"] = (
                        lambda P=P: spmv.block_jacobi_inverse(P.contiguous()))
                Pc = (P * halves_mask(dtype)).contiguous() if pair else P.contiguous()
                calls["lib_inv (torch.linalg.inv)"] = lambda Pc=Pc: lib_inv(Pc)
                elt = P.element_size()
                full = 2 * P.numel() * elt
                print(f"k5time  {layout} m={m} {str(dtype):14s} inverse bound "
                      f"{bound_us(full // 2 if pair else full):.2f} us the work's bytes"
                      + (f", {bound_us(full):.2f} us the whole blocks" if pair else ""))
                for name, fn in calls.items():
                    report("k5time", f"{layout} m={m} {str(dtype):14s} {name}", fn)
                del P, Pc, calls
            for m in (1, IONS):
                lead = () if m == 1 else (m,)
                Pinv = torch.randn(lead + (nd, nd, nc), generator=gen, device=dev, dtype=dtype)
                if pair:
                    Pinv = Pinv * halves_mask(dtype)
                r = torch.randn(lead + (nd, nc), generator=gen, device=dev, dtype=dtype)
                calls = {}
                if operands:
                    op = spmv.block_jacobi_operands(Pinv, halves=pair, buffer=pair)
                    calls["block_jacobi_apply (as the two-level apply)"] = (
                        lambda op=op, r=r: spmv.block_jacobi_apply(op, r))
                    if pair:
                        full = spmv.block_jacobi_operands(Pinv, buffer=True)
                        calls["block_jacobi_apply full form, buffer"] = (
                            lambda full=full, r=r: spmv.block_jacobi_apply(full, r))
                else:
                    calls["block_jacobi_apply (as the two-level apply)"] = (
                        lambda Pinv=Pinv, r=r: spmv.block_jacobi_apply(Pinv, r))
                calls["lib_apply (torch.matmul)"] = lambda Pinv=Pinv, r=r: lib_apply(Pinv, r)
                for name, fn in calls.items():
                    report("k5time", f"{layout} m={m} {str(dtype):14s} {name}", fn)


def main_solver():
    """chip_smoke.py's cell-layout solver in float64."""
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2
    t0 = time.perf_counter()
    S = emix.build_solver(mesh, dtype=torch.float64, device="cuda")
    print(f"time    solver built in {time.perf_counter() - t0:.1f} s")
    return S


def time_bell(spmv, S, dev, gen):
    from chip_smoke import bell_bsr

    nbr = S.g["nbr"]
    K, nc = nbr.shape
    half = nc // 2
    ablations = {"nbr = self": torch.arange(nc, dtype=torch.int32, device=dev).expand(
        K, nc).contiguous(), "first half of the cells": (nbr[:, :half] % half).contiguous()}
    for dtype in (torch.float32, torch.float64):
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        B, x, BK, xK = rnd(K, ND, ND, nc), rnd(ND, nc), rnd(IONS, K, ND, ND, nc), rnd(IONS, ND, nc)
        calls = {"EMI bell_matvec (m = 1)": lambda: spmv.bell_matvec(B, nbr, x),
                 "KNP bell_matvec_multi (m = 2)": lambda: spmv.bell_matvec_multi(BK, nbr, xK)}
        try:
            cells = lambda v: v.t().reshape(-1)
            mats = [(bell_bsr(B, nbr), cells(x))] + [(bell_bsr(BK[k], nbr), cells(xK[k]))
                                                     for k in range(IONS)]
            calls["EMI BSR @ vector"] = lambda: mats[0][0] @ mats[0][1]
            calls["KNP BSR @ vector (2 products)"] = lambda: [A @ u for A, u in mats[1:]]
        except (RuntimeError, NotImplementedError, TypeError) as exc:
            print(f"k1time  {str(dtype):14s} BSR not measured: {str(exc).splitlines()[0][:120]}")
        Bh, xh = B[..., :half].contiguous(), x[:, :half].contiguous()
        calls["EMI, nbr = self"] = lambda: spmv.bell_matvec(B, ablations["nbr = self"], x)
        calls["EMI, first half of the cells"] = lambda: spmv.bell_matvec(
            Bh, ablations["first half of the cells"], xh)
        for name, fn in calls.items():
            report("k1time", f"{str(dtype):14s} {name}", fn)
        del B, x, BK, xK, Bh, xh, calls
        torch.cuda.empty_cache()


def time_knp_facet(asm, S, gen):
    """K11's facet blocks on the cell layout's facet tables at a seeded
    potential's gradient, both dtypes, with the bits' digest (equal digests
    across trees: equal outputs)."""
    import hashlib

    state = S._initial_state(0.0)
    m = S.N_ions
    phi = 1e-3 * torch.randn(state["phi"].shape, generator=gen, device=state["phi"].device,
                             dtype=torch.float64)
    for dtype in (torch.float32, torch.float64):
        g = {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
             for k, v in S.g.items()}
        gphi = asm.knp_cell(g, phi.to(dtype), state["c"].to(dtype), S.params.dt)[0]
        z, D = S.z[:m].to(dtype).contiguous(), S.D[:m].to(dtype).contiguous()
        fn = lambda: asm.knp_facet(g, S.masks, z, D, gphi, S.params.psi)
        h = hashlib.sha256()
        for t in fn():
            h.update(t.cpu().numpy().tobytes())
        report("k11time", f"{str(dtype):14s} knp_facet ({g['f_area'].shape[0]} facets, "
               f"m = {m}) digest {h.hexdigest()[:16]}", fn)


def time_membrane_emit(asm, S_cell, gen):
    """K11's membrane rhs and emit as the step calls them, at a state
    perturbed with a seeded generator, on chip_smoke.py's cell tables
    (124,416 cells) and pair maps (127,116 padded cells), both dtypes: this
    tree's one call (knp_membrane_emit with its static tables built once,
    into buffers made once), or in a tree without it the separate
    knp_membrane_rhs + knp_emit_cell calls."""
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_k11_inputs import k11_inputs

    one = hasattr(asm, "knp_membrane_emit")
    print(f"k11etime one membrane emit call {one}")
    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2
    S_pair = emix.build_solver(mesh, dtype=torch.float64, device="cuda", pair=True)
    for layout, S in (("cell", S_cell), ("pair", S_pair)):
        pair, p, m = layout == "pair", S.params, S.N_ions
        st = S._initial_state(0.0)
        rnd = lambda t, a, b: a + (b - a) * torch.rand(t.shape, generator=gen, device=t.device,
                                                       dtype=t.dtype)
        c = (st["c"] * rnd(st["c"], 0.99, 1.01)).contiguous()
        call = torch.cat([c, st["c_elim"][None]]).contiguous()
        pM, Ich, _ = S._pads(st)
        phi = 0.1 * float(pM.abs().max()) * torch.randn(
            st["phi"].shape, generator=gen, device=c.device, dtype=torch.float64)
        pM = pM * rnd(pM, 0.9, 1.1)
        Ich = 1e-2 * torch.randn(Ich.shape, generator=gen, device=c.device, dtype=torch.float64)
        Ich[:, -1] = 0.0
        for dtype in (torch.float32, torch.float64):
            g, mem, margs, drift, M, b_cell, statics = k11_inputs(S, asm, dtype, c, call, phi,
                                                                  pM, Ich)
            if one:
                out = asm.knp_emit_buffers(g, mem, m, dtype, "cuda", pair)
                tab = asm.knp_emit_tables(g, mem)
                name = "knp_membrane_emit (one call, buffers)"
                fn = lambda: asm.knp_membrane_emit(
                    g, mem, *margs, p.F, p.C_M, p.dt, p.psi, drift, None if pair else M,
                    b_cell, statics, pair=pair, out=out, tables=tab)
            else:
                def fn():
                    b_p, b_m = asm.knp_membrane_rhs(g, mem, *margs, p.F, p.C_M, p.dt)
                    return asm.knp_emit_cell(g, mem, margs[0], margs[1], p.psi, drift, *M,
                                             b_cell, b_p, b_m, statics, pair=pair)
                name = "knp_membrane_rhs + knp_emit_cell"
            report("k11etime", f"{layout} {str(dtype):14s} {name}", fn)
    del S_pair
    torch.cuda.empty_cache()


def time_emi_emit(asm, S_cell, gen):
    """K10's emit as the step calls it on seeded facet blocks and rhs parts
    (the dummy facet zero), on the cell layout's tables and the pair
    layout's padded, renumbered ones, both dtypes."""
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    shared = "tables" in inspect.signature(asm.emi_emit_cell).parameters
    print(f"k10etime emit from the shared slot words {shared}")
    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2
    S_pair = emix.build_solver(mesh, dtype=torch.float64, device="cuda", pair=True)
    for layout, S in (("cell", S_cell), ("pair", S_pair)):
        pair = layout == "pair"
        for dtype in (torch.float32, torch.float64):
            g = {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point()
                     else v) for k, v in S.g.items()}
            nd, nc, nf1 = S.nd, g["cf_idx"].shape[1], g["f_area"].shape[0]
            rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            Ms, bs = [rnd(nd, nd, nf1) for _ in range(4)], [rnd(nd, k) for k in (nc, nf1, nf1)]
            for t in Ms + bs[1:]:
                t[..., -1] = 0.0
            kbar = 1.0 + torch.rand(nc, generator=gen, device="cuda", dtype=dtype)
            args = (g, kbar, *Ms, *bs, 1.0 / S.Lp ** 2)
            if shared:
                mem = {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point()
                           else v) for k, v in S.mem_dev.items()}
                out = asm.emi_emit_buffers(g, dtype, "cuda", pair)
                tab = asm.knp_emit_tables(g, mem)
                fn = lambda: asm.emi_emit_cell(*args, pair=pair, out=out, tables=tab)
            else:
                fn = lambda: asm.emi_emit_cell(*args, pair=pair)
            report("k10etime", f"{layout} {str(dtype):14s} emi_emit_cell", fn)
    del S_pair
    torch.cuda.empty_cache()


def device_us(fn, match, calls=20):
    """Device microseconds a launch of the kernels whose name holds
    ``match``, read by the profiler over ``calls`` calls after a warm-up
    call; None where the profiler saw none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
    return sum(us) / len(us) if us else None


def time_cells(asm, S_cell, gen, which):
    """K10's emi_cell (``which`` "k10c") or K11's knp_cell ("k11c") as the
    step calls it, at a seeded state on the cell layout's tables and the
    pair layout's padded, renumbered ones, both dtypes."""
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    routed = "tables" in inspect.signature(asm.emi_cell).parameters
    tag, name, kernel = (("k10ctime", "emi_cell", "emi_cell_kernel") if which == "k10c"
                         else ("k11ctime", "knp_cell", "ion_cell_kernel"))
    print(f"{tag} tables built once and the step's buffers in this tree: {routed}")
    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2
    S_pair = emix.build_solver(mesh, dtype=torch.float64, device="cuda", pair=True)
    for layout, S in (("cell", S_cell), ("pair", S_pair)):
        pair, p, m = layout == "pair", S.params, S.N_ions
        st = S._initial_state(0.0)
        c64 = st["c"] * (0.99 + 0.02 * torch.rand(st["c"].shape, generator=gen, device="cuda",
                                                  dtype=torch.float64))
        phi64 = 1e-3 * torch.randn(st["phi"].shape, generator=gen, device="cuda",
                                   dtype=torch.float64)
        for dtype in (torch.float32, torch.float64):
            cast = lambda d: {k: (v.to(dtype) if isinstance(v, torch.Tensor)
                                  and v.is_floating_point() else v) for k, v in d.items()}
            g = cast(S.g)
            z, D = S.z.to(dtype), S.D.to(dtype)
            c, phi = c64.to(dtype).contiguous(), phi64.to(dtype).contiguous()
            call = torch.cat([c, st["c_elim"].to(dtype)[None]]).contiguous()
            nc = call.shape[-1]
            if which == "k10c":
                # G, c and D of every ion, vol read; kappa, kbar, flux, b_cell written
                nbytes = (S.nd * (S.nd - 1) + call.shape[0] * (S.nd + 1) + 1
                          + 2 * S.nd + S.nd) * nc * c.element_size()
            else:
                # G, phi, every solved ion's c_n, vol read; gphi, drift, b_cell written
                nbytes = (S.nd * (S.nd - 1) + S.nd + m * S.nd + 1
                          + (S.nd - 1) + S.nd + m * S.nd) * nc * c.element_size()
            if routed:
                tab = asm.cell_tables(g, z)
                if which == "k10c":
                    out = asm.emi_emit_buffers(g, dtype, "cuda", pair)
                    fn = lambda: asm.emi_cell(g, z, D, call, p.F, p.psi, out=out, tables=tab)
                else:
                    out = asm.knp_emit_buffers(g, cast(S.mem_dev), m, dtype, "cuda", pair)
                    fn = lambda: asm.knp_cell(g, phi, c, p.dt, out=out, tables=tab)
            else:
                fn = ((lambda: asm.emi_cell(g, z, D, call, p.F, p.psi)) if which == "k10c"
                      else (lambda: asm.knp_cell(g, phi, c, p.dt)))
            label = f"{layout} {str(dtype):14s} {name}"
            report(tag, label, fn)
            dus = device_us(fn, kernel)
            print(f"{tag} {label} dev_us " + ("not measured" if dus is None else f"{dus:.2f}")
                  + f"  bound {bound_us(nbytes):.2f} us (bytes)")
    del S_pair
    torch.cuda.empty_cache()


def misaligned(t):
    """A copy of ``t`` starting one element past an allocation's start: no
    pair of its elements is one vector access, so a kernel that reads it
    runs one node a thread."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def time_ion_sums(asm, S_cell, gen, which):
    """K11's alpha_sum (``which`` "k11a") or K14's eliminated_concentration
    ("k14z") as the step calls it, at a seeded state on the cell layout and
    the pair layout's padded, renumbered cell axis, both dtypes."""
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons

    routed = "c_elim" in inspect.signature(asm.alpha_sum).parameters
    tag, name, kernel = (("k11atime", "alpha_sum", "alpha_sum_kernel") if which == "k11a"
                         else ("k14ztime", "eliminated_concentration", "eliminated_kernel"))
    print(f"{tag} the step's route (tables, c and c_elim apart) in this tree: {routed}")
    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2
    S_pair = emix.build_solver(mesh, dtype=torch.float64, device="cuda", pair=True)
    for layout, S in (("cell", S_cell), ("pair", S_pair)):
        pair, m = layout == "pair", S.N_ions
        st = S._initial_state(0.0)
        rnd = lambda t: t * (0.99 + 0.02 * torch.rand(t.shape, generator=gen, device="cuda",
                                                      dtype=torch.float64))
        c64, ce64 = rnd(st["c"]), rnd(st["c_elim"])
        z_elim = float(S.ion_list[-1].z)
        for dtype in (torch.float32, torch.float64):
            c, ce = c64.to(dtype).contiguous(), ce64.to(dtype).contiguous()
            z, D, rho = S.z.to(dtype), S.D.to(dtype), S.rho.to(dtype)
            call = torch.cat([c, ce[None]]).contiguous()
            n, nd, nc = call.shape
            es = c.element_size()
            if which == "k11a":
                # D and every ion's c read; alpha written
                nbytes = (n + n * nd + nd) * nc * es
                calls = {"public": lambda: asm.alpha_sum(z, D, call)}
                if routed:
                    g = {k: (v.to(dtype) if isinstance(v, torch.Tensor)
                             and v.is_floating_point() else v) for k, v in S.g.items()}
                    mem = {k: (v.to(dtype) if isinstance(v, torch.Tensor)
                               and v.is_floating_point() else v) for k, v in S.mem_dev.items()}
                    tab = asm.cell_tables(g, z, D=D, rho=rho)
                    out = asm.knp_emit_buffers(g, mem, m, dtype, "cuda", pair)
                    calls["step"] = lambda: asm.alpha_sum(z, D, c, ce, out=out, tables=tab)
                else:
                    calls["step"] = lambda: asm.alpha_sum(z, D, torch.cat([c, ce[None]]))
            else:
                # the solved ions' c and rho read; c_elim written
                nbytes = (m * nd + 1 + nd) * nc * es
                zs = z[:-1].contiguous()
                calls = {"public": lambda: asm.eliminated_concentration(c, zs, rho, z_elim)}
                if routed:
                    g = {k: (v.to(dtype) if isinstance(v, torch.Tensor)
                             and v.is_floating_point() else v) for k, v in S.g.items()}
                    tab = asm.cell_tables(g, z, D=D, rho=rho)
                    c1 = misaligned(c)
                    calls["step"] = lambda: asm.eliminated_concentration(c, tables=tab)
                    calls["step one"] = lambda: asm.eliminated_concentration(c1, tables=tab)
                else:
                    calls["step"] = lambda: asm.eliminated_concentration(c, z[:-1], rho,
                                                                          z_elim)
            for route, fn in calls.items():
                label = f"{layout} {str(dtype):14s} {name} {route}"
                report(tag, label, fn)
                dus = device_us(fn, kernel)
                print(f"{tag} {label} dev_us "
                      + ("not measured" if dus is None else f"{dus:.2f}")
                      + f"  bound {bound_us(nbytes):.2f} us (bytes)")
    del S_pair
    torch.cuda.empty_cache()


def time_start(ko, dev, gen):
    """K9's cycle start on one work of each layout's KNP batch."""
    for layout, (nd, nc) in (("cell", (4, 124416)), ("pair", (8, NPAIR))):
        n = nd * nc
        for dtype in (torch.float32, torch.float64):
            wk = ko.gmres_work(IONS, n, 30, dtype, dev)
            r = torch.randn((IONS, n), generator=gen, device=dev, dtype=dtype)
            wk.tol.fill_(1e-30)
            report("k9stime", f"{layout} {str(dtype):14s} gmres_start",
                   lambda: ko.gmres_start(r, wk))


def time_traces(asm, S):
    p, fused = S.params, hasattr(asm, "membrane_traces_m")
    print(f"k14time membrane_traces_m {fused}")
    state = S._initial_state(0.0)
    c, ce = state["c"], state["c_elim"]
    phi = 1e-3 * torch.ones_like(state["phi"])
    zs = [float(ion.z) for ion in S.ion_list]
    for dtype in (torch.float32, torch.float64):
        cast = lambda d: {k: (v.to(dtype) if isinstance(v, torch.Tensor)
                              and v.is_floating_point() else v) for k, v in d.items()}
        g, mem = cast(S.g), cast(S.mem_dev)
        fields = [f.to(dtype).contiguous() for f in list(c) + [ce]]
        ph = phi.to(dtype)
        if fused:
            coefs = [asm.nernst_coef(z, p.F, p.R, p.temperature) for z in zs]
            ode = lambda: asm.membrane_traces_m(g, mem, fields, coefs)
        else:
            na, k = len(S.ion_list) - 1, S._k_index

            def ode():
                out = []
                for tag, mm in S.mem_models.items():
                    s0, s1 = S.tables.slices[tag]
                    out += [asm.nernst_potential_m(g, mem, f, z, p.F, p.R,
                                                   p.temperature)[s0:s1]
                            for f, z, ion in zip(fields, zs, S.ion_list)
                            if mm.has_param(f"E_{ion.name}")]
                    out += [asm.membrane_avg_m(g, mem, fields[k], "p")[s0:s1],
                            asm.membrane_avg_m(g, mem, fields[na], "m")[s0:s1]]
                return out
        report("k14time", f"{str(dtype):14s} ODE-input traces", ode)
        report("k14time", f"{str(dtype):14s} finalize jump",
               lambda: asm.jump_phi_M_m(g, mem, ph))
    pushes = getattr(S, "_ode_pushes", None)
    name, fn = ("_ode_pushes", pushes) if pushes else ("_ode_inputs", S._ode_inputs)
    report("k14time", f"{str(torch.float64):14s} Solver.{name}",
           lambda: fn(state, first_step=False), graph=False)


def time_ode_step(engine, S):
    import dataclasses

    from chip_smoke import cast_step_inputs

    # a tree without the one-launch step reads the step time back to the
    # host in every call, which no graph can capture
    fused = hasattr(engine, "ode_step_tags")
    print(f"k13time ode_step_tags {fused}")
    state = S._initial_state(0.0)
    params = S.params
    for scheme in ("rk4", "rush_larsen"):
        S.params = dataclasses.replace(params, ode_scheme=scheme)
        report("k13time", f"{str(S.dtype):14s} Solver._ode_step {scheme}",
               lambda: S._ode_step(state, first_step=False), graph=fused)
        if not fused:
            continue
        table, pushes = S._ode_pushes(state, first_step=False)
        for dtype in (torch.float32, torch.float64):
            mms, ps = cast_step_inputs(state["mem"], pushes, dtype)
            args = (state["t"].to(dtype), S.params.dt, S.params.n_steps_ODE)
            report("k13time", f"{str(dtype):14s} {scheme} every tag",
                   lambda: engine.ode_step_tags(table, mms, ps, *args))
            # each tag alone (its model's chain without the other beside it)
            for j, e in enumerate(table.entries):
                tab = engine.tag_table([(e.model, 0, e.n)], e.n, S.ion_names, scheme)
                push = engine.TagPush(v=ps[j].v, params=ps[j].params)
                report("k13time", f"{str(dtype):14s} {scheme} {type(e.model).__name__} alone",
                       lambda tab=tab, j=j, push=push: engine.ode_step_tags(
                           tab, [mms[j]], [push], *args))
    S.params = params


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--only", default="k8,k6,k4", help="sections to run, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_wrappers.py needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from knpemidg_tpu_torch import _cuda
    from knpemidg_tpu_torch.membrane import engine
    from knpemidg_tpu_torch.ops import assembly as asm, coarse, krylov_ops as ko, pairs, spmv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"time    root {root}  package {os.path.dirname(ko.__file__)}")
    print(f"time    gpu {card}  torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"time    build {_cuda.build():.2f} s")
    for name, v in stream_lookup_us().items():
        print(f"time    stream {name}: {v if isinstance(v, bool) else f'{v:.3f} us'}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)
    built = []

    def solver():
        if not built:
            built.append(main_solver())
        return built[0]

    sections = {"k8": lambda: time_dots(ko, dev, gen), "k9": lambda: time_arnoldi(ko, dev, gen),
                "k6": lambda: time_coarse(coarse, dev, gen),
                "k4": lambda: time_to_pair(pairs, dev, gen),
                "k1": lambda: time_bell(spmv, solver(), dev, gen),
                "k14": lambda: time_traces(asm, solver()),
                "k13": lambda: time_ode_step(engine, solver()),
                "k5": lambda: time_bj(spmv, dev, gen),
                "k11": lambda: time_knp_facet(asm, solver(), gen),
                "k11e": lambda: time_membrane_emit(asm, solver(), gen),
                "k10e": lambda: time_emi_emit(asm, solver(), gen),
                "k10c": lambda: time_cells(asm, solver(), gen, "k10c"),
                "k11c": lambda: time_cells(asm, solver(), gen, "k11c"),
                "k11a": lambda: time_ion_sums(asm, solver(), gen, "k11a"),
                "k14z": lambda: time_ion_sums(asm, solver(), gen, "k14z"),
                "k9s": lambda: time_start(ko, dev, gen),
                "k9u": lambda: time_solve_update(ko, dev, gen),
                "k12": lambda: time_emit(pairs, dev, gen),
                "k7": lambda: time_coarse_apply(coarse, dev, gen),
                "k6t": lambda: time_three_level(coarse, dev, gen, False),
                "k7t": lambda: time_three_level(coarse, dev, gen, True)}
    for key in args.only.split(","):
        sections[key]()


if __name__ == "__main__":
    main()
