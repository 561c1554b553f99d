#!/usr/bin/env python3
"""SHA-256 digests of the outputs of kernels K10 emi_facet, K3
pair_matvec / pair_matvec_multi, K1 bell_matvec / bell_matvec_multi, K14
membrane_trace, K6's restrict and prolong-add, K13's ODE step and K9's
batched GMRES on the card, at chip_smoke.py's configuration
(box_3d_axons(1, length_factor=2) in cm, the EMIx solver), at a state
perturbed with a seeded generator: emi_facet on the cell and the pair
layout's facet tables (float32 and float64); the matvecs (K3 on pairs, K1
on cells; float32 and float64) on the step's EMI and two-ion KNP operators
applied to the step's rhs; K9 as the solver's block-Jacobi KNP solve
drives it (krylov.gmres_batched on those operators, each layout, both
dtypes): the correction, the iterations and the residual norms; K5's
apply on the step's diagonals (cell: nd = 4; pair: the pair_bj halves
inverse in the halves form, or the full form in a tree without it) and
the pair GMRES above with the solver's halves form; K11 knp_facet on each
layout's facet tables (both dtypes); K14 as
the solver pushes it (float64): each
tag's membrane states and ODE parameters out of Solver._ode_inputs (the
potential, the Nernst potentials E_* and StandardSolver's K_e / Na_i) and
the finalize jump, on both layouts, and in both dtypes each ion's plus and
minus facet averages and Nernst potential through the one-field entry
points; K6 on the EMI preconditioner data of each layout's pc build at
emix.solver_params() (the cell layout's with its 24 Ritz fields; both
dtypes) applied to a seeded r: restrict's chunk sums and projections,
then solve and the prolong-add into a seeded output (on pairs also with
the live mask, k6_prolong_m); K7's apply (k7_coarse) on each layout's KNP
pc data, two calls, masked on pairs; K11's membrane rhs and emit
(k11_emit: b_p, b_m, the blocks and the rhs) at the perturbed state, each
layout, both dtypes; K12 (k12_emit) on the inputs of the
step's pair EMI and KNP emits, both dtypes; K13 as the solver
drives it: Solver._ode_step at the perturbed state (membrane states
perturbed too) on both layouts, in both dtypes (a solver of each), under
both schemes and with first_step True and False -- every tag's new states
and parameters, phi_M and I_ch; K10's emit (k10_emit: the operator, rhs
and P_diag on cells, A_cell, rhs and reg on pairs) on the step's facet
blocks at the perturbed state, and K9's cycle start (k9_start) on a
seeded residual of each layout's KNP batch, both dtypes.  The 2D
instantiations (nd3 lines, a tree with the MMS path only) at the MMS
path's largest mesh (mms_square(7), the space problem's initial state, as
chip_smoke.py builds it): K1 at nd = 3, K = 4 on the EMI and each ion's
KNP operator applied to their rhs (k1_nd3), K5's inverse and apply on
their diagonals (k5_nd3), K6's restrict, solve and prolong-add on the
EMI apply's two-level operands (As, compartment one-hots) and on ion 0's
(neither) (k6_nd3), and K9 at one system: krylov.gmres on ion 0's system
with its two-level preconditioner (k9_gmres1: the correction, the
iterations, the residual norm).

The package is imported from ``--root`` (default: this file's directory),
so two trees, such as an unpacked parent commit and this one, can be held
to the same bits: equal digests mean bitwise equal outputs (a zero's sign
included).

Usage:  python3 kernel_digest.py [--root DIR]   (needs a CUDA card)
"""
import argparse
import hashlib
import inspect
import os
import sys

import torch


TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_digest.py needs a CUDA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.mesh.generators import box_3d_axons
    from knpemidg_tpu_torch.ops import assembly as asm, coarse, pairs, spmv
    from knpemidg_tpu_torch.solvers import krylov

    mesh = box_3d_axons(1, length_factor=2)
    mesh.vertices *= 1e2
    for layout in ("cell", "pair"):
        S = emix.build_solver(mesh, dtype=torch.float64, device="cuda",
                              pair=layout == "pair")
        state = S._initial_state(0.0)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2024)
        c = state["c"] * (0.99 + 0.02 * torch.rand(state["c"].shape, generator=gen,
                                                     device="cuda", dtype=torch.float64))
        call = torch.cat([c, state["c_elim"][None]]).contiguous()
        pM, Ich, Itot = S._pads(state)
        p = S.params
        # K14: the ODE inputs of a step at the perturbed state, the jump of a
        # seeded potential
        phi = 1e-3 * torch.randn(state["phi"].shape, generator=gen, device="cuda",
                                 dtype=torch.float64)
        st = dict(state, c=c.contiguous(), phi_M=pM[:-1] * (0.9 + 0.2 * torch.rand(
            pM[:-1].shape, generator=gen, device="cuda", dtype=torch.float64)))
        pushed = S._ode_inputs(st, first_step=False)
        out = [t for tag in sorted(pushed) for t in (pushed[tag].states, pushed[tag].params)]
        out.append(asm.jump_phi_M_m(S.g, S.mem_dev, phi))
        torch.cuda.synchronize()
        print(f"digest  ode_inputs   {layout} {str(torch.float64):14s} {digest(out)}")
        fields = [(f, float(ion.z)) for f, ion in zip(list(c) + [state["c_elim"]],
                                                      S.ion_list)]
        for dtype in (torch.float32, torch.float64):
            g = {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point()
                     else v) for k, v in S.g.items()}
            # K11's facet blocks at the perturbed state's gradient
            gphi = asm.knp_cell(g, phi.to(dtype), c.to(dtype), p.dt)[0]
            m = S.N_ions
            out = asm.knp_facet(g, S.masks, S.z[:m].to(dtype).contiguous(),
                                S.D[:m].to(dtype).contiguous(), gphi, p.psi)
            torch.cuda.synchronize()
            print(f"digest  knp_facet    {layout} {str(dtype):14s} {digest(out)}")
            mem = {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point()
                       else v) for k, v in S.mem_dev.items()}
            kappa, _, flux, _ = asm.emi_cell_plain(g, S.z.to(dtype), S.D.to(dtype),
                                                   call.to(dtype), p.F, p.psi)
            out = asm.emi_facet(g, S.masks, kappa, flux, pM.to(dtype), mem, p.F, p.C_phi,
                                S.tau)
            torch.cuda.synchronize()
            print(f"digest  emi_facet    {layout} {str(dtype):14s} {digest(out)}")
            out = [t for f, z in fields for t in (
                asm.membrane_avg_m(g, mem, f.to(dtype), "p"),
                asm.membrane_avg_m(g, mem, f.to(dtype), "m"),
                asm.nernst_potential_m(g, mem, f.to(dtype), z, p.F, p.R, p.temperature))]
            out.append(asm.jump_phi_M_m(g, mem, phi.to(dtype)))
            torch.cuda.synchronize()
            print(f"digest  traces       {layout} {str(dtype):14s} {digest(out)}")
        if layout == "cell":
            (B, rhs, Pd), (BK, rhsK) = (
                S._assemble_emi(c, state["c_elim"], pM, Itot, state["t"]),
                S._knp_assemble_all(c, state["c_elim"], state["phi"], pM, Ich, Itot,
                                    state["t"], c))
            nbr = S.g["nbr"]
            for dtype in (torch.float32, torch.float64):
                # K5 at nd = 4 on the step's EMI and KNP diagonals and rhs
                invs = [spmv.block_jacobi_inverse(Pd.to(dtype).contiguous()),
                        spmv.block_jacobi_inverse(BK[:, 0].to(dtype).contiguous())]
                out = [spmv.block_jacobi_apply(P, r.to(dtype).contiguous())
                       for P, r in zip(invs, (rhs, rhsK))]
                torch.cuda.synchronize()
                print(f"digest  k5_apply     {layout} {str(dtype):14s} {digest(out)} "
                      f"(inverses {digest(invs)})")
            for dtype in (torch.float32, torch.float64):
                out = [spmv.bell_matvec(B.to(dtype), nbr, rhs.to(dtype)),
                       spmv.bell_matvec_multi(BK.to(dtype), nbr, rhsK.to(dtype))]
                torch.cuda.synchronize()
                print(f"digest  bell_matvec  {layout} {str(dtype):14s} {digest(out)} "
                      f"(operators {digest([B, BK])})")
            for dtype in (torch.float32, torch.float64):
                Bd = BK.to(dtype)
                Pinv = spmv.block_jacobi_inverse(Bd[:, 0].contiguous())
                gmres_digest(krylov, layout, dtype,
                             lambda V, Bd=Bd: spmv.bell_matvec_multi(Bd, nbr, V.contiguous()),
                             lambda r, Pinv=Pinv: spmv.block_jacobi_apply(Pinv, r.contiguous()),
                             rhsK.to(dtype), c.to(dtype))
        if layout == "pair":
            (pd, pe), rhs, _ = S._assemble_emi(c, state["c_elim"], pM, Itot, state["t"],
                                               pair=True)
            (pdK, peK), rhsK = S._knp_assemble_all(c, state["c_elim"], state["phi"], pM,
                                                   Ich, Itot, state["t"], c)
            pm = S.pairs
            for dtype in (torch.float32, torch.float64):
                r = pairs.to_pair(pm, rhs.to(dtype))
                rK = pairs.to_pair(pm, rhsK.to(dtype))
                out = [pairs.pair_matvec(pd.to(dtype), pe.to(dtype), pm, r),
                       pairs.pair_matvec_multi(pdK.to(dtype), peK.to(dtype), pm, rK)]
                torch.cuda.synchronize()
                print(f"digest  pair_matvec  {layout} {str(dtype):14s} {digest(out)} "
                      f"(operators {digest([pd, pe, pdK, peK])})")
            for dtype in (torch.float32, torch.float64):
                # K5 on the pair_bj halves of the step's EMI and KNP pair
                # diagonals: the halves form (a tree without it: the full
                # form on the same inverse) on the step's rhs
                hv = S._pair_bj_halves.to(dtype)
                invs = [spmv.block_jacobi_inverse((pd.to(dtype) * hv).contiguous()),
                        spmv.block_jacobi_inverse((pdK.to(dtype) * hv[None]).contiguous())]
                rs = [pairs.to_pair(pm, rhs.to(dtype)), pairs.to_pair(pm, rhsK.to(dtype))]
                out = [bj_apply(spmv, P, r) for P, r in zip(invs, rs)]
                torch.cuda.synchronize()
                print(f"digest  k5_halves    {layout} {str(dtype):14s} {digest(out)} "
                      f"(inverses {digest(invs)})")
            print(f"k5      halves form in this tree: {halves_form(spmv)}")
            for dtype in (torch.float32, torch.float64):
                # the solver's block-Jacobi pair KNP solve: the pair_bj
                # halves of the diagonal, its halves form (full form in a
                # tree without it), the live mask after the apply
                pdd, ped = pdK.to(dtype), peK.to(dtype)
                lm = S._pair_mask.to(dtype)[None]
                Pinv = spmv.block_jacobi_inverse(
                    (pdd * S._pair_bj_halves[None].to(dtype)).contiguous())
                if halves_form(spmv):
                    Pinv = spmv.block_jacobi_operands(Pinv, halves=True, buffer=True)
                gmres_digest(krylov, layout, dtype,
                             lambda V, pdd=pdd, ped=ped: pairs.pair_matvec_multi(
                                 pdd, ped, pm, V.contiguous()),
                             lambda r, Pinv=Pinv, lm=lm: spmv.block_jacobi_apply(
                                 Pinv, r.contiguous()) * lm,
                             pairs.to_pair(pm, rhsK.to(dtype)), pairs.to_pair(pm, c.to(dtype)))
        if layout == "pair":
            k12_digests(S, asm, pairs, c, state, pM, Ich, Itot)
        k11_digests(S, asm, layout, c, call, phi, st)
        k10_digests(S, asm, layout, call, pM)
        k9_start_digests(S, layout)
        # K6 on the pc build's EMI data (the Ritz harvest runs K6 itself)
        sp = emix.solver_params(error_if_not_converged=False)
        pcs = S.attach_pc(state, sp)["pc"]
        pc = pcs["emi"]
        agg = sp.agg_size // 2 if layout == "pair" else sp.agg_size
        nd, nc = pc["mom_W"].shape[1:]
        r64, out64 = torch.randn((2, 1, nd, nc), generator=gen, device="cuda",
                                 dtype=torch.float64)
        masked = "mask" in inspect.signature(coarse.coarse_add).parameters
        for dtype in (torch.float32, torch.float64):
            co = coarse.operands({k: v.to(dtype) for k, v in pc.items()}, agg, batched=False)
            rc, proj = coarse.restrict(co, r64.to(dtype))
            torch.cuda.synchronize()
            print(f"digest  k6_restrict  {layout} {str(dtype):14s} {digest([rc, proj])} "
                  f"(operands {digest([v.to(dtype) for v in pc.values()])}, "
                  f"{co.sizes[2]} Ritz fields)")
            zc, coef = coarse.solve(co, rc, proj)
            out = coarse.prolong_add(co, out64.to(dtype), zc, coef)
            torch.cuda.synchronize()
            print(f"digest  k6_prolong   {layout} {str(dtype):14s} {digest([out])}")
            if layout == "pair":
                # the solver's masked EMI apply: the mask in the prolong-add
                # (a tree without it: the product after it)
                lm = S._pair_mask.to(dtype)
                base = out64.to(dtype, copy=True)
                out = (coarse.prolong_add(co, base, zc, coef, lm) if masked
                       else coarse.prolong_add(co, base, zc, coef) * lm)
                torch.cuda.synchronize()
                print(f"digest  k6_prolong_m {layout} {str(dtype):14s} {digest([out])}")
        # K7's apply on the pc build's KNP data, as the KNP solve calls it
        # (on pairs masked: in the apply, or a tree without it after)
        pk = pcs["knp"]
        nd, nc = (S.nd, S.n_cells) if layout == "cell" else (2 * S.nd, S.pairs["int_f"].shape[0])
        m = pk["inv"].shape[0]
        r64, out64 = torch.randn((2, m, nd, nc), generator=gen, device="cuda",
                                 dtype=torch.float64)
        print(f"k7      mask in the apply in this tree: {masked}")
        for dtype in (torch.float32, torch.float64):
            co = coarse.operands({k: v.to(dtype) for k, v in pk.items()}, agg, batched=True)
            lm = S._pair_mask.to(dtype) if layout == "pair" else None
            outs = []
            for _ in range(2):
                base = out64.to(dtype, copy=True)
                if masked:
                    out = coarse.coarse_add(co, base, r64.to(dtype), lm)
                else:
                    out = coarse.coarse_add(co, base, r64.to(dtype))
                    out = out if lm is None else out * lm
                outs.append(out)
            torch.cuda.synchronize()
            print(f"digest  k7_coarse    {layout} {str(dtype):14s} {digest(outs)} "
                  f"(operands {digest([v.to(dtype) for v in pk.values()])})")
        ode_digests(S, mesh, st, layout, gen)
        del S
        torch.cuda.empty_cache()
    nd3_digests()


def nd3_digests():
    """The nd3 lines (see the module docstring); a tree without the MMS
    path prints that it has none."""
    try:
        import chip_smoke
        from knpemidg_tpu_torch.mms import problems  # noqa: F401
    except ImportError:
        print("nd3     no MMS path in this tree")
        return
    from knpemidg_tpu_torch.ops import coarse, spmv
    from knpemidg_tpu_torch.solvers import krylov
    from knpemidg_tpu_torch.solvers.twolevel import build_two_level, make_two_level

    S, _ = chip_smoke.mms_solver(chip_smoke.MMS_SPACE_RES[-1], chip_smoke.MMS_DT_SPACE,
                                 "space")
    S.splitting_scheme = False
    st = S.attach_pc(S._initial_state(0.0), chip_smoke.mms_params_direct())
    pM, _, It = S._pads(st)
    B, rhs, Pd = S._assemble_emi(st["c"], st["c_elim"], pM, It, st["t"])
    BK, rhsK = S._knp_assemble_mms(st["c"], st["phi"], st["t"])
    nbr, agg = S.g["nbr"], chip_smoke.AGG
    oh, ids = S._comp_arrays()
    inputs = digest([B, rhs, Pd, BK, rhsK])
    for dtype in (torch.float32, torch.float64):
        systems = [(B.to(dtype), rhs.to(dtype))] + [(BK[k].to(dtype), rhsK[k].to(dtype))
                                                     for k in range(BK.shape[0])]
        out = [spmv.bell_matvec(b, nbr, x) for b, x in systems]
        torch.cuda.synchronize()
        print(f"digest  k1_nd3       mms {str(dtype):14s} {digest(out)} (operators {inputs})")
        Ps = [Pd.to(dtype).contiguous()] + [b[0].contiguous() for b, _ in systems[1:]]
        invs = [spmv.block_jacobi_inverse(P) for P in Ps]
        out = [spmv.block_jacobi_apply(i, x) for i, (_, x) in zip(invs, systems)]
        torch.cuda.synchronize()
        print(f"digest  k5_nd3       mms {str(dtype):14s} {digest(out)} (inverses "
              f"{digest(invs)})")
        b0, x0 = systems[0]
        datas = [build_two_level(b0, nbr, agg, sym=True, comp_onehot=oh.to(dtype),
                                 comp_ids=ids, extra_diag=Ps[0] - b0[0], ridge=1e-5),
                 build_two_level(systems[1][0], nbr, agg, sym=False,
                                 mass_diag=(S.g["vol"] / S.params.dt).to(dtype), ridge=1e-5)]
        out = []
        for data, (_, x) in zip(datas, systems):
            co = coarse.operands(data, agg, batched=False)
            rc, proj = (t.clone() for t in coarse.restrict(co, x[None].contiguous()))
            zc, coef = (t.clone() for t in coarse.solve(co, rc, proj))
            out += [rc, proj, zc, coef, coarse.prolong_add(co, x[None].clone(), zc, coef)]
        torch.cuda.synchronize()
        print(f"digest  k6_nd3       mms {str(dtype):14s} {digest(out)} (operands "
              f"{digest([v for d in datas for v in d.values()])})")
        bK, xK = systems[1]
        pc = make_two_level(bK, bK[0], nbr, agg, sym=False,
                            mass_diag=(S.g["vol"] / S.params.dt).to(dtype), ridge=1e-5)
        c0 = st["c"][0].to(dtype)
        mv = lambda v, bK=bK: spmv.bell_matvec(bK, nbr, v.contiguous())
        r0 = (xK - mv(c0)).contiguous()
        res = krylov.gmres(mv, r0, torch.zeros_like(r0), pc, rtol=1e-12, atol=0.0, max_it=5000,
                           restart=40, b_ref=xK)
        torch.cuda.synchronize()
        print(f"digest  k9_gmres1    mms {str(dtype):14s} "
              f"{digest([res.x, torch.tensor([res.iters]), res.resnorm])} "
              f"(iterations {res.iters})")


def k12_digests(S, asm, pairs, c, state, pM, Ich, Itot):
    """K12 on the inputs the step's two pair assemblies hand it (the EMI
    emit with reg, the KNP emit with the static operator), both dtypes; a
    tree with emit_buffers emits as its step does, twice into the same
    buffers (the second emit's outputs digested)."""
    names = ("gather_blocks_pair", "gather_blocks_pair_multi")
    originals = {n: getattr(asm, n) for n in names}
    emits = {}

    def capture(name):
        def wrapped(*args, **kw):
            emits[name] = (args[2:], kw)
            return originals[name](*args, **kw)
        return wrapped

    try:
        for n in names:
            setattr(asm, n, capture(n))
        S._assemble_emi(c, state["c_elim"], pM, Itot, state["t"], pair=True)
        S._knp_assemble_all(c, state["c_elim"], state["phi"], pM, Ich, Itot, state["t"], c)
    finally:
        for n, fn in originals.items():
            setattr(asm, n, fn)
    pm = S.pairs
    buffered = hasattr(pairs, "emit_buffers")
    print(f"k12     emit into buffers in this tree: {buffered}")
    for dtype in (torch.float32, torch.float64):
        cast = lambda ts: [t.to(dtype).contiguous() for t in ts]
        e_args, k_args = cast(emits[names[0]][0]), cast(emits[names[1]][0])
        reg = emits[names[0]][1]["reg"].to(dtype)
        add = tuple(cast(emits[names[1]][1]["add"]))
        kw_e, kw_k = {}, {}
        if buffered:
            kw_e["out"] = pairs.emit_buffers(pm, S.nd, dtype, "cuda", diag=True)
            kw_k["out"] = pairs.emit_buffers(pm, S.nd, dtype, "cuda", m=k_args[0].shape[0])
        for _ in range(2 if buffered else 1):
            out = [*pairs.gather_blocks_pair(None, pm, *e_args, reg=reg, **kw_e),
                   *pairs.gather_blocks_pair_multi(None, pm, *k_args, add=add, **kw_k)]
        torch.cuda.synchronize()
        print(f"digest  k12_emit     pair {str(dtype):14s} {digest(out)} "
              f"(inputs {digest(e_args + k_args + [reg, *add])})")


def k11_digests(S, asm, layout, c, call, phi, st):
    """K11's membrane rhs and emit (k11_emit) at the perturbed state with
    seeded channel currents, both dtypes: b_p, b_m, the blocks (the drift
    blocks on pairs, the operator with the static part on cells) and the
    rhs; a tree with knp_membrane_emit from its one call (its static
    tables built once), twice into the same buffers (the second call's
    outputs digested), a tree without it
    from knp_membrane_rhs and knp_emit_cell."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2026)
    p, m, pair = S.params, S.N_ions, layout == "pair"
    pM = torch.cat([st["phi_M"], st["phi_M"].new_zeros(1)])
    Ich = 1e-2 * torch.randn((len(S.ion_list), pM.shape[0]), generator=gen, device="cuda",
                             dtype=torch.float64)
    Ich[:, -1] = 0.0
    sys.path.insert(0, TESTS)
    from torch_k11_inputs import k11_inputs

    one = hasattr(asm, "knp_membrane_emit")
    print(f"k11     one membrane emit call in this tree: {one}")
    for dtype in (torch.float32, torch.float64):
        g, mem, mem_args, drift, M, b_cell, statics = k11_inputs(S, asm, dtype, c, call, phi,
                                                                 pM, Ich)
        z, D = mem_args[:2]
        if one:
            out = asm.knp_emit_buffers(g, mem, m, dtype, "cuda", pair)
            tab = asm.knp_emit_tables(g, mem)
            for _ in range(2):
                blocks, rhs, b_p, b_m = asm.knp_membrane_emit(
                    g, mem, *mem_args, p.F, p.C_M, p.dt, p.psi, drift, None if pair else M,
                    b_cell, statics, pair=pair, out=out, tables=tab)
        else:
            b_p, b_m = asm.knp_membrane_rhs(g, mem, *mem_args, p.F, p.C_M, p.dt)
            blocks, rhs = asm.knp_emit_cell(g, mem, z, D, p.psi, drift, *M, b_cell, b_p, b_m,
                                            statics, pair=pair)
        torch.cuda.synchronize()
        print(f"digest  k11_emit     {layout} {str(dtype):14s} "
              f"{digest([b_p, b_m, blocks, rhs])} "
              f"(inputs {digest(list(mem_args) + [drift, b_cell])})")


def k10_digests(S, asm, layout, call, pM):
    """K10's emit (k10_emit) on the step's facet blocks and rhs parts at the
    perturbed state, both dtypes: the operator, rhs and P_diag on cells,
    A_cell, rhs and reg on pairs; a tree whose emit reads the solver's
    packed slot words (``tables``) emits as its step does, twice into the
    same buffers (the second emit's outputs digested), a tree without them
    through its one call."""
    p, pair = S.params, layout == "pair"
    shared = "tables" in inspect.signature(asm.emi_emit_cell).parameters
    print(f"k10     emit from the shared slot words in this tree: {shared}")
    for dtype in (torch.float32, torch.float64):
        cast = lambda d: {k: (v.to(dtype) if isinstance(v, torch.Tensor)
                              and v.is_floating_point() else v) for k, v in d.items()}
        g, mem = cast(S.g), cast(S.mem_dev)
        kappa, kbar, flux, b_cell = asm.emi_cell_plain(g, S.z.to(dtype), S.D.to(dtype),
                                                       call.to(dtype), p.F, p.psi)
        *M, b_p, b_m = asm.emi_facet_plain(g, S.masks, kappa, flux, pM.to(dtype), mem, p.F,
                                           p.C_phi, S.tau)
        args = (g, kbar, *M, b_cell, b_p, b_m, 1.0 / S.Lp ** 2)
        if shared:
            out = asm.emi_emit_buffers(g, dtype, "cuda", pair)
            tab = asm.knp_emit_tables(g, mem)
            for _ in range(2):
                got = asm.emi_emit_cell(*args, pair=pair, out=out, tables=tab)
        else:
            got = asm.emi_emit_cell(*args, pair=pair)
        torch.cuda.synchronize()
        print(f"digest  k10_emit     {layout} {str(dtype):14s} {digest(got)} "
              f"(inputs {digest(list(args[1:-1]))})")


def k9_start_digests(S, layout):
    """K9's cycle start (k9_start) on a seeded residual of the layout's KNP
    batch (2 systems of nd x cells, restart 30), both dtypes, twice on one
    work: V[0], beta, R, g, cs, sn, ks and the flag of the second call."""
    from knpemidg_tpu_torch.ops import krylov_ops as ko

    n = (2 * S.nd * S.pairs["int_f"].shape[0] if layout == "pair" else S.nd * S.n_cells)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2027)
    r64 = torch.randn((2, n), generator=gen, device="cuda", dtype=torch.float64)
    for dtype in (torch.float32, torch.float64):
        r = r64.to(dtype)
        wk = ko.gmres_work(2, n, 30, dtype, "cuda")
        wk.tol.copy_(torch.tensor([1e-3, 1e6], dtype=dtype))
        for _ in range(2):
            ko.gmres_start(r, wk)
        torch.cuda.synchronize()
        print(f"digest  k9_start     {layout} {str(dtype):14s} "
              f"{digest([wk.V[0], wk.beta, wk.R, wk.g, wk.cs, wk.sn, wk.ks, wk.flag])}")


def halves_form(spmv):
    """Whether a tree's K5 apply has the halves form (and its operands)."""
    return hasattr(spmv, "block_jacobi_operands")


def bj_apply(spmv, Pinv, r):
    """K5's apply of a halves inverse as the tree's solver applies it on the
    pair layout: the halves form through its operands where the tree has
    it, else the full form."""
    if halves_form(spmv):
        return spmv.block_jacobi_apply(spmv.block_jacobi_operands(Pinv, halves=True), r)
    return spmv.block_jacobi_apply(Pinv, r)


def gmres_digest(krylov, layout, dtype, mv, pc, rhs, c):
    """K9 through krylov.gmres_batched as the solver's KNP solve calls it
    (increment form: r0 = rhs - A c from a zero guess, the tolerance from
    the preconditioned rhs, emix.solver_params()'s rtol / atol / restart /
    iteration cap) on the step's two-ion system with a block-Jacobi
    preconditioner (more Arnoldi steps and restarts than the two-level
    one): the correction x, every system's iterations and the final
    residual norms."""
    from knpemidg_tpu_torch import emix

    sp = emix.solver_params()
    r0 = (rhs - mv(c)).contiguous()
    res = krylov.gmres_batched(mv, r0, torch.zeros_like(r0), pc, rtol=sp.rtol_knp,
                               atol=sp.atol_knp, max_it=sp.max_it_knp,
                               restart=sp.gmres_restart, b_ref=rhs)
    torch.cuda.synchronize()
    iters = torch.tensor(res.iters, dtype=torch.int64)
    print(f"digest  k9_gmres     {layout} {str(dtype):14s} "
          f"{digest([res.x, iters, res.resnorm])} (iterations {res.iters})")


def ode_digests(S, mesh, st, layout, gen):
    """K13 through Solver._ode_step: both dtypes (the float32 state on a
    float32 solver of the same mesh), both schemes, both first_step values."""
    import dataclasses

    from knpemidg_tpu_torch import emix
    from knpemidg_tpu_torch.membrane import engine

    mem = {tag: engine.MembraneState(
        mm.states * (0.98 + 0.04 * torch.rand(mm.states.shape, generator=gen, device="cuda",
                                              dtype=torch.float64)), mm.params, mm.model)
        for tag, mm in st["mem"].items()}
    st = dict(st, mem=mem, t=torch.tensor(0.3, dtype=torch.float64, device="cuda"))
    params = S.params
    for dtype in (torch.float32, torch.float64):
        Sd = S if dtype == torch.float64 else emix.build_solver(
            mesh, dtype=dtype, device="cuda", pair=layout == "pair")
        cast = {k: (v.to(dtype) if isinstance(v, torch.Tensor) else v) for k, v in st.items()}
        cast["mem"] = {tag: engine.MembraneState(mm.states.to(dtype), mm.params.to(dtype),
                                                 mm.model) for tag, mm in mem.items()}
        for scheme in ("rk4", "rush_larsen"):
            Sd.params = dataclasses.replace(params, ode_scheme=scheme)
            for first in (True, False):
                new = Sd._ode_step(cast, first_step=first)
                out = [t for tag in sorted(new["mem"]) for t in (new["mem"][tag].states,
                                                                   new["mem"][tag].params)]
                torch.cuda.synchronize()
                print(f"digest  ode_step     {layout} {str(dtype):14s} {scheme:11s} "
                      f"first_step={first!s:5s} {digest(out + [new['phi_M'], new['I_ch']])}")
        Sd.params = params


if __name__ == "__main__":
    main()
