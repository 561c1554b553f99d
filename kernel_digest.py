#!/usr/bin/env python3
"""SHA-256 digests of the outputs of kernels K10 emi_facet and K3
pair_matvec / pair_matvec_multi on the card, at chip_smoke.py's
configuration (box_3d_axons(1, length_factor=2) in cm, the EMIx solver) in
float32 and float64: emi_facet on the cell and the pair layout's facet
tables at a state perturbed with a seeded generator, and the pair matvecs
on the step's EMI and two-ion KNP operators applied to the step's rhs.

The package is imported from ``--root`` (default: this file's directory),
so two trees, such as an unpacked parent commit and this one, can be held
to the same bits: equal digests mean bitwise equal outputs (a zero's sign
included).

Usage:  python3 kernel_digest.py [--root DIR]   (needs a CUDA card)
"""
import argparse
import hashlib
import os
import sys

import torch


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
    from knpemidg_tpu_torch.ops import assembly as asm, pairs

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
        for dtype in (torch.float32, torch.float64):
            g = {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point()
                     else v) for k, v in S.g.items()}
            mem = {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point()
                       else v) for k, v in S.mem_dev.items()}
            kappa, _, flux, _ = asm.emi_cell_plain(g, S.z.to(dtype), S.D.to(dtype),
                                                   call.to(dtype), p.F, p.psi)
            out = asm.emi_facet(g, S.masks, kappa, flux, pM.to(dtype), mem, p.F, p.C_phi,
                                S.tau)
            torch.cuda.synchronize()
            print(f"digest  emi_facet    {layout} {str(dtype):14s} {digest(out)}")
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
        del S
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
