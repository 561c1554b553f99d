"""The inputs of K11's membrane rhs and emit (ops.assembly.knp_membrane_emit)
as the solver's step makes them; this module holds no tests of its own.

Shared by the card tests (tests/test_torch_cuda.py) and the card scripts
kernel_digest.py and time_wrappers.py, which pass the ``assembly`` module of
the tree they measure.
"""
import torch


def k11_inputs(S, asm, dtype, c, call, phi, pM, Ich):
    """K11's membrane rhs and emit inputs in ``dtype`` as the step makes
    them from the concentrations c (m, nd, nc), all of them ``call``, the
    potential phi, the padded phi_M and channel currents, through ``asm``
    (the port's ops.assembly): (g, mem, the membrane arguments (z, D, c,
    alpha_sum, phi, phi_M, I_ch, I_ch_tot), drift, the facet blocks,
    b_cell, the cell layout's static operator)."""
    p, m = S.params, S.N_ions
    cast = lambda d: {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point()
                          else v) for k, v in d.items()}
    g, mem = cast(S.g), cast(S.mem_dev)
    z, D = S.z[:m].to(dtype).contiguous(), S.D[:m].to(dtype).contiguous()
    ck, ph = c.to(dtype).contiguous(), phi.to(dtype).contiguous()
    asum = asm.alpha_sum(S.z.to(dtype), S.D.to(dtype), call.to(dtype))
    gphi, drift, b_cell = asm.knp_cell(g, ph, ck, p.dt)
    M = asm.knp_facet(g, S.masks, z, D, gphi, p.psi)
    Ik = Ich.to(dtype)
    statics = None if S.pair_layout else torch.stack(
        [S._knp_static(k) for k in range(m)]).to(dtype).contiguous()
    return (g, mem, (z, D, ck, asum, ph, pM.to(dtype), Ik[:m].contiguous(), Ik.sum(dim=0)),
            drift, M, b_cell, statics)
