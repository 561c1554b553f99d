"""The plain versions of the assembly kernels (K10, K11, K14) of the port,
one per kernel entry point, against the JAX functions they mirror, in
float64 to 1e-12: on the EMIx fixture (3D) and the 2D neuron at a state
perturbed from the initial one with numpy-seeded noise, and on the
interleaved pair layout.  The JAX side runs on the CPU as in its own tests."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_parity as tp
from test_torch_parity import rel, t64

from knpemidg_tpu.ops import assembly as jasm
from knpemidg_tpu_torch.ops import assembly, pairs

TOL = 1e-12

FIXTURES = {"emix": (lambda: tp.emix_jax()[0], lambda: tp.emix_torch()[0]),
            "neuron2d": (lambda: tp.neuron_2d_jax()[0], lambda: tp.neuron_2d_torch()[0])}


def _state(Sj, seed=11):
    """Seeded inputs in the solver's cell numbering (numpy)."""
    rng = np.random.default_rng(seed)
    nc = np.asarray(Sj.c_init).shape[-1]
    scale = float(np.abs(np.asarray(Sj._initial_state(0.0)["phi_M"])).max())
    c = np.asarray(Sj.c_init) * rng.uniform(0.99, 1.01, Sj.c_init.shape)
    c_elim = np.asarray(Sj.c_elim_init) * rng.uniform(0.99, 1.01, Sj.c_elim_init.shape)
    phi_M = np.concatenate([rng.standard_normal(Sj.n_mem) * scale, [0.0]])
    I_ch = np.concatenate([rng.standard_normal((len(Sj.ion_list), Sj.n_mem)) * 1e-2,
                           np.zeros((len(Sj.ion_list), 1))], axis=1)
    return dict(c=c, c_elim=c_elim, call=np.concatenate([c, c_elim[None]]),
                phi=rng.standard_normal((Sj.nd, nc)) * 0.1 * scale,
                phi_M=phi_M, I_ch=I_ch, I_tot=I_ch.sum(axis=0))


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def solvers(request):
    jb, tb = FIXTURES[request.param]
    Sj, St = jb(), tb()
    return Sj, St, _state(Sj)


def _facet_blocks(rng, lead, nd, nf1):
    """Seeded facet blocks with a zero dummy facet (the last column)."""
    Ms = rng.standard_normal((4,) + lead + (nd, nd, nf1))
    Ms[..., -1] = 0.0
    return Ms


def test_inverse_membrane_map(solvers):
    _, St, _ = solvers
    inv = tp.to_np(St.mem_dev["inv"])
    fidx = tp.to_np(St.mem_dev["fidx"])
    assert St.mem_dev["inv"].dtype == torch.int32
    assert inv.shape == (St.g["f_area"].shape[0],)
    assert np.array_equal(inv[fidx], np.arange(St.n_mem))
    off = np.ones(inv.shape, dtype=bool)
    off[fidx] = False
    assert np.all(inv[off] == -1)


G_TABLES = assembly._EMI_FACET_TABLES + ("G", "vol", "phibar", "GG", "M0", "cf_idx",
                                          "cf_is_plus")
MEM_TABLES = ("Rp", "Rm", "cp", "cm", "fidx", "inv")


def _check_tables(St):
    """The static tables the kernels read: contiguous, floats in the
    solver's dtype, indices int32, masks bool."""
    for src, keys in ((St.g, G_TABLES), (St.mem_dev, MEM_TABLES),
                      (St.masks, ("f_sip", "f_mem"))):
        for key in keys:
            t = src[key]
            assert t.is_contiguous(), key
            assert t.dtype in (torch.float64, torch.int32, torch.bool), key


def test_kernel_tables_are_contiguous(solvers):
    _check_tables(solvers[1])


def test_emi_cell_matches_reference_formulas(solvers):
    Sj, St, x = solvers
    p = Sj.params
    kappa, kbar, flux, b_cell = assembly.emi_cell_plain(
        St.g, St.z, St.D, t64(x["call"]), p.F, p.psi)
    gj = Sj.g
    kj = p.F * p.psi * jnp.einsum("k,kc,kic->ic", Sj.z * Sj.z, Sj.D, jnp.asarray(x["call"]))
    fj = jnp.einsum("k,kc,kdc->dc", Sj.z, Sj.D,
                    jnp.einsum("idc,kic->kdc", gj["G"], jnp.asarray(x["call"])))
    assert rel(kappa, kj) < TOL
    assert rel(kbar, jnp.einsum("i,ic->c", gj["phibar"], kj)) < TOL
    assert rel(flux, fj) < TOL
    assert rel(b_cell, -p.F * gj["vol"] * jnp.einsum("dc,idc->ic", fj, gj["G"])) < TOL
    assert all(t.is_contiguous() for t in (kappa, kbar, flux, b_cell))


def _cell_parts_through_the_step_route(Sj, St, x):
    """K10's emi_cell and K11's knp_cell as the step calls them (the
    solver's cell tables, the step's buffers): on the CPU the plain
    results, copied into the buffers and returned, exactly; and the cell
    parts of the JAX assemble_emi (kappa, kbar, the ion flux, the rhs cell
    term) and assemble_knp_all (grad phi, the drift, the mass rhs) to
    float64 round-off."""
    p = St.params
    tab = St._cell_tables()
    assert St._cell_tables() is tab                           # built once
    eo, ko_ = St._emit_out("emi_emit"), St._emit_out("membrane_emit")
    call, c, phi = t64(x["call"]), t64(x["c"]), t64(x["phi"])
    emi = assembly.emi_cell(St.g, St.z, St.D, call, p.F, p.psi, out=eo, tables=tab)
    knp = assembly.knp_cell(St.g, phi, c, p.dt, out=ko_, tables=tab)
    assert [a is b for a, b in zip(emi, (eo.kappa, eo.kbar, eo.flux, eo.b_cell))] == [True] * 4
    assert [a is b for a, b in zip(knp, (ko_.gphi, ko_.drift, ko_.b_cell))] == [True] * 3
    for got, ref in ((emi, assembly.emi_cell_plain(St.g, St.z, St.D, call, p.F, p.psi)),
                     (knp, assembly.knp_cell_plain(St.g, phi, c, p.dt))):
        assert len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref))
    gj, cj, phij = Sj.g, jnp.asarray(x["call"]), jnp.asarray(x["phi"])
    kj = p.F * p.psi * jnp.einsum("k,kc,kic->ic", Sj.z * Sj.z, Sj.D, cj)
    fj = jnp.einsum("k,kc,kdc->dc", Sj.z, Sj.D, jnp.einsum("idc,kic->kdc", gj["G"], cj))
    want = (kj, jnp.einsum("i,ic->c", gj["phibar"], kj), fj,
            -p.F * gj["vol"] * jnp.einsum("dc,idc->ic", fj, gj["G"]))
    assert all(rel(a, b) < TOL for a, b in zip(emi, want))
    gphi = jasm.cell_grad(gj, phij)
    want = (gphi, jnp.einsum("idc,dc->ic", gj["G"], gphi),
            (gj["vol"] / p.dt) * jnp.einsum("ij,kjc->kic", jasm._M0(gj),
                                            jnp.asarray(x["c"])))
    assert all(rel(a, b) < TOL for a, b in zip(knp, want))


def test_cell_parts_through_the_step_route(solvers):
    _cell_parts_through_the_step_route(*solvers)


def test_solver_passes_its_cell_tables_and_step_buffers(monkeypatch):
    """Two steps of the 2D neuron: every EMI and KNP cell part reads the
    solver's one cell table (the pc build's too), and only _pde_step's
    write into the step's buffers (the pc build's EMI and KNP assemblies
    get new tensors); a new cell numbering drops the tables with the emit
    buffers."""
    seen = {"emi_cell": [], "knp_cell": []}
    for name in seen:
        fn = getattr(assembly, name)

        def spy(*args, out=None, tables=None, _fn=fn, _name=name, **kw):
            seen[_name].append((out, tables))
            return _fn(*args, out=out, tables=tables, **kw)

        monkeypatch.setattr(assembly, name, spy)
    S, sp = tp.neuron_2d_torch()
    S.solve_system_active(2e-4, 0.0, sp)
    tab = S._cell_tables()
    eo, ko_ = S._emit_out("emi_emit"), S._emit_out("membrane_emit")
    assert len(seen["emi_cell"]) == len(seen["knp_cell"]) == 3
    assert all(t is tab for calls in seen.values() for _, t in calls)
    assert seen["emi_cell"][0][0] is None and seen["knp_cell"][0][0] is None
    assert all(o is eo for o, _ in seen["emi_cell"][1:])
    assert all(o is ko_ for o, _ in seen["knp_cell"][1:])
    S._invalidate_caches()
    assert S._cell_tables() is not tab


def _ion_sums_through_the_step_route(Sj, St, x):
    """K11's alpha_sum and K14's eliminated_concentration as the step calls
    them (the solver's cell tables: z, D and rho; c and c_elim apart; alpha
    into the step's buffer): on the CPU the plain results on the
    concatenation exactly, alpha_sum against the JAX step's einsum over the
    concatenation (knpemidg_tpu/solver.py) and eliminated_concentration
    against the JAX function, both to 1e-14; and the kernels' ordered twins
    (the card's arithmetic) to round-off."""
    tab, ko_ = St._cell_tables(), St._emit_out("membrane_emit")
    assert tab.z is St.z and tab.D is St.D and tab.rho is St.rho
    c, ce, call = t64(x["c"]), t64(x["c_elim"]), t64(x["call"])
    got = assembly.alpha_sum(St.z, St.D, c, ce, out=ko_, tables=tab)
    assert got is ko_.alpha and got.is_contiguous()
    assert torch.equal(got, assembly.alpha_sum_plain(St.z, St.D, call))
    want = jnp.einsum("k,kc,kic->ic", Sj.z ** 2, Sj.D, jnp.asarray(x["call"]))
    assert rel(got, want) < 1e-14
    assert rel(assembly.alpha_sum_ordered_plain(St.z, St.D, c, ce), want) < 1e-14
    el = assembly.eliminated_concentration(c, tables=tab)
    z_elim = float(Sj.ion_list[-1].z)
    want = jasm.eliminated_concentration(jnp.asarray(x["c"]), Sj.z[:-1], Sj.rho, z_elim)
    assert el.is_contiguous() and rel(el, want) < 1e-14
    assert torch.equal(el, assembly.eliminated_concentration_plain(c, St.z[:-1], St.rho,
                                                                   z_elim))
    assert rel(assembly.eliminated_concentration_ordered_plain(c, St.z[:-1], St.rho, z_elim),
               want) < 1e-14
    with pytest.raises(ValueError):          # the tables carry z, rho and z_elim
        assembly.eliminated_concentration(c, St.z[:-1], St.rho, z_elim, tables=tab)
    for kw in ({}, {"out": ko_}):            # c_elim and out go with the tables
        with pytest.raises(ValueError):
            assembly.alpha_sum(St.z, St.D, c, ce, **kw)
    with pytest.raises(ValueError):
        assembly.alpha_sum(St.z, St.D, call, out=ko_)


def test_ion_sums_through_the_step_route(solvers):
    _ion_sums_through_the_step_route(*solvers)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fma_emulation_rounds_once(dtype):
    """assembly._fma (the eliminated kernel's ordered twin) equals a * b + c
    rounded once, from exact rational arithmetic, on seeded inputs with
    heavy cancellation, a zero addend and the kernel's magnitudes."""
    from fractions import Fraction
    rng = np.random.default_rng(23)
    n = 3000
    a = rng.standard_normal(n) * 3
    b = rng.uniform(0.5, 150.0, n)
    c = rng.standard_normal(n) * 100
    c[: n // 2] = -(a[: n // 2] * b[: n // 2]) * (1 + 1e-6 * rng.standard_normal(n // 2))
    c[n // 2: n // 2 + 50] = 0.0
    a, b, c = (torch.as_tensor(v).to(dtype) for v in (a, b, c))
    got = assembly._fma(a, b, c)
    tiny = np.float32 if dtype == torch.float32 else np.float64
    for ga, aa, bb, cc in zip(got.tolist(), a.tolist(), b.tolist(), c.tolist()):
        v = Fraction(aa) * Fraction(bb) + Fraction(cc)
        r = tiny(float(v))                # nearest double, then the dtype's neighbours
        cands = (np.nextafter(r, tiny(-np.inf)), r, np.nextafter(r, tiny(np.inf)))
        best = min(cands, key=lambda q: (abs(Fraction(float(q)) - v),
                                         int(np.array(q).view(f"i{np.dtype(tiny).itemsize}"))
                                         & 1))
        assert ga == float(best)


def test_solver_routes_its_ion_sums_through_its_tables(monkeypatch):
    """Two steps of the 2D neuron: every alpha_sum reads the solver's cell
    tables (the pc build's KNP assembly too) and writes the step's alpha
    buffer only from _pde_step; every eliminated_concentration reads the
    tables and returns a new tensor (the state keeps it)."""
    seen = {"alpha_sum": [], "eliminated_concentration": []}
    for name in seen:
        fn = getattr(assembly, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            res = _fn(*args, **kw)
            seen[_name].append((kw.get("out"), kw.get("tables"), res))
            return res

        monkeypatch.setattr(assembly, name, spy)
    S, sp = tp.neuron_2d_torch()
    S.solve_system_active(2e-4, 0.0, sp)
    tab, ko_ = S._cell_tables(), S._emit_out("membrane_emit")
    assert len(seen["alpha_sum"]) == 3 and len(seen["eliminated_concentration"]) == 2
    assert all(t is tab for calls in seen.values() for _, t, _ in calls)
    assert seen["alpha_sum"][0][0] is None
    assert all(o is ko_ and r is ko_.alpha for o, _, r in seen["alpha_sum"][1:])
    outs = [r for _, _, r in seen["eliminated_concentration"]]
    assert outs[0] is not outs[1] and not any(r is ko_.alpha for r in outs)


def test_emi_facet_blocks_match_jax(solvers):
    """The facet blocks against _sip_blocks + _jump_jump_blocks; the dummy
    facet's blocks are exactly zero."""
    Sj, St, x = solvers
    p = Sj.params
    kappa, _, flux, _ = assembly.emi_cell_plain(St.g, St.z, St.D, t64(x["call"]), p.F, p.psi)
    *M, b_p, b_m = assembly.emi_facet_plain(
        St.g, St.masks, kappa, flux, t64(x["phi_M"]), St.mem_dev, p.F, p.C_phi, St.tau)
    gj = Sj.g
    kj = jnp.asarray(tp.to_np(kappa))
    kp, km = jasm.facet_trace(gj, kj, "p"), jasm.facet_trace(gj, kj, "m")
    Sip = jasm._sip_blocks(gj, kp, km, jasm._gn(gj, "p"), jasm._gn(gj, "m"),
                           Sj.tau / gj["f_havg"], Sj.masks["f_sip"])
    Cj = jasm._jump_jump_blocks(gj, jnp.full_like(gj["f_area"], p.C_phi),
                                Sj.masks["f_mem"])
    for Mt, Ms, Mc in zip(M, Sip, Cj):
        assert rel(Mt, Ms + Mc) < TOL
        assert Mt.is_contiguous()
        assert float(Mt[..., -1].abs().max()) == 0.0
    assert float(b_p[:, -1].abs().max()) == 0.0 and float(b_m[:, -1].abs().max()) == 0.0


def test_emi_emit_cell_matches_jax_gathers(solvers):
    """Given the same facet blocks and rhs parts, the emit equals
    gather_blocks / gather_rhs and the regularised diagonal."""
    Sj, St, x = solvers
    rng = np.random.default_rng(12)
    nd, nc = St.nd, St.n_cells
    nf1 = St.g["f_area"].shape[0]
    Ms = _facet_blocks(rng, (), nd, nf1)
    bs = rng.standard_normal((3, nd, max(nc, nf1)))
    b_cell, b_p, b_m = bs[0][:, :nc], bs[1][:, :nf1], bs[2][:, :nf1]
    kbar = rng.uniform(0.5, 2.0, nc)
    inv_Lp2 = 1.0 / St.Lp ** 2
    blocks, rhs, Pd = assembly.emi_emit_cell_plain(
        St.g, t64(kbar), *(t64(M) for M in Ms), t64(b_cell), t64(b_p), t64(b_m), inv_Lp2)
    gj = Sj.g
    A_cell = (gj["vol"] * jnp.asarray(kbar)) * jasm._GG(gj)
    bj = jasm.gather_blocks(gj, A_cell, *(jnp.asarray(M) for M in Ms))
    rj = jasm.gather_rhs(gj, jnp.asarray(b_cell), jnp.asarray(b_p), jnp.asarray(b_m))
    reg = (gj["vol"] * jnp.asarray(kbar) / Sj.Lp ** 2) * jasm._M0(gj)[:, :, None]
    assert rel(blocks, bj) < TOL
    assert rel(rhs, rj) < TOL
    assert rel(Pd, bj[0] + reg) < TOL
    A_t, rhs_p, reg_t = assembly.emi_emit_cell_plain(
        St.g, t64(kbar), *(t64(M) for M in Ms), t64(b_cell), t64(b_p), t64(b_m), inv_Lp2,
        pair=True)
    assert rel(A_t, A_cell) < TOL and rel(reg_t, reg) < TOL
    assert torch.equal(rhs_p, rhs)


def _knp_parts(St, x, static_blocks=None):
    """The four steps of the port's KNP assembly at state x."""
    p = St.params
    m = St.N_ions
    z, D = St.z[:m], St.D[:m]
    asum = assembly.alpha_sum_plain(St.z, St.D, t64(x["call"]))
    gphi, drift, b_cell = assembly.knp_cell_plain(St.g, t64(x["phi"]), t64(x["c"]), p.dt)
    M = assembly.knp_facet_plain(St.g, St.masks, z, D, gphi, p.psi)
    b_p, b_m = assembly.knp_membrane_rhs_plain(
        St.g, St.mem_dev, z, D, t64(x["c"]), asum, t64(x["phi"]), t64(x["phi_M"]),
        t64(x["I_ch"][:m]), t64(x["I_tot"]), p.F, p.C_M, p.dt)
    return z, D, asum, drift, M, b_cell, b_p, b_m


def test_knp_facet_ordered_plain_matches_the_plain(solvers):
    """knp_facet_ordered_plain (the normal products summed in the kernel's
    order, the card tests' exact reference for K11) against knp_facet_plain
    on the fixture's facets at the state's potential gradient."""
    Sj, St, x = solvers
    p = St.params
    m = St.N_ions
    z, D = St.z[:m], St.D[:m]
    gphi = assembly.knp_cell_plain(St.g, t64(x["phi"]), t64(x["c"]), p.dt)[0]
    got = assembly.knp_facet_ordered_plain(St.g, St.masks, z, D, gphi, p.psi)
    ref = assembly.knp_facet_plain(St.g, St.masks, z, D, gphi, p.psi)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.is_contiguous()
        assert rel(a, b) < 1e-14
    assert float(sum(M.abs().sum() for M in ref)) > 0.0


def test_knp_upwind_blocks_and_membrane_rhs_match_jax(solvers):
    """The port's four KNP steps without the static operator against the
    JAX all-ion assembly without it: the upwind blocks, the drift cell
    blocks and the membrane rhs."""
    Sj, St, x = solvers
    p = Sj.params
    m = Sj.N_ions
    z, D, asum, drift, M, b_cell, b_p, b_m = _knp_parts(St, x)
    bt, rt = assembly.knp_emit_cell_plain(St.g, St.mem_dev, z, D, p.psi, drift, *M,
                                          b_cell, b_p, b_m)
    asum_j = jnp.einsum("k,kc,kic->ic", Sj.z ** 2, Sj.D, jnp.asarray(x["call"]))
    ionsd = {"z": Sj.z[:m], "D": Sj.D[:m], "c_n": jnp.asarray(x["c"]),
             "c_k": jnp.asarray(x["c"])}
    bj, rj = jasm.assemble_knp_all(
        Sj.g, Sj.masks, ionsd, Sj._phys_knp(), jnp.asarray(x["phi"]), asum_j,
        phi_M=jnp.asarray(x["phi_M"]), I_ch=jnp.asarray(x["I_ch"][:m]),
        I_ch_tot=jnp.asarray(x["I_tot"]), mem_t=Sj.mem_dev)
    assert rel(asum, asum_j) < TOL
    assert rel(bt, bj) < TOL
    assert rel(rt, rj) < TOL
    for Mt in M:
        assert Mt.is_contiguous() and float(Mt[..., -1].abs().max()) == 0.0
    # the upwind switch is exercised on both sides
    gphi = assembly.knp_cell_plain(St.g, t64(x["phi"]), t64(x["c"]), p.dt)[0]
    un = torch.einsum("df,df->f", gphi[:, St.g["f_cp"]], St.g["f_n"])
    assert bool((un > 0).any()) and bool((un < 0).any())


def test_knp_emit_cell_adds_static_last(solvers):
    """Given the same facet blocks, the emit equals the JAX stacked gather
    with the static operator added last, and its pair form hands the drift
    blocks and the same rhs to the pair emit."""
    Sj, St, x = solvers
    p = Sj.params
    m, nd, nc = St.N_ions, St.nd, St.n_cells
    rng = np.random.default_rng(13)
    z, D, _, drift, _, b_cell, b_p, b_m = _knp_parts(St, x)
    Ms = _facet_blocks(rng, (m,), nd, St.g["f_area"].shape[0])
    statics = rng.standard_normal((m, St.g["nbr"].shape[0], nd, nd, nc))
    bt, rt = assembly.knp_emit_cell_plain(
        St.g, St.mem_dev, z, D, p.psi, drift, *(t64(M) for M in Ms), b_cell, b_p, b_m,
        static_blocks=t64(statics))
    gj = Sj.g
    A_cell = ((Sj.z[:m] * p.psi)[:, None, None, None]
              * (gj["vol"] * Sj.D[:m])[:, None, None, :]
              * jnp.asarray(tp.to_np(drift))[None, :, None, :]
              * gj["phibar"][None, None, :, None])
    ref = jnp.stack([jasm.gather_blocks(gj, A_cell[k], *(jnp.asarray(M[k]) for M in Ms))
                     for k in range(m)]) + jnp.asarray(statics)
    assert rel(bt, ref) < TOL
    A_t, rt_pair = assembly.knp_emit_cell_plain(
        St.g, St.mem_dev, z, D, p.psi, drift, *(t64(M) for M in Ms), b_cell, b_p, b_m,
        pair=True)
    assert rel(A_t, A_cell) < TOL
    assert torch.equal(rt_pair, rt)


def _decode(words):
    """A packed table's words -> (index, membrane bit, cf_is_plus bit)."""
    w = words.to(torch.int64) & (2 ** 32 - 1)
    return w & (2 ** 30 - 1), (w >> 30) & 1, (w >> 31) & 1


def _check_emit_tables(St):
    """The membrane emit's static tables decode to the maps they pack: the
    slot words to cf_idx, inv[cf_idx] >= 0 and cf_is_plus; the compact list
    to exactly the cells with a membrane slot, its words to inv[cf_idx] and
    cf_is_plus; the membrane table to cp, cm and f_area[fidx].  The
    solver builds them once and they hold every tensor they point to."""
    g, mem = St.g, St.mem_dev
    tab = St._membrane_emit_tables()
    assert St._membrane_emit_tables() is tab                  # made once
    assert all(a is b for a, b in zip(tab.sources, (mem["Rp"], mem["Rm"], g["w_f"], g["vol"],
                                                    g["phibar"])))
    cf, isp = g["cf_idx"].long(), g["cf_is_plus"].long()
    mi = mem["inv"].long()[cf]
    f, on, sp = _decode(tab.slots)
    assert tab.slots.dtype == torch.int32 and tab.slots.is_contiguous()
    assert torch.equal(f, cf) and torch.equal(sp, isp) and torch.equal(on, (mi >= 0).long())
    has = (mi >= 0).any(dim=0)
    cells = tab.cells[0].long()
    assert torch.equal(cells, torch.nonzero(has).flatten())
    assert int(has.sum()) > 0 and tab.cells.shape == (cf.shape[0] + 1, cells.shape[0])
    j, on_c, sp_c = _decode(tab.cells[1:])
    assert torch.equal(on_c, (mi[:, cells] >= 0).long())
    assert torch.equal(sp_c, isp[:, cells])
    assert torch.equal(j, torch.where(mi[:, cells] >= 0, mi[:, cells], 0))
    assert torch.equal(tab.mcell, torch.stack([mem["cp"], mem["cm"]]))
    assert torch.equal(tab.area, g["f_area"][mem["fidx"].long()])
    nq, nd, nm = mem["Rp"].shape
    assert tab.dims == (nq, nd, cf.shape[0], cf.shape[1], g["f_area"].shape[0], nm,
                        cells.shape[0])
    return tab


def _emit_through_the_slot_words(Sj, St, pair, seed):
    """The EMI emit reading its cell-facet slots from the solver's packed
    slot words (the KNP membrane emit's table): on a geometry whose cf_idx
    and cf_is_plus are those words decoded, into the solver's buffers, it
    equals emi_emit_cell_plain on the solver's maps exactly and the JAX
    gather_blocks / gather_rhs (and the regularised diagonal) to round-off;
    the words packed without the membrane map are the same words without
    the membrane bit."""
    rng = np.random.default_rng(seed)
    g, nd = St.g, St.nd
    nfac, nc = g["cf_idx"].shape
    nf1 = g["f_area"].shape[0]
    tab = St._membrane_emit_tables()
    f, on, sp = _decode(tab.slots)
    assert torch.equal(assembly.slot_words(g), (tab.slots.to(torch.int64)
                                                & ~(1 << 30)).to(torch.int32))
    gs = dict(g, cf_idx=f.to(torch.int32), cf_is_plus=sp.bool())
    Ms = _facet_blocks(rng, (), nd, nf1)
    bs = rng.standard_normal((3, nd, max(nc, nf1)))
    b_cell, b_p, b_m = bs[0][:, :nc], bs[1][:, :nf1], bs[2][:, :nf1]
    kbar = rng.uniform(0.5, 2.0, nc)
    inv_Lp2 = 1.0 / St.Lp ** 2
    args = (t64(kbar), *(t64(M) for M in Ms), t64(b_cell), t64(b_p), t64(b_m), inv_Lp2)
    out = St._emit_out("emi_emit")
    assert St._emit_out("emi_emit") is out                    # made once
    assert out.blocks.shape == ((nd, nd, nc) if pair else (nfac + 1, nd, nd, nc))
    got = assembly.emi_emit_cell(gs, *args, pair=pair, out=out, tables=tab)
    assert all(a is b for a, b in zip(got, out))
    ref = assembly.emi_emit_cell_plain(g, *args, pair=pair)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    gj = Sj.g
    A_cell = (gj["vol"] * jnp.asarray(kbar)) * jasm._GG(gj)
    rj = jasm.gather_rhs(gj, jnp.asarray(b_cell), jnp.asarray(b_p), jnp.asarray(b_m))
    reg = (gj["vol"] * jnp.asarray(kbar) / Sj.Lp ** 2) * jasm._M0(gj)[:, :, None]
    assert rel(got[1], rj) < TOL
    if pair:
        assert rel(got[0], A_cell) < TOL and rel(got[2], reg) < TOL
    else:
        bj = jasm.gather_blocks(gj, A_cell, *(jnp.asarray(M) for M in Ms))
        assert rel(got[0], bj) < TOL and rel(got[2], bj[0] + reg) < TOL


def test_emi_emit_reads_the_shared_slot_words(solvers):
    Sj, St, _ = solvers
    _emit_through_the_slot_words(Sj, St, False, 16)


def test_solver_owns_the_emi_emit_buffers(monkeypatch):
    """Two steps of the 2D neuron: the pc build and every step's EMI emit
    read the solver's one slot table, only _pde_step's emits write into
    the EMI emit buffers (made once, the same in both steps; the pc build
    emits into new tensors), and a new cell numbering or membrane map
    drops them with the other emit buffers."""
    seen = []
    emit = assembly.emi_emit_cell

    def spy(*args, out=None, tables=None, **kw):
        seen.append((out, tables))
        return emit(*args, out=out, tables=tables, **kw)

    monkeypatch.setattr(assembly, "emi_emit_cell", spy)
    S, sp = tp.neuron_2d_torch()
    S.solve_system_active(2e-4, 0.0, sp)
    out, tab = S._emit_out("emi_emit"), S._membrane_emit_tables()
    assert len(seen) == 3 and all(t is tab for _, t in seen)
    assert seen[0][0] is None and seen[1][0] is out and seen[2][0] is out
    S._invalidate_caches()
    new = S._emit_out("emi_emit")
    assert new is not out and S._membrane_emit_tables() is not tab
    S._set_membrane_tags(sorted(S.mem_models))
    assert S._emit_out("emi_emit") is not new


def test_knp_emit_tables_decode_to_the_maps(solvers):
    _check_emit_tables(solvers[1])


def test_solver_drops_the_emit_tables_with_its_caches(solvers):
    """A new cell numbering or membrane map drops the solver's membrane
    emit tables with its emit buffers (_invalidate_caches); the next step
    builds them anew from its current maps."""
    St = solvers[1]
    tab, out = St._membrane_emit_tables(), St._emit_out("membrane_emit")
    St._invalidate_caches()
    new = St._membrane_emit_tables()
    assert new is not tab and St._emit_out("membrane_emit") is not out
    assert torch.equal(new.slots, tab.slots) and torch.equal(new.cells, tab.cells)
    assert new.dims == tab.dims


def test_knp_membrane_emit_writes_the_plain_results_into_its_buffers(solvers):
    """knp_membrane_emit on the CPU is the plain membrane rhs and emit, and
    with ``out`` it writes them into the step's buffers (Solver._emit_out)
    and returns those; the buffers are made once per dtype."""
    Sj, St, x = solvers
    p = St.params
    z, D, asum, drift, M, b_cell, b_p, b_m = _knp_parts(St, x)
    statics = torch.stack([St._knp_static(k) for k in range(St.N_ions)])
    args = (St.g, St.mem_dev, z, D, t64(x["c"]), asum, t64(x["phi"]), t64(x["phi_M"]),
            t64(x["I_ch"][:St.N_ions]), t64(x["I_tot"]), p.F, p.C_M, p.dt, p.psi, drift, M,
            b_cell, statics)
    ref = assembly.knp_membrane_emit_plain(*args)
    assert torch.equal(ref[2], b_p) and torch.equal(ref[3], b_m)
    blocks, rhs = assembly.knp_emit_cell_plain(St.g, St.mem_dev, z, D, p.psi, drift, *M,
                                               b_cell, b_p, b_m, statics)
    assert torch.equal(ref[0], blocks) and torch.equal(ref[1], rhs)
    out = St._emit_out("membrane_emit")
    assert St._emit_out("membrane_emit") is out
    got = assembly.knp_membrane_emit(*args, out=out)
    assert all(a is b for a, b in zip(got, out))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_knp_membrane_emit_without_membrane_facets(solvers):
    """With no membrane facet (n_mem = 0) the tables hold no membrane cell
    and the membrane emit's rhs is b_cell, its blocks the emit's."""
    _, St, x = solvers
    p, m = St.params, St.N_ions
    z, D, asum, drift, M, b_cell, _, _ = _knp_parts(St, x)
    none = torch.zeros(0, dtype=torch.int32)
    mem0 = dict(St.mem_dev, fidx=none, cp=none, cm=none,
                inv=torch.full_like(St.mem_dev["inv"], -1),
                Rp=St.mem_dev["Rp"][..., :0].contiguous(),
                Rm=St.mem_dev["Rm"][..., :0].contiguous())
    tab = assembly.knp_emit_tables(St.g, mem0)
    assert tab.dims[5:] == (0, 0) and tab.cells.shape == (St.g["cf_idx"].shape[0] + 1, 0)
    blocks, rhs, b_p, b_m = assembly.knp_membrane_emit(
        St.g, mem0, z, D, t64(x["c"]), asum, t64(x["phi"]), torch.zeros(1),
        torch.zeros((m, 1)), torch.zeros(1), p.F, p.C_M, p.dt, p.psi, drift, M, b_cell)
    assert b_p.shape == b_m.shape == (m, St.nd, 0)
    assert torch.equal(rhs, b_cell)
    ref = assembly.knp_emit_cell_plain(St.g, St.mem_dev, z, D, p.psi, drift, *M, b_cell,
                                       *_knp_parts(St, x)[6:])[0]
    assert torch.equal(blocks, ref)


def test_membrane_trace_helpers_match_jax(solvers):
    """The K14 plain versions against the JAX helpers, every ion and side."""
    Sj, St, x = solvers
    gj, mj, gt, mt = Sj.g, Sj.mem_dev, St.g, St.mem_dev
    p = Sj.params
    assert rel(assembly.jump_phi_M_m_plain(gt, mt, t64(x["phi"])),
               jasm.jump_phi_M_m(gj, mj, jnp.asarray(x["phi"]))) < TOL
    for k, ion in enumerate(Sj.ion_list):
        f = x["call"][k]
        for side in ("p", "m"):
            assert rel(assembly.membrane_avg_m_plain(gt, mt, t64(f), side),
                       jasm.membrane_avg_m(gj, mj, jnp.asarray(f), side)) < TOL
        zk = float(ion.z)
        assert rel(assembly.nernst_potential_m_plain(gt, mt, t64(f), zk, p.F, p.R,
                                                     p.temperature),
                   jasm.nernst_potential_m(gj, mj, jnp.asarray(f), zk, p.F, p.R,
                                           p.temperature)) < TOL
    zj = np.asarray(Sj.z[:-1])
    z_elim = float(Sj.ion_list[-1].z)
    got = assembly.eliminated_concentration_plain(t64(x["c"]), t64(zj), St.rho, z_elim)
    assert got.is_contiguous()
    assert rel(got, jasm.eliminated_concentration(jnp.asarray(x["c"]), jnp.asarray(zj),
                                                  Sj.rho, z_elim)) < TOL


def _abs_tables(d):
    return {k: (v.abs() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
            for k, v in d.items()}


def test_abs_versions_bound_the_values(solvers):
    """With neg = +1 and absolute-valued inputs each plain version returns
    its outputs' sums of |terms| (the error scale of the kernel checks on
    the card): never below |value|, and zero on the dummy facet."""
    _, St, x = solvers
    p = St.params
    m = St.N_ions
    ga, ma = _abs_tables(St.g), _abs_tables(St.mem_dev)
    ab = lambda v: t64(np.abs(v))
    call = t64(x["call"])
    vals = assembly.emi_cell_plain(St.g, St.z, St.D, call, p.F, p.psi)
    scal = assembly.emi_cell_plain(ga, St.z.abs(), St.D, call.abs(), p.F, p.psi, neg=1.0)
    kappa, _, flux, _ = vals
    vals += assembly.emi_facet_plain(St.g, St.masks, kappa, flux, t64(x["phi_M"]),
                                     St.mem_dev, p.F, p.C_phi, St.tau)
    scal += assembly.emi_facet_plain(ga, St.masks, kappa.abs(), flux.abs(), ab(x["phi_M"]),
                                     ma, p.F, p.C_phi, St.tau, neg=1.0)
    z, D, asum, _, _, _, _, _ = _knp_parts(St, x)
    gphi, drift, b_cell = assembly.knp_cell_plain(St.g, t64(x["phi"]), t64(x["c"]), p.dt)
    vals += (gphi, drift, b_cell)
    scal += assembly.knp_cell_plain(ga, ab(x["phi"]), ab(x["c"]), p.dt)
    vals += assembly.knp_facet_plain(St.g, St.masks, z, D, gphi, p.psi)
    scal += assembly.knp_facet_plain(ga, St.masks, z.abs(), D, gphi.abs(), p.psi, neg=1.0)
    vals += assembly.knp_membrane_rhs_plain(
        St.g, St.mem_dev, z, D, t64(x["c"]), asum, t64(x["phi"]), t64(x["phi_M"]),
        t64(x["I_ch"][:m]), t64(x["I_tot"]), p.F, p.C_M, p.dt)
    scal += assembly.knp_membrane_rhs_plain(
        ga, ma, z.abs(), D, ab(x["c"]), asum, ab(x["phi"]), ab(x["phi_M"]),
        ab(x["I_ch"][:m]), ab(x["I_tot"]), p.F, p.C_M, p.dt, neg=1.0)
    assert len(vals) == len(scal) == 19
    for v, s in zip(vals, scal):
        assert v.shape == s.shape
        assert bool((s >= 0).all())
        assert bool((v.abs() <= s * (1 + 1e-12) + 1e-300).all())


# ---------------------------------------------------------------------------
# the pair layout: the port's assembly on the padded, renumbered cell axis
# against the JAX package's pair assembly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(FIXTURES))
def pair_solvers(request):
    jb, tb = FIXTURES[request.param]
    Sj, St = jb(), tb()
    Sj.enable_pair_layout()
    St.enable_pair_layout()
    return Sj, St, _state(Sj, seed=14)


def test_pair_kernel_tables_are_contiguous(pair_solvers):
    St = pair_solvers[1]
    _check_tables(St)
    assert St.g["G"].shape[-1] == St.n_cells_pad == St.D.shape[-1]
    assert St.D.is_contiguous() and St.rho.is_contiguous()


def test_pair_knp_emit_tables_decode_to_the_maps(pair_solvers):
    """The membrane emit's tables on the pair layout's padded, renumbered
    cell axis: the pad cells' slots hold the dummy facet, no membrane."""
    St = pair_solvers[1]
    tab = _check_emit_tables(St)
    pads = ~St._pad_mask
    assert bool(pads.any())
    f, on, _ = _decode(tab.slots[:, pads])
    assert bool((f == St.g["f_area"].shape[0] - 1).all()) and not bool(on.any())
    assert not bool(pads[tab.cells[0].long()].any())


def test_pair_emi_emit_reads_the_shared_slot_words(pair_solvers):
    """The pair layout's EMI emit (A_cell, rhs, reg) through the packed slot
    words on the padded, renumbered cell axis, into the solver's buffers."""
    Sj, St, _ = pair_solvers
    _emit_through_the_slot_words(Sj, St, True, 17)


def test_pair_cell_parts_through_the_step_route(pair_solvers):
    """The step's route of the cell parts on the pair layout's padded,
    renumbered cell axis (the pair layout's buffers)."""
    _cell_parts_through_the_step_route(*pair_solvers)


def test_pair_ion_sums_through_the_step_route(pair_solvers):
    """alpha_sum and eliminated_concentration through the step's route on
    the pair layout's padded, renumbered cell axis."""
    _ion_sums_through_the_step_route(*pair_solvers)


def test_pair_emi_assembly_matches_jax(pair_solvers):
    Sj, St, x = pair_solvers
    (pdj, pej), rj, Pj = Sj._assemble_emi(
        jnp.asarray(x["c"]), jnp.asarray(x["c_elim"]), jnp.asarray(x["phi_M"]),
        jnp.asarray(x["I_tot"]), 0.0, pair=True)
    (pdt, pet), rt, Pt = St._assemble_emi(
        t64(x["c"]), t64(x["c_elim"]), t64(x["phi_M"]), t64(x["I_tot"]), 0.0, pair=True)
    assert pdt.shape == tuple(pdj.shape) and pet.shape == tuple(pej.shape)
    assert rel(pdt, pdj) < TOL and rel(pet, pej) < TOL
    assert rel(rt, rj) < TOL
    assert rel(Pt, Pj) < TOL
    assert all(t.is_contiguous() for t in (pdt, pet, rt, Pt))


def test_pair_knp_assembly_matches_jax(pair_solvers):
    Sj, St, x = pair_solvers
    for k in range(Sj.N_ions):
        Sj._knp_static(k)
    args = (x["c"], x["c_elim"], x["phi"], x["phi_M"], x["I_ch"], x["I_tot"])
    (pdj, pej), rj = Sj._knp_assemble_all(*(jnp.asarray(a) for a in args), 0.0,
                                          jnp.asarray(x["c"]))
    (pdt, pet), rt = St._knp_assemble_all(*(t64(a) for a in args), 0.0, t64(x["c"]))
    assert pdt.shape == tuple(pdj.shape) and pet.shape == tuple(pej.shape)
    assert rel(pdt, pdj) < TOL and rel(pet, pej) < TOL
    assert rel(rt, rj) < TOL


def test_pair_emit_optional_parts_match_the_separate_sums(pair_solvers):
    """The pair emit's optional parts: ``add`` equals adding the static pair
    operator afterwards, ``reg`` equals pd + the embedded per-cell blocks."""
    _, St, _ = pair_solvers
    rng = np.random.default_rng(15)
    pm = St.pairs
    nd, nc = St.nd, St.n_cells_pad
    nf1 = St.g["f_area"].shape[0]
    m = 2
    A = t64(rng.standard_normal((m, nd, nd, nc)))
    Ms = [t64(M) for M in _facet_blocks(rng, (m,), nd, nf1)]
    pd, pe = pairs.gather_blocks_pair_multi(None, pm, A, *Ms)
    add = (t64(rng.standard_normal(tuple(pd.shape))), t64(rng.standard_normal(tuple(pe.shape))))
    pd2, pe2 = pairs.gather_blocks_pair_multi(None, pm, A, *Ms, add=add)
    assert torch.equal(pd2, pd + add[0]) and torch.equal(pe2, pe + add[1])
    reg = t64(rng.standard_normal((nd, nd, nc)))
    pd1, pe1, Pd = pairs.gather_blocks_pair(None, pm, A[0], *(M[0] for M in Ms), reg=reg)
    assert torch.equal(pd1, pd[0]) and torch.equal(pe1, pe[0])
    assert torch.equal(Pd, pd1 + pairs.pair_block_diag_embed(pm, reg))
