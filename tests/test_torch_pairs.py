"""The pair layout's building blocks (knpemidg_tpu_torch/ops/pairs.py,
parallel/sharding.py, the masked pcg projection) against the JAX package
in float64: host maps and the interleave permutation equal integer for
integer; relayouts, emitters and the moves exact; matvecs and sums to
round-off.  Blocks and vectors are random (numpy seed) on the pair maps of
box_3d_axons(0) and box_2d_neuron(0); the sharded (live0) form of the
interleaved maps drives the plain versions' live0 branches."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_parity as tp
from test_torch_parity import rel, t64, to_np

from knpemidg_tpu.fem.tabulation import build_geometry as jbuild_geometry
from knpemidg_tpu.mesh import generators as jgen
from knpemidg_tpu.ops import pairs as jP
from knpemidg_tpu.parallel import sharding as jsh
from knpemidg_tpu.solvers import krylov as jkry
from knpemidg_tpu_torch import _cuda
from knpemidg_tpu_torch.fem.tabulation import build_geometry
from knpemidg_tpu_torch.mesh import generators as tgen
from knpemidg_tpu_torch.ops import pairs as P
from knpemidg_tpu_torch.parallel import sharding as tsh
from knpemidg_tpu_torch.solvers import krylov

TOL = 1e-12      # f64 round-off of sums taken in another order
MESHES = {"3d": lambda g: g.box_3d_axons(0, length_factor=1),
          "2d": lambda g: g.box_2d_neuron(0)}


@pytest.fixture(scope="module", params=sorted(MESHES))
def geoms(request):
    """(name, JAX geometry, port geometry) of one fixture mesh, each
    package building its own mesh."""
    make = MESHES[request.param]
    return (request.param, jbuild_geometry(make(jgen)),
            build_geometry(make(tgen)))


def _maps(geom, pkg, n_shards):
    """(cell-order maps, interleaved maps, perm) of one package."""
    nc = geom.vol.shape[0]
    if n_shards == 1:
        pm0 = pkg.build_pair_maps(geom)
        pmi, perm = pkg.interleave_pair_maps(pm0, nc)
    else:
        size = -(-nc // n_shards)
        pm0 = pkg.build_pair_maps(geom, block=np.arange(nc) // size)
        pmi, perm = pkg.interleave_pair_maps(pm0, nc, n_shards=n_shards,
                                             shard_size=size, align=64)
    return pm0, pmi, perm


@pytest.mark.parametrize("n_shards", [1, 2])
def test_pair_maps_and_perm_equal_jax(geoms, n_shards):
    _, gj, gt = geoms
    for mj, mt in zip(_maps(gj, jP, n_shards), _maps(gt, P, n_shards)):
        if isinstance(mj, dict):
            assert sorted(mj) == sorted(mt)
            for k in mj:
                assert np.asarray(mt[k]).dtype == np.asarray(mj[k]).dtype, k
                assert np.array_equal(mt[k], mj[k]), k
        else:
            assert np.array_equal(mt, mj)


@pytest.fixture(scope="module")
def setup(geoms):
    """Interleaved maps of both packages (single-device and sharded) and
    random per-cell / per-facet blocks on the padded cell axis."""
    name, gj, gt = geoms
    out = {"name": name, "nd": gt.nd}
    for n_shards in (1, 2):
        _, pmi, perm = _maps(gt, P, n_shards)
        out[n_shards] = (jP.pair_maps_to_device(pmi),
                         P.pair_maps_to_device(pmi, "cpu"), pmi, len(perm))
    return out


def _rand_blocks(rng, nd, nc, nf1, m=None):
    lead = () if m is None else (m,)
    Ms = []
    for _ in range(4):
        M = rng.standard_normal(lead + (nd, nd, nf1))
        M[..., -1] = 0.0                    # the dummy facet row is zero
        Ms.append(M)
    return rng.standard_normal(lead + (nd, nd, nc)), Ms


@pytest.mark.parametrize("n_shards", [1, 2])
def test_relayouts_match_jax(setup, n_shards):
    pmj, pmt, pmh, nc = setup[n_shards]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, setup["nd"], nc))
    xp_j = jP.to_pair(pmj, jnp.asarray(x))
    xp_t = P.to_pair(pmt, t64(x))
    assert np.array_equal(to_np(xp_t), np.asarray(xp_j))
    assert np.array_equal(P.to_pair_host(pmh, x), np.asarray(xp_j))
    back_j = jP.from_pair(pmj, xp_j)
    assert np.array_equal(to_np(P.from_pair(pmt, xp_t)), np.asarray(back_j))
    assert np.array_equal(P.from_pair_host(pmh, to_np(xp_t)), np.asarray(back_j))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_from_pair_carries_the_solvers_add_exactly(setup, n_shards):
    """from_pair's add form (the EMI solve's guess + x, in pair form) and
    base form (the KNP solve's c + x, in cell form) equal jP.from_pair of
    the sum and base + jP.from_pair bitwise, for one vector and a stack;
    so does from_pair_host; out= receives the result."""
    pmj, pmt, pmh, nc = setup[n_shards]
    nd = setup["nd"]
    rng = np.random.default_rng(6)
    for lead in ((), (2,)):
        xp = rng.standard_normal(lead + (2 * nd, nc // 2))
        add = rng.standard_normal(xp.shape)
        base = rng.standard_normal(lead + (nd, nc))
        want_add = np.asarray(jP.from_pair(pmj, jnp.asarray(xp) + jnp.asarray(add)))
        want_base = np.asarray(jnp.asarray(base) + jP.from_pair(pmj, jnp.asarray(xp)))
        assert np.array_equal(to_np(P.from_pair(pmt, t64(xp), add=t64(add))), want_add)
        assert np.array_equal(to_np(P.from_pair(pmt, t64(xp), base=t64(base))), want_base)
        assert np.array_equal(P.from_pair_host(pmh, xp, add=add), want_add)
        assert np.array_equal(P.from_pair_host(pmh, xp, base=base), want_base)
        out = torch.full(base.shape, float("nan"), dtype=torch.float64)
        assert P.from_pair(pmt, t64(xp), base=t64(base), out=out) is out
        assert np.array_equal(to_np(out), want_base)


# operands from_pair refuses: both adds at once, and an add or base that
# would broadcast instead of matching
FROM_PAIR_REFUSALS = {"both": lambda a, b: {"add": a, "base": b},
                      "add_shape": lambda a, b: {"add": a[:1]},
                      "base_shape": lambda a, b: {"base": b[:1]}}


@pytest.mark.parametrize("case", sorted(FROM_PAIR_REFUSALS))
def test_from_pair_refuses_what_it_cannot_add(case):
    xp = np.zeros((2, 8, 5))
    kw = FROM_PAIR_REFUSALS[case](np.zeros(xp.shape), np.zeros((2, 4, 10)))
    with pytest.raises(ValueError, match="from_pair"):
        P.from_pair({}, torch.as_tensor(xp), **{k: torch.as_tensor(v) for k, v in kw.items()})
    with pytest.raises(ValueError, match="from_pair"):
        P.from_pair_host({}, xp, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [2, 3])
def test_to_pair_of_a_list_is_the_stack(setup, k, dtype):
    """to_pair of k same-shaped vectors (as the solver hands them: the KNP
    solve's 2 of (m, nd, nc), the EMI solve's 3 of (nd, nc)) equals to_pair
    of their stack and the JAX to_pair of the stack exactly; out= receives
    the result."""
    pmj, pmt, pmh, nc = setup[1]
    rng = np.random.default_rng(5 + k)
    lead = (2,) if k == 2 else ()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    xs = [rng.standard_normal(lead + (setup["nd"], nc)).astype(np_dtype) for _ in range(k)]
    tx = [torch.as_tensor(x) for x in xs]
    got = P.to_pair(pmt, tx)
    assert got.dtype == dtype and got.shape == (k,) + lead + (2 * setup["nd"], nc // 2)
    assert torch.equal(got, P.to_pair(pmt, torch.stack(tx)))
    assert np.array_equal(to_np(got), np.asarray(jP.to_pair(pmj, jnp.asarray(np.stack(xs)))))
    out = torch.full_like(got, float("nan"))
    assert P.to_pair(pmt, tuple(tx), out=out) is out and torch.equal(out, got)


def test_index_map_form_is_not_ported(geoms):
    _, _, gt = geoms
    pm = P.pair_maps_to_device(P.build_pair_maps(gt), "cpu")
    x = torch.zeros((gt.nd, gt.vol.shape[0]), dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        P.to_pair(pm, x)
    with pytest.raises(NotImplementedError):
        P.from_pair(pm, x)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_emitters_match_jax(setup, n_shards):
    """gather_blocks_pair(_multi), pair_block_diag_embed, cell_bell_to_pair
    and the small map helpers: exact (gathers, selects and the same
    additions in the same order)."""
    pmj, pmt, pmh, nc = setup[n_shards]
    nd = setup["nd"]
    nf1 = int(pmh["nf"]) + 1
    rng = np.random.default_rng(2)
    A, Ms = _rand_blocks(rng, nd, nc, nf1)
    Mpp, Mmm, Mpm, Mmp = Ms
    ref = jP.gather_blocks_pair(None, pmj, *(jnp.asarray(a) for a in
                                            (A, Mpp, Mpm, Mmp, Mmm)))
    got = P.gather_blocks_pair(None, pmt, *(t64(a) for a in (A, Mpp, Mpm, Mmp, Mmm)))
    for a, b in zip(got, ref):
        assert np.array_equal(to_np(a), np.asarray(b))

    Am, Msm = _rand_blocks(rng, nd, nc, nf1, m=2)
    args = (Am, Msm[0], Msm[2], Msm[3], Msm[1])
    ref = jP.gather_blocks_pair_multi(None, pmj, *(jnp.asarray(a) for a in args),
                                      dead_identity=0.5)
    got = P.gather_blocks_pair_multi(None, pmt, *(t64(a) for a in args),
                                     dead_identity=0.5)
    for a, b in zip(got, ref):
        assert np.array_equal(to_np(a), np.asarray(b))

    D = rng.standard_normal((nd, nd, nc))
    assert np.array_equal(to_np(P.pair_block_diag_embed(pmt, t64(D), 0.25)),
                          np.asarray(jP.pair_block_diag_embed(pmj, jnp.asarray(D), 0.25)))
    K = nd + 2
    blocks = rng.standard_normal((2, K, nd, nd, nc))
    for a, b in zip(P.cell_bell_to_pair(pmt, t64(blocks), 0.5),
                    jP.cell_bell_to_pair(pmj, jnp.asarray(blocks), 0.5)):
        assert np.array_equal(to_np(a), np.asarray(b))
    assert np.array_equal(to_np(P.pair_nbr(pmt)), np.asarray(jP.pair_nbr(pmj)))
    mass = rng.uniform(1.0, 2.0, nc)
    assert np.array_equal(to_np(P.mass_to_pair(pmt, t64(mass))),
                          np.asarray(jP.mass_to_pair(pmj, jnp.asarray(mass))))
    oh = rng.standard_normal((3, nc))
    assert np.array_equal(to_np(P.onehot_to_pair(pmt, t64(oh))),
                          np.asarray(jP.onehot_to_pair(pmj, jnp.asarray(oh))))


def test_pair_matvecs_and_sums_match_jax(setup):
    pmj, pmt, pmh, nc = setup[1]
    nd = setup["nd"]
    nf1 = int(pmh["nf"]) + 1
    rng = np.random.default_rng(3)
    A, Ms = _rand_blocks(rng, nd, nc, nf1, m=2)
    args = (A, Ms[0], Ms[2], Ms[3], Ms[1])
    pdK, peK = jP.gather_blocks_pair_multi(None, pmj, *(jnp.asarray(a) for a in args))
    pdt, pet = t64(pdK), t64(peK)
    X = rng.standard_normal((2, 2 * nd, pmh["int_f"].shape[0]))
    ref = jP.pair_matvec_multi(pdK, peK, pmj, jnp.asarray(X))
    assert rel(P.pair_matvec_multi(pdt, pet, pmt, t64(X)), ref) < TOL
    ref = jP.pair_matvec(pdK[1], peK[1], pmj, jnp.asarray(X[1]))
    assert rel(P.pair_matvec(pdt[1], pet[1], pmt, t64(X[1])), ref) < TOL
    X3 = rng.standard_normal((5,) + X.shape[1:])
    ref = jP.pair_matvec_fan(pdK[0], peK[0], pmj, jnp.asarray(X3))
    assert rel(P.pair_matvec_fan(pdt[0], pet[0], pmt, t64(X3)), ref) < TOL
    assert rel(P.pair_v_sums(pdt[0], pet[0]), jP.pair_v_sums(pdK[0], peK[0])) < TOL


def test_owner_half_mask_and_the_zero_halves_of_pe(setup):
    """The pair matvec kernel's invariant: pair_maps_to_device's owner-half
    mask decodes to the JAX package's ext_h, and the plain emit's pe (the
    EMI form with its regularisation, the KNP form with a static operator
    from cell_bell_to_pair added) is exactly zero outside each slot's owner
    half, which owner_half_rows marks."""
    pmj, pmt, pmh, nc = setup[1]
    nd = setup["nd"]
    S, npair = pmh["ext_h"].shape
    hmask = pmt["ext_hmask"]
    assert hmask.dtype == torch.uint8 and tuple(hmask.shape) == (npair,)
    bits = (to_np(hmask)[None, :].astype(np.int32) >> np.arange(S)[:, None]) & 1
    assert np.array_equal(bits, np.asarray(pmj["ext_h"]))
    rows = P.owner_half_rows(pmt, nd)
    assert np.array_equal(to_np(rows[:, :, 0]),
                          (np.arange(2 * nd)[None, :, None] // nd) == bits[:, None, :])
    rng = np.random.default_rng(11)
    A, Ms = _rand_blocks(rng, nd, nc, int(pmh["nf"]) + 1, m=2)
    args = [t64(a) for a in (A, Ms[0], Ms[2], Ms[3], Ms[1])]
    reg = t64(rng.standard_normal((nd, nd, nc)))
    _, pe, _ = P.gather_blocks_pair_plain(None, pmt, *(a[0] for a in args), reg=reg)
    static = P.cell_bell_to_pair(pmt, t64(rng.standard_normal((2, S // 2 + 2, nd, nd, nc))))
    _, peK = P.gather_blocks_pair_multi_plain(None, pmt, *args, add=static)
    for blocks in (pe[None], peK):
        assert not bool(blocks.masked_select(~rows).any())
        assert bool(blocks.masked_select(rows).any())


def _emit_table_maps(tab):
    """The maps a packed pairs.emit_table holds, decoded: the interior word
    (int_f, live1 in bit 30, int_p0 in bit 31) and a word a slot (ext_f,
    ext_isp in bit 30, ext_h in bit 31); cop is the interleaved (2p, 2p + 1)."""
    w = tab.to(torch.int64) & (2 ** 32 - 1)
    low, b30, b31 = w & (2 ** 30 - 1), (w >> 30) & 1, w >> 31
    pairs_ = torch.arange(tab.shape[1], dtype=torch.int32)
    return {"cop": torch.stack([2 * pairs_, 2 * pairs_ + 1]), "live1": b30[0].bool(),
            "int_f": low[0].to(torch.int32), "int_p0": b31[0].bool(),
            "ext_f": low[1:].to(torch.int32), "ext_isp": b30[1:].bool(),
            "ext_h": b31[1:].to(torch.int32)}


def test_emit_table_decodes_to_the_maps_and_is_cached(setup):
    """The pair emit's packed table holds int_f, int_p0, live1 and each
    slot's ext_f, ext_isp, ext_h bit for bit (cop is the interleaved
    (2p, 2p + 1)); it is built once per maps and again for other maps."""
    pmj, pmt, pmh, nc = setup[1]
    S, npair = pmh["ext_f"].shape
    tab = P.emit_table(pmt)
    assert tab.dtype == torch.int32 and tuple(tab.shape) == (S + 1, npair)
    assert tab.is_contiguous()
    got = _emit_table_maps(tab)
    for key in ("cop", "live1", "int_f", "int_p0", "ext_f", "ext_isp", "ext_h"):
        assert got[key].dtype == pmt[key].dtype, key
        assert torch.equal(got[key], pmt[key]), key
        assert np.array_equal(to_np(got[key]), np.asarray(pmj[key])), key
    assert P.emit_table(pmt) is tab
    assert P.emit_table(dict(pmt)) is tab                     # the same map tensors
    other = dict(pmt, ext_h=pmt["ext_h"].clone())
    assert P.emit_table(other) is not tab
    assert torch.equal(P.emit_table(other), tab)


def test_emit_table_refuses_maps_it_cannot_pack(setup):
    """The table takes the interleaved single-device maps: a pair whose
    cells are not (2p, 2p + 1) raises, as does a facet index beyond 30
    bits."""
    _, pmt, _, _ = setup[1]
    cop = pmt["cop"].clone()
    cop[:, [0, 1]] = cop[:, [1, 0]]
    with pytest.raises(NotImplementedError):
        P.emit_table(dict(pmt, cop=cop))
    far = pmt["ext_f"].clone()
    far[0, 0] = 2 ** 30
    with pytest.raises(ValueError):
        P.emit_table(dict(pmt, ext_f=far))


def test_emit_out_buffers_and_the_zero_half_check(setup):
    """emit_buffers' pe is zero and known to be: an emit into the buffers
    (the step's form) equals the emit into new tensors, twice with other
    inputs; the check of a pe or add_pe outside its owner halves accepts
    zeros (+0 or -0) and raises on anything else, NaN included."""
    pmj, pmt, pmh, nc = setup[1]
    nd = setup["nd"]
    rng = np.random.default_rng(12)
    bufs = P.emit_buffers(pmt, nd, torch.float64, "cpu", m=2)
    one = P.emit_buffers(pmt, nd, torch.float64, "cpu", diag=True)
    assert len(one) == 3 and one[1].shape == bufs[1].shape[1:]
    assert not bool(bufs[1].any()) and not bool(one[1].any())
    for _ in range(2):
        A, Ms = _rand_blocks(rng, nd, nc, int(pmh["nf"]) + 1, m=2)
        args = [t64(a) for a in (A, Ms[0], Ms[2], Ms[3], Ms[1])]
        got = P.gather_blocks_pair_multi(None, pmt, *args, out=bufs)
        ref = P.gather_blocks_pair_multi(None, pmt, *args)
        assert got[0] is bufs[0] and got[1] is bufs[1]
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        reg = t64(rng.standard_normal((nd, nd, nc)))
        got = P.gather_blocks_pair(None, pmt, *(a[0] for a in args), reg=reg, out=one)
        ref = P.gather_blocks_pair(None, pmt, *(a[0] for a in args), reg=reg)
        assert all(a is b for a, b in zip(got, one))
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    own = P.owner_half_rows(pmt, nd)
    pe = torch.where(own, 1.0, -0.0).to(torch.float64).expand(2, *own.shape[:2], nd,
                                                              own.shape[-1]).contiguous()
    P._zero_halves(pmt, pe, "add pe")
    for bad in (1e-300, float("nan")):
        pe2 = pe.clone()
        pe2.masked_fill_(~own[None].expand_as(pe2), bad)
        with pytest.raises(ValueError, match="owner halves"):
            P._zero_halves(pmt, pe2, "add pe")


def test_cpu_pair_wrappers_launch_nothing(setup):
    """On CPU tensors the pair wrappers are their plain versions."""
    pmj, pmt, pmh, nc = setup[1]
    nd = setup["nd"]
    rng = np.random.default_rng(4)
    A, Ms = _rand_blocks(rng, nd, nc, int(pmh["nf"]) + 1)
    args = [t64(a) for a in (A, Ms[0], Ms[2], Ms[3], Ms[1])]
    before = dict(_cuda.LAUNCHES)
    pd, pe = P.gather_blocks_pair(None, pmt, *args)
    ref = P.gather_blocks_pair_plain(None, pmt, *args)
    assert torch.equal(pd, ref[0]) and torch.equal(pe, ref[1])
    x = t64(rng.standard_normal((nd, nc)))
    xp = P.to_pair(pmt, x)
    assert torch.equal(xp, P.to_pair_plain(pmt, x))
    assert torch.equal(P.pair_matvec(pd, pe, pmt, xp), P.pair_matvec_plain(pd, pe, pmt, xp))
    assert torch.equal(P.from_pair(pmt, xp), P.from_pair_plain(pmt, xp))
    assert _cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# parallel/sharding: padding and renumbering of a solver
# ---------------------------------------------------------------------------

def _compare_solver_arrays(St, Sj):
    for k in sorted(tsh.CELL_ARRAYS | {"f_cp", "f_cm", "e_c"}):
        if k == "GG":                 # each package's own einsum: round-off
            assert rel(St.g[k], Sj.g[k]) < 1e-14
        elif k in St.g and k in Sj.g:
            assert np.array_equal(to_np(St.g[k]), np.asarray(Sj.g[k])), k
    for k in ("cp", "cm"):
        assert np.array_equal(to_np(St.mem_dev[k]), np.asarray(Sj.mem_dev[k])), k
    assert np.array_equal(to_np(St.D), np.asarray(Sj.D))
    assert np.array_equal(to_np(St.rho), np.asarray(Sj.rho))
    assert np.array_equal(St._comp_np, Sj._comp_np)


def test_permute_and_pad_cells_match_jax():
    """permute_cells by a random permutation, then pad_cell_axis (the
    sharding order), and unpad_state back, on the 2D neuron solvers of
    both packages; enable_pair_layout (below) pads first."""
    Sj, _ = tp.neuron_2d_jax()
    St, _ = tp.neuron_2d_torch()
    perm = np.random.default_rng(5).permutation(St.n_cells)
    jsh.permute_cells(Sj, perm)
    tsh.permute_cells(St, perm)
    assert np.array_equal(St._cell_perm_inv, Sj._cell_perm_inv)
    extra = 7
    jsh.pad_cell_axis(Sj, extra)
    tsh.pad_cell_axis(St, extra)
    _compare_solver_arrays(St, Sj)
    assert np.array_equal(to_np(St._pad_mask), np.asarray(Sj._pad_mask))
    assert np.array_equal(to_np(St._comp_onehot), np.asarray(Sj._comp_onehot))
    assert np.array_equal(to_np(St._comp_ids), np.asarray(Sj._comp_ids))
    rng = np.random.default_rng(6)
    state = {"c": rng.standard_normal((2, St.nd, St.n_cells + extra)),
             "phi": rng.standard_normal((St.nd, St.n_cells + extra))}
    got = tsh.unpad_state(St, {k: t64(v) for k, v in state.items()})
    ref = jsh.unpad_state(Sj, {k: jnp.asarray(v) for k, v in state.items()})
    for k in state:
        assert np.array_equal(to_np(got[k]), np.asarray(ref[k])), k


def test_enable_pair_layout_renumbers_like_jax():
    """The interleaved renumbering of the whole EMIx solver: geometry,
    membrane maps, coefficients, initial fields, masks and pair data."""
    Sj, _ = tp.emix_jax()
    St, _ = tp.emix_torch()
    Sj.enable_pair_layout()
    St.enable_pair_layout()
    _compare_solver_arrays(St, Sj)
    for k in ("c_init", "c_elim_init", "phi_init", "_pad_mask", "_pair_mask",
              "_pair_bj_halves", "_pair_mass"):
        assert np.array_equal(to_np(getattr(St, k)), np.asarray(getattr(Sj, k))), k
    assert np.array_equal(St._cell_unpad_idx, Sj._cell_unpad_idx)
    assert St.n_cells_pad == Sj.n_cells_pad
    for k in Sj.pairs_host:
        assert np.array_equal(St.pairs_host[k], Sj.pairs_host[k]), k
    oh_t, ids_t = St._comp_arrays()
    oh_j, ids_j = Sj._comp_arrays()
    assert np.array_equal(to_np(oh_t), oh_j) and np.array_equal(to_np(ids_t), ids_j)


def test_pcg_nullspace_mask_matches_jax():
    """Singular SPD ring system padded with decoupled identity cells: the
    masked projection averages over the real cells and zeroes the pads."""
    rng = np.random.default_rng(7)
    nc, npad, nd = 200, 16, 3
    n = nc + npad
    nbr = np.vstack([np.arange(n), np.r_[(np.arange(nc) + 1) % nc, np.arange(nc, n)],
                     np.r_[(np.arange(nc) - 1) % nc, np.arange(nc, n)]]).astype(np.int32)
    B = np.zeros((3, nd, nd, n))
    w = rng.uniform(0.5, 1.5, nc)
    for i in range(nd):
        B[1, i, i, :nc] = -w
        B[2, i, i, :nc] = -np.roll(w, 1)
        B[0, i, i, :nc] = w + np.roll(w, 1)
        B[0, i, i, nc:] = 1.0
    B[0, :, :, :nc] += (np.eye(nd) - 1.0 / nd)[..., None] * rng.uniform(0.5, 1.0, nc)
    mask = np.arange(n) < nc
    b = rng.normal(size=(nd, n)) * mask
    b[:, :nc] -= b[:, :nc].mean()
    Pinv = 1.0 / (np.diagonal(B[0], axis1=0, axis2=1).T + 0.1)
    from knpemidg_tpu.ops.spmv import bell_matvec as jbm
    from knpemidg_tpu_torch.ops.spmv import bell_matvec

    rj = jkry.pcg(lambda v: jbm(jnp.asarray(B), jnp.asarray(nbr), v), jnp.asarray(b),
                  jnp.zeros((nd, n)), lambda r: jnp.asarray(Pinv) * r,
                  rtol=1e-10, atol=0.0, max_it=500, project_nullspace=True,
                  nullspace_mask=jnp.asarray(mask))
    rt = krylov.pcg(lambda v: bell_matvec(t64(B), torch.as_tensor(nbr), v), t64(b),
                    torch.zeros(nd, n, dtype=torch.float64), lambda r: t64(Pinv) * r,
                    rtol=1e-10, atol=0.0, max_it=500, project_nullspace=True,
                    nullspace_mask=torch.as_tensor(mask))
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    assert rel(rt.x, rj.x) < 1e-8
    assert float(rt.x[:, nc:].abs().max()) == 0.0
