"""ops/coarse (kernels K6/K7, their plain versions on the CPU) against the
JAX package in float64: two_level_apply_fn and two_level_apply_batched of
both packages on the same seeded two-level data -- coarse inv / As / s,
compartment, moment and Ritz fields -- at a small size with a pad in the
last chunk, for nd = 4 and nd = 8; the per-solve workspace that
coarse.operands checks and builds once; and the fields' spans it carries
(the cells where each field can be nonzero, which the kernels read) on the
pc builds of the EMIx fixture (cell and pair layouts) and the 2D neuron."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_parity as tp
from test_torch_parity import N_COMP, NW, NR, rel, t64, two_level_data

from knpemidg_tpu.solvers import twolevel as jtl
from knpemidg_tpu_torch.ops import coarse
from knpemidg_tpu_torch.solvers import twolevel

TOL = 1e-12
NC, AGG = 1000, 64            # 16 chunks, the last one 24 cells short


def _data(rng, nd, groups=("As", "comp", "mom", "ritz"), m=None):
    return two_level_data(rng, nd, NC, AGG, groups, m)


def _P_diag(rng, nd, m=None):
    P = 0.1 * rng.standard_normal(((m,) if m else ()) + (nd, nd, NC))
    return P + 4.0 * np.eye(nd)[:, :, None]


GROUPS = {"full": ("As", "comp", "mom", "ritz"), "coarse": (), "refined": ("As",),
          "moment": ("As", "comp", "mom"), "ritz": ("ritz",)}


@pytest.mark.parametrize("nd", [4, 8])
@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_two_level_apply_matches_jax(nd, groups):
    rng = np.random.default_rng(21)
    d = _data(rng, nd, GROUPS[groups])
    P = _P_diag(rng, nd)
    r = rng.standard_normal((nd, NC))
    fj = jtl.two_level_apply_fn({k: jnp.asarray(v) for k, v in d.items()},
                                jnp.asarray(P), AGG)
    ft = twolevel.two_level_apply_fn({k: t64(v) for k, v in d.items()}, t64(P), AGG)
    assert rel(ft(t64(r)), fj(jnp.asarray(r))) < TOL


@pytest.mark.parametrize("nd", [4, 8])
@pytest.mark.parametrize("refine", [False, True])
def test_two_level_apply_batched_matches_jax(nd, refine):
    rng = np.random.default_rng(22)
    d = _data(rng, nd, ("As",) if refine else (), m=2)
    P = _P_diag(rng, nd, m=2)
    r = rng.standard_normal((2, nd, NC))
    gj = jtl.two_level_apply_batched({k: jnp.asarray(v) for k, v in d.items()},
                                     jnp.asarray(P), AGG)
    gt = twolevel.two_level_apply_batched({k: t64(v) for k, v in d.items()}, t64(P), AGG)
    assert rel(gt(t64(r)), gj(jnp.asarray(r))) < TOL


def test_coarse_steps_match_the_reference_formulas():
    """restrict, solve and prolong_add one by one against numpy float64."""
    rng = np.random.default_rng(23)
    nd = 4
    d = _data(rng, nd)
    r = rng.standard_normal((1, nd, NC))
    co = coarse.operands({k: t64(v) for k, v in d.items()}, AGG, batched=False)
    rc, proj = coarse.restrict(co, t64(r))
    rs = r[0].sum(axis=0)
    n = d["s"].shape[0]
    rc_ref = np.pad(rs, (0, n * AGG - NC)).reshape(n, AGG).sum(axis=1)
    proj_ref = np.concatenate([d["comp_onehot"] @ rs,
                               np.einsum("wic,ic->w", d["mom_W"], r[0]),
                               np.einsum("vic,ic->v", d["ritz_W"], r[0])])
    assert rel(rc[0], rc_ref) < TOL and rel(proj[0], proj_ref) < TOL

    zc, coef = coarse.solve(co, rc, proj)
    x = d["s"] * rc_ref
    z = d["inv"] @ x
    z = z + d["inv"] @ (x - d["As"] @ z)
    assert rel(zc[0], d["s"] * z) < TOL
    xc = d["comp_s"] * proj_ref[:N_COMP]
    y = d["comp_inv"] @ xc
    y = y + d["comp_inv"] @ (xc - d["comp_As"] @ y)
    coef_ref = [d["comp_s"] * y]
    for key, a, b in (("mom", N_COMP, N_COMP + NW), ("ritz", N_COMP + NW, None)):
        sg = d[f"{key}_s"]
        coef_ref.append(sg * (d[f"{key}_inv"] @ (sg * proj_ref[a:b])))
    assert rel(coef[0], np.concatenate(coef_ref)) < TOL

    out0 = rng.standard_normal((1, nd, NC))
    out = coarse.prolong_add(co, t64(out0), zc, coef)
    c = coef[0].numpy()
    v = np.repeat(zc[0].numpy(), AGG)[:NC] + c[:N_COMP] @ d["comp_onehot"]
    v = (v[None] + np.einsum("w,wic->ic", c[N_COMP:N_COMP + NW], d["mom_W"])
         + np.einsum("v,vic->ic", c[N_COMP + NW:], d["ritz_W"]))
    assert rel(out[0], out0[0] + v) < TOL


@pytest.mark.parametrize("groups", ["full", "coarse", "refined"])
@pytest.mark.parametrize("nd", [4, 8])
def test_masked_coarse_apply_equals_the_plain_steps_bitwise(nd, groups):
    """coarse_add with the live mask (K6 with its groups, K7 without) and
    coarse_apply_plain equal restrict_plain -> solve_plain ->
    prolong_add_plain -> * mask bit for bit, -0 included; without the mask
    they equal the unmasked steps."""
    rng = np.random.default_rng(27)
    batched = groups == "coarse"
    d = _data(rng, nd, GROUPS[groups], m=2 if batched else None)
    co = coarse.operands({k: t64(v) for k, v in d.items()}, AGG, batched)
    m = 2 if batched else 1
    r = t64(rng.standard_normal((m, nd, NC)))
    out0 = t64(rng.standard_normal((m, nd, NC)))
    mask = t64((rng.uniform(size=(nd, NC)) < 0.8).astype(np.float64))
    ref = coarse.prolong_add_plain(co, out0.clone(), *coarse.solve_plain(
        co, *coarse.restrict_plain(co, r))) * mask
    bits = lambda t: t.view(torch.int64)
    for got in (coarse.coarse_add(co, out0.clone(), r, mask),
                coarse.coarse_apply_plain(co, out0.clone(), r, mask)):
        assert torch.equal(bits(got), bits(ref))
    assert bool((bits(ref) == bits(torch.tensor(-0.0, dtype=torch.float64))).any())
    plain = coarse.prolong_add_plain(co, out0.clone(), *coarse.solve_plain(
        co, *coarse.restrict_plain(co, r)))
    assert torch.equal(bits(coarse.coarse_add(co, out0.clone(), r)), bits(plain))


def test_masked_applies_equal_the_product_with_the_mask():
    """two_level_apply_fn / two_level_apply_batched with ``mask`` (and the
    output buffer of the pair solves) equal the unmasked apply times the
    mask bit for bit, apply after apply."""
    rng = np.random.default_rng(28)
    nd = 8
    d, dK = _data(rng, nd), _data(rng, nd, (), m=2)
    P, PK = t64(_P_diag(rng, nd)), t64(_P_diag(rng, nd, m=2))
    mask = t64((rng.uniform(size=(nd, NC)) < 0.8).astype(np.float64))
    pairs_ = [(twolevel.two_level_apply_fn({k: t64(v) for k, v in d.items()}, P, AGG),
               twolevel.two_level_apply_fn({k: t64(v) for k, v in d.items()}, P, AGG,
                                           buffer=True, mask=mask), (nd, NC)),
              (twolevel.two_level_apply_batched({k: t64(v) for k, v in dK.items()}, PK, AGG),
               twolevel.two_level_apply_batched({k: t64(v) for k, v in dK.items()}, PK, AGG,
                                                buffer=True, mask=mask), (2, nd, NC))]
    for f, g, shape in pairs_:
        for _ in range(2):
            r = t64(rng.standard_normal(shape))
            assert torch.equal((f(r) * mask).view(torch.int64), g(r).view(torch.int64))


def test_operands_count_k6_and_k7_apart():
    rng = np.random.default_rng(24)
    co6 = coarse.operands({k: t64(v) for k, v in _data(rng, 4).items()}, AGG, False)
    co7 = coarse.operands({k: t64(v) for k, v in _data(rng, 4, ("As",), m=2).items()},
                          AGG, True)
    assert co6.inv.shape == (1, 16, 16) and co6.sizes == (N_COMP, NW, NR)
    assert co7.inv.shape == (2, 16, 16) and co7.sizes == (0, 0, 0)
    assert coarse._name("solve", co6) == "two_level_solve"
    assert coarse._name("solve", co7) == "two_level_solve_batched"


def test_unported_two_level_data_raise():
    rng = np.random.default_rng(25)
    d = {k: t64(v) for k, v in _data(rng, 4).items()}
    P = t64(_P_diag(rng, 4))
    with pytest.raises(NotImplementedError):             # emi_moment_blocked stays unported
        twolevel.two_level_apply_fn(dict(d, momb_W=d["s"]), P, AGG)
    with pytest.raises(NotImplementedError):             # knp_ritz stays unported
        twolevel.two_level_apply_batched(
            {"inv": d["inv"][None], "s": d["s"][None], "ritz_W": d["ritz_W"]},
            P[None], AGG)
    with pytest.raises(NotImplementedError):
        twolevel.np_two_level_apply(dict(d, momb_W=d["s"]), P, AGG)


@pytest.mark.parametrize("nd", [4, 8])
def test_one_apply_closure_serves_many_vectors(nd):
    """An apply closure (one workspace per solve) applied to two vectors
    in turn gives the JAX apply of each, K6 and K7."""
    rng = np.random.default_rng(26)
    d, dK = _data(rng, nd), _data(rng, nd, ("As",), m=2)
    P, PK = _P_diag(rng, nd), _P_diag(rng, nd, m=2)
    fj = jtl.two_level_apply_fn({k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(P), AGG)
    ft = twolevel.two_level_apply_fn({k: t64(v) for k, v in d.items()}, t64(P), AGG)
    gj = jtl.two_level_apply_batched({k: jnp.asarray(v) for k, v in dK.items()},
                                     jnp.asarray(PK), AGG)
    gt = twolevel.two_level_apply_batched({k: t64(v) for k, v in dK.items()}, t64(PK), AGG)
    for _ in range(2):
        r, rK = rng.standard_normal((nd, NC)), rng.standard_normal((2, nd, NC))
        assert rel(ft(t64(r)), fj(jnp.asarray(r))) < TOL
        assert rel(gt(t64(rK)), gj(jnp.asarray(rK))) < TOL


@pytest.mark.parametrize("batched", [False, True])
def test_operands_build_the_solve_workspace(batched):
    """coarse.operands checks the frozen data once and builds the solve's
    workspace: restrict's and solve's output buffers, the refinement's z1
    and t only with As, the launch counters' names, no launch parameters
    off the card; restrict and solve through it give the plain results."""
    rng = np.random.default_rng(27)
    d = _data(rng, 4, ("As",), m=2) if batched else _data(rng, 4)
    co = coarse.operands({k: t64(v) for k, v in d.items()}, AGG, batched)
    wk = co.work
    m, nf = (2, 0) if batched else (1, N_COMP + NW + NR)
    assert (wk.m, wk.n, wk.nd, wk.nc) == ((m, 16, None, None) if batched else (m, 16, 4, NC))
    assert wk.rc.shape == wk.zc.shape == wk.z1.shape == wk.t.shape == (m, 16)
    assert wk.proj.shape == wk.coef.shape == (m, nf) and wk.partial.shape == (m, nf, 4)
    assert wk.params is None and wk.ops.work is None and wk.ops.inv is co.inv
    sfx = "_batched" if batched else ""
    assert wk.names == tuple(f"two_level_{e}{sfx}" for e in ("restrict", "solve", "prolong"))
    r = t64(rng.standard_normal((m, 4, NC)))
    rc, proj = coarse.restrict(co, r)
    for a, b in zip((rc, proj), coarse.restrict_plain(co, r)):
        assert torch.equal(a, b)
    for a, b in zip(coarse.solve(co, rc, proj), coarse.solve_plain(co, rc, proj)):
        assert torch.equal(a, b)
    co1 = coarse.operands({k: t64(v) for k, v in _data(rng, 4, ()).items()}, AGG, False)
    assert co1.work.z1 is None and co1.work.t is None


def _drop_mom_inv(d):
    del d["mom_inv"]


def _cut_cells(d):
    for k in ("comp_onehot", "mom_W", "ritz_W"):
        d[k] = d[k][..., :-AGG]


# frozen data operands() refuses: (change, exception)
BAD_OPERANDS = {
    "inv_not_square": (lambda d: d.update(inv=d["inv"][:, :-1]), ValueError),
    "s_shape": (lambda d: d.update(s=d["s"][:-1]), ValueError),
    "As_dtype": (lambda d: d.update(As=d["As"].float()), TypeError),
    "field_cells": (lambda d: d.update(mom_W=d["mom_W"][..., :-1]), ValueError),
    "chunks": (_cut_cells, ValueError),
    "group_without_galerkin": (_drop_mom_inv, ValueError),
    "two_devices": (lambda d: d.update(ritz_W=d["ritz_W"].to("meta")), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_OPERANDS))
def test_operands_refuse_inconsistent_data(case):
    """Inconsistent two-level data raises once, when the solve's operands
    are built, on every device: the CUDA wrappers no longer check the
    frozen data per call."""
    rng = np.random.default_rng(28)
    d = {k: t64(v) for k, v in _data(rng, 4).items()}
    change, exc = BAD_OPERANDS[case]
    change(d)
    with pytest.raises(exc):
        coarse.operands(d, AGG, batched=False)


# ---------------------------------------------------------------------------
# the fields' spans: where the restrict and prolong kernels read each field
# ---------------------------------------------------------------------------

SPAN_FIXTURES = {"emix_cell": lambda: tp.emix_torch_auto(),
                 "emix_pair": lambda: tp.emix_torch_auto(pair=True),
                 "neuron_2d": lambda: tp.neuron_2d_torch()}


@pytest.fixture(scope="module", params=sorted(SPAN_FIXTURES))
def solver_pc(request):
    """(the EMI pc data of a pc build at the fixture's solver params, the
    K6 operands built from it, the fixture's name)."""
    S, sp = SPAN_FIXTURES[request.param]()
    pc = S.attach_pc(S._initial_state(0.0), sp)["pc"]["emi"]
    agg = sp.agg_size // 2 if S.pair_layout else sp.agg_size
    return pc, coarse.operands(pc, agg, batched=False), request.param


def _cell_ranges(rows):
    """Per row of rows (k, nc) or (k, nd, nc): the cells where it is
    nonzero, as sorted index arrays."""
    nz = rows != 0
    if nz.dim() == 3:
        nz = nz.any(dim=1)
    return [torch.nonzero(z).flatten() for z in nz]


def test_spans_cover_every_nonzero_of_the_solver_fields(solver_pc):
    """Each span is the tightest range holding all of its field's nonzero
    cells: its ends are nonzero cells (an all-zero field: (0, 0))."""
    pc, co, _ = solver_pc
    spans = co.work.spans
    fields = [pc[k] for k in ("comp_onehot", "mom_W", "ritz_W") if k in pc]
    nz = [c for t in fields for c in _cell_ranges(t)]
    assert spans.dtype == torch.int32 and spans.shape == (len(nz), 2)
    for (lo, hi), cells in zip(spans.tolist(), nz):
        if cells.numel() == 0:
            assert (lo, hi) == (0, 0)
        else:
            assert (lo, hi) == (int(cells[0]), int(cells[-1]) + 1)


def test_moment_spans_are_their_compartments(solver_pc):
    """Cells (pairs) are numbered by compartment, so each compartment is one
    contiguous range of its one-hot; each moment field's span lies inside
    its compartment's range and, as every moment field is nonzero
    throughout its compartment, the spans of a compartment's fields sum to
    (fields per compartment) x (its cells or pairs).  The Ritz fields
    (cell layout) are dense: whole spans."""
    pc, co, name = solver_pc
    n_comp, nw, nr = co.sizes
    per = nw // n_comp
    assert per * n_comp == nw and per == (5 if name == "neuron_2d" else 9)
    spans = co.work.spans.long()
    nc = pc["comp_onehot"].shape[1]
    for p, cells in enumerate(_cell_ranges(pc["comp_onehot"])):
        lo, hi = int(cells[0]), int(cells[-1]) + 1
        assert cells.numel() == hi - lo                  # one contiguous range
        assert spans[p].tolist() == [lo, hi]
        mom = spans[n_comp + p * per:n_comp + (p + 1) * per]
        assert bool((mom[:, 0] >= lo).all()) and bool((mom[:, 1] <= hi).all())
        assert int((mom[:, 1] - mom[:, 0]).sum()) == per * (hi - lo)
    if name == "emix_cell":
        assert nr == 24
    assert spans[n_comp + nw:].tolist() == [[0, nc]] * nr


def test_field_spans_of_chosen_fields():
    """field_spans on fields built to test it: zero outside a range, a
    single cell, all zero, a NaN, nonzero in one of the nd rows only."""
    nc = 50
    F = torch.zeros((5, 3, nc), dtype=torch.float64)
    F[0, :, 10:20] = 1.0
    F[1, 2, 7] = -3.0
    F[3, 1, 0] = float("nan")
    F[3, 0, 49] = 1e-300
    F[4, 1, 30:31] = -0.5
    assert coarse.field_spans(F).tolist() == [[10, 20], [7, 8], [0, 0], [0, 50], [30, 31]]
    assert coarse.field_spans(F[:, 0]).tolist() == [[10, 20], [0, 0], [0, 0], [49, 50], [0, 0]]
    assert coarse.field_spans(F[:0]).shape == (0, 2)
    assert coarse.field_spans(-0.0 * F[:1]).tolist() == [[0, 0]]


def test_span_table_is_computed_once_per_field_tensor(monkeypatch):
    """Operands built again from the same frozen data (every solve of one
    pc build) reuse the span table: field_spans runs once per field
    tensor, and again only for a tensor changed in place."""
    calls = []
    spans_fn = coarse.field_spans
    monkeypatch.setattr(coarse, "field_spans", lambda F: calls.append(F) or spans_fn(F))
    rng = np.random.default_rng(29)
    d = {k: t64(v) for k, v in _data(rng, 4).items()}
    co1 = coarse.operands(d, AGG, batched=False)
    co2 = coarse.operands(d, AGG, batched=False)
    f = twolevel.two_level_apply_fn(d, t64(_P_diag(rng, 4)), AGG)
    f(t64(rng.standard_normal((4, NC))))
    assert len(calls) == 3 and co2.work.spans is co1.work.spans
    d["mom_W"][0, 0, :3] = 0.0                           # in place: a new version
    co3 = coarse.operands(d, AGG, batched=False)
    assert len(calls) == 4 and calls[-1] is d["mom_W"]
    assert co3.work.spans is not co1.work.spans
    assert co3.work.spans[N_COMP].tolist() == [0, NC]    # rows 1-3 still start at 0


def test_plain_versions_stay_dense():
    """restrict_plain and prolong_add_plain (the CPU path) read every field
    whole: a span table that claims every field is empty changes neither,
    and both equal the dense formulas."""
    rng = np.random.default_rng(30)
    nd = 4
    d = _data(rng, nd)
    co = coarse.operands({k: t64(v) for k, v in d.items()}, AGG, batched=False)
    empty = torch.zeros_like(co.work.spans)
    bare = co._replace(work=co.work._replace(spans=empty))
    r = t64(rng.standard_normal((1, nd, NC)))
    rc, proj = coarse.restrict(bare, r)
    for a, b in zip((rc, proj), coarse.restrict_plain(co, r)):
        assert torch.equal(a, b)
    proj_ref = np.concatenate([d["comp_onehot"] @ r[0].numpy().sum(axis=0),
                               np.einsum("wic,ic->w", d["mom_W"], r[0].numpy()),
                               np.einsum("vic,ic->v", d["ritz_W"], r[0].numpy())])
    assert rel(proj[0], proj_ref) < TOL
    zc, coef = coarse.solve_plain(co, rc, proj)
    out0 = t64(rng.standard_normal((1, nd, NC)))
    out = coarse.prolong_add(bare, out0.clone(), zc, coef)
    assert torch.equal(out, coarse.prolong_add_plain(co, out0.clone(), zc, coef))
    c = coef[0].numpy()
    v = np.repeat(zc[0].numpy(), AGG)[:NC] + c[:N_COMP] @ d["comp_onehot"]
    v = (v[None] + np.einsum("w,wic->ic", c[N_COMP:N_COMP + NW], d["mom_W"])
         + np.einsum("v,vic->ic", c[N_COMP + NW:], d["ritz_W"]))
    assert rel(out[0], out0[0].numpy() + v) < TOL
