"""The Ritz deflation of the port against the JAX package in float64: the
harvest functions of solvers/twolevel on the same inputs, two splitting
steps with Ritz fields on both layouts (the EMIx fixture at bench.py's AUTO
default, 24 fields on the cell layout; the 2D neuron on the pair layout with
emi_ritz=8; the host harvest on the EMIx fixture), the refresh reuse and
the state exchange of a JAX pc that carries Ritz data."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import test_torch_parity as tp
from test_torch_parity import rel, t64

from knpemidg_tpu.parallel.sharding import unpad_state as junpad
from knpemidg_tpu.solvers import twolevel as jtl
from knpemidg_tpu_torch import solver as tsolver
from knpemidg_tpu_torch.parallel.sharding import unpad_state
from knpemidg_tpu_torch.solvers import twolevel

TOL = 1e-8
FIELDS = ("phi", "c", "c_elim", "phi_M")
RITZ = ("ritz_W", "ritz_inv", "ritz_s")


def _two_steps(make_jax, make_torch, Tstop, pair=False):
    Sj, spj = make_jax()
    St, spt = make_torch()
    if pair:
        Sj.enable_pair_layout()
        St.enable_pair_layout()
    sj = Sj.solve_system_active(Tstop, 0.0, spj)
    st = St.solve_system_active(Tstop, 0.0, spt)
    return Sj, spj, sj, St, spt, st


def _assert_same_steps(Sj, sj, St, st, pair=False):
    assert Sj.stats.emi_niters == St.stats.emi_niters
    assert Sj.stats.knp_niters == St.stats.knp_niters
    assert "ritz_W" in sj["pc"]["emi"] and "ritz_W" in st["pc"]["emi"]
    if pair:
        sj, st = junpad(Sj, sj), unpad_state(St, st)
    for key in FIELDS:
        assert rel(st[key], sj[key]) < TOL, key


@pytest.fixture(scope="module")
def emix_auto():
    """Two steps of the EMIx fixture at the AUTO default in both packages;
    the pc of the final states is the initial one (no refresh)."""
    return _two_steps(tp.emix_jax_auto, tp.emix_torch_auto, 0.2)


def test_emix_auto_two_steps_match_jax(emix_auto):
    Sj, spj, sj, St, spt, st = emix_auto
    assert St.stats.emi_niters == [5, 3]
    assert St.stats.knp_niters == [[1, 1], [2, 1]]
    assert st["pc"]["emi"]["ritz_W"].shape == (24, St.nd, St.n_cells)
    _assert_same_steps(Sj, sj, St, st)


def test_neuron_2d_pair_ritz_two_steps_match_jax():
    """The device harvest on the pair layout: the production pair
    preconditioner, the live mask and the pair <-> cell field moves."""
    Sj, _, sj, St, _, st = _two_steps(lambda: tp.neuron_2d_jax(emi_ritz=8),
                                      lambda: tp.neuron_2d_torch(emi_ritz=8), 2e-4,
                                      pair=True)
    assert St.stats.emi_niters == [6, 3]
    _assert_same_steps(Sj, sj, St, st, pair=True)


def test_emix_host_harvest_two_steps_match_jax():
    """emi_ritz_host: the float64 numpy harvest (AUTO, 24 fields)."""
    Sj, _, sj, St, _, st = _two_steps(lambda: tp.emix_jax_auto(emi_ritz_host=True),
                                      lambda: tp.emix_torch_auto(emi_ritz_host=True), 0.2)
    assert St.stats.emi_niters == [5, 3]
    assert St.stats.knp_niters == [[1, 1], [2, 1]]
    _assert_same_steps(Sj, sj, St, st)


def test_pair_host_harvest_moves_fields_to_pairs():
    """emi_ritz_host on the pair layout harvests on the cell blocks and
    moves the fields to pairs: finite, exactly zero on the dead halves."""
    S, sp = tp.neuron_2d_torch(emi_ritz=8, emi_ritz_host=True)
    S.enable_pair_layout()
    pc = S.attach_pc(S._initial_state(0.0), sp)["pc"]["emi"]
    W = pc["ritz_W"]
    assert W.shape == (8, 2 * S.nd, S.pairs["int_f"].shape[0]) and W.dtype == S.dtype
    assert bool(torch.isfinite(W).all()) and float(W.abs().max()) > 0
    assert bool((W * ~S._pair_mask == 0).all())


@pytest.fixture(scope="module")
def emi_system(emix_auto):
    """The EMI blocks, rhs, P_diag of the initial state (JAX assembly) and
    the JAX pc with and without its Ritz entries, as numpy."""
    Sj, spj, sj, St, spt, st = emix_auto
    s0 = Sj._initial_state(0.0)
    pM, _, It = Sj._pads(s0)
    blocks, rhs, Pd = Sj._assemble_emi(s0["c"], s0["c_elim"], pM, It, s0["t"])
    pc = {k: np.asarray(v) for k, v in sj["pc"]["emi"].items()}
    base = {k: v for k, v in pc.items() if not k.startswith("ritz_")}
    return dict(Sj=Sj, St=St, agg=spt.agg_size, blocks=np.asarray(blocks),
                rhs=np.asarray(rhs), Pd=np.asarray(Pd), nbr=np.array(Sj.g["nbr"]),
                pc=pc, base=base)


def _both(fn_j, fn_t, *args):
    """fn of each package on the same numpy arguments (jnp / torch f64)."""
    conv_j = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    conv_t = [t64(a) if isinstance(a, np.ndarray) and a.dtype.kind == "f"
              else (torch.as_tensor(a) if isinstance(a, np.ndarray) else a) for a in args]
    return fn_j(*conv_j), fn_t(*conv_t)


@pytest.mark.parametrize("project_mean", [False, True])
def test_ritz_galerkin_host_matches_jax(emi_system, project_mean):
    e = emi_system
    rng = np.random.default_rng(31)
    W = rng.standard_normal((6,) + e["rhs"].shape)
    W[0] = 1.0                                # collapses onto the EMI nullspace
    W[1] *= 1e-9
    gj, gt = _both(lambda b, n, w: jtl.ritz_galerkin_host(b, n, w, project_mean=project_mean),
                   lambda b, n, w: twolevel.ritz_galerkin_host(b, n, w,
                                                               project_mean=project_mean),
                   e["blocks"], e["nbr"], W)
    for key in RITZ:
        assert gt[key].dtype == torch.float64
        assert rel(gt[key], gj[key]) < 1e-12, key
    if project_mean:
        assert float(gt["ritz_s"][0]) == 0.0          # the constant field is dropped
    host = twolevel.ritz_galerkin_host(e["blocks"], e["nbr"], W)
    assert host["ritz_W"].dtype == torch.float32        # numpy fields: float32, as JAX


def test_np_two_level_apply_matches_jax(emi_system):
    e = emi_system
    r = np.random.default_rng(32).standard_normal(e["rhs"].shape)
    fj = jtl.np_two_level_apply(e["pc"], e["Pd"], e["agg"])
    ft = twolevel.np_two_level_apply({k: t64(v) for k, v in e["pc"].items()},
                                     t64(e["Pd"]), e["agg"])
    assert rel(ft(r), fj(r)) < 1e-12


def _deflation_action(ritz, r):
    """W^T s inv s W r of Galerkin data (numpy float64)."""
    W, inv, s = (np.asarray(ritz[k], dtype=np.float64) for k in RITZ)
    return np.einsum("v,vic->ic", s * (inv @ (s * np.einsum("vic,ic->v", W, r))), W)


def test_ritz_lanczos_deflation_action_matches_jax(emi_system):
    """Device and host Lanczos of both packages, each through its own
    Galerkin: the deflation operators agree (the fields themselves may
    differ by signs and rotations inside near-degenerate Ritz clusters)."""
    e = emi_system
    agg, nbr = e["agg"], e["nbr"]
    r = np.random.default_rng(33).standard_normal(e["rhs"].shape)
    pj = jtl.two_level_apply_fn({k: jnp.asarray(v) for k, v in e["base"].items()},
                                jnp.asarray(e["Pd"]), agg)
    Wj = jtl.ritz_lanczos_W(jnp.asarray(e["blocks"]), jnp.asarray(nbr), pj,
                            jnp.asarray(e["rhs"]), k=40, n_ritz=24)
    pt = twolevel.two_level_apply_fn({k: t64(v) for k, v in e["base"].items()},
                                     t64(e["Pd"]), agg)
    Wt = twolevel.ritz_lanczos_W(t64(e["blocks"]), torch.as_tensor(nbr), pt,
                                 t64(e["rhs"]), k=40, n_ritz=24)
    assert Wt.shape == (24,) + e["rhs"].shape
    aj = _deflation_action(jtl.ritz_galerkin_host(e["blocks"], nbr, Wj, project_mean=True), r)
    gt = twolevel.ritz_galerkin_host(e["blocks"], nbr, Wt, project_mean=True)
    at = _deflation_action(gt, r)
    built = twolevel.build_ritz_deflation(t64(e["blocks"]), torch.as_tensor(nbr), pt,
                                          t64(e["rhs"]), k=40, n_ritz=24)
    assert all(torch.equal(built[k], gt[k]) for k in RITZ)
    assert rel(at, aj) < 1e-6
    # the JAX package's own harvest in its pc is the same operator
    assert rel(_deflation_action(e["pc"], r), aj) < 1e-6

    Hj = jtl.ritz_lanczos_W_host(e["blocks"], nbr, e["base"], e["Pd"], e["rhs"], agg,
                                 k=40, n_ritz=8)
    Ht = twolevel.ritz_lanczos_W_host(e["blocks"], nbr, e["base"], e["Pd"], e["rhs"],
                                      agg, k=40, n_ritz=8)
    hj = _deflation_action(jtl.ritz_galerkin_host(e["blocks"], nbr, Hj, project_mean=True), r)
    ht = _deflation_action(twolevel.ritz_galerkin_host(e["blocks"], nbr, Ht,
                                                       project_mean=True), r)
    assert rel(ht, hj) < 1e-6


def test_jax_pc_with_ritz_drives_the_port_apply(emi_system):
    """state_to_numpy / state_from_numpy carry the ritz_* entries: the JAX
    pc moved into the port gives the JAX apply to round-off."""
    e = emi_system
    Sj, St = e["Sj"], e["St"]
    st = tp.jax_state_for_torch(dict(Sj._initial_state(0.0),
                                     pc={"emi": e["pc"]}), St)
    assert all(k in st["pc"]["emi"] for k in RITZ)
    r = np.random.default_rng(34).standard_normal(e["rhs"].shape)
    fj = jtl.two_level_apply_fn({k: jnp.asarray(v) for k, v in e["pc"].items()},
                                jnp.asarray(e["Pd"]), e["agg"])
    ft = twolevel.two_level_apply_fn(st["pc"]["emi"], t64(e["Pd"]), e["agg"])
    assert rel(ft(t64(r)), fj(jnp.asarray(r))) < 1e-12


def test_refresh_keeps_the_ritz_harvest(emix_auto):
    """A pc refresh rebuilds the coarse data at the new state and keeps the
    t = 0 Ritz entries bit for bit (pc_refresh_every)."""
    _, _, _, St, spt, st = emix_auto
    sp = dataclasses.replace(spt, pc_refresh_every=1)
    refreshed = St._refresh_pc(st, sp)
    for key in RITZ:
        assert torch.equal(refreshed["pc"]["emi"][key], st["pc"]["emi"][key]), key
    assert not torch.equal(refreshed["pc"]["emi"]["inv"], st["pc"]["emi"]["inv"])


def test_auto_rule_and_non_finite_harvest(monkeypatch, capsys):
    """AUTO gives no Ritz fields on the pair layout; a non-finite harvest is
    dropped with a warning instead of entering the preconditioner."""
    S, sp = tp.neuron_2d_torch(emi_ritz=-1)
    S.enable_pair_layout()
    assert "ritz_W" not in S.attach_pc(S._initial_state(0.0), sp)["pc"]["emi"]

    def nan_galerkin(*args, **kw):
        out = twolevel.ritz_galerkin_host(*args, **kw)
        return dict(out, ritz_s=out["ritz_s"] * float("nan"))

    monkeypatch.setattr(tsolver, "ritz_galerkin_host", nan_galerkin)
    S, sp = tp.neuron_2d_torch(emi_ritz=-1)
    pc = S.attach_pc(S._initial_state(0.0), sp)["pc"]["emi"]
    assert "ritz_W" not in pc and "mom_W" in pc
    assert "harvest non-finite" in capsys.readouterr().out
