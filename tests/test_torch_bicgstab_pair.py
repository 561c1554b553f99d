"""Two splitting steps of the EMIx fixture with ``knp_solver="bicgstab"``
on the pair layout, the port (krylov.bicgstab_batched, kernel K15's plain
versions on the CPU) against the JAX package in float64, and how far
rounding alone moves that solve."""
import functools

import pytest
import torch

import test_torch_parity as tp
from test_torch_parity import rel

from knpemidg_tpu.parallel.sharding import unpad_state as junpad
from knpemidg_tpu_torch.parallel.sharding import unpad_state

TOL = 1e-8


def _port_run(monkeypatch, ordered):
    """The port's two steps on the pair layout with K15's plain twins in
    the einsum (``ordered`` False, the CPU path) or the kernel order: the
    Krylov counts, the unpadded final state and the second step's
    preconditioned residual norms over tolerance after every iteration."""
    from knpemidg_tpu_torch.ops import krylov_ops as ko

    history = []
    start, alpha, omega = (functools.partial(getattr(ko, e + "_plain"), ordered=ordered)
                           for e in ("bicgstab_start", "bicgstab_alpha", "bicgstab_omega"))

    def logged_start(*args):
        history.append([])
        return start(*args)

    def logged_omega(t, x, wk):
        omega(t, x, wk)
        history[-1].append(torch.sqrt(wk.sc[:, ko.BI_RR]) / wk.sc[:, ko.BI_TOL])
        return wk

    monkeypatch.setattr(ko, "bicgstab_start", logged_start)
    monkeypatch.setattr(ko, "bicgstab_alpha", alpha)
    monkeypatch.setattr(ko, "bicgstab_omega", logged_omega)
    S, sp = tp.emix_torch(knp_solver="bicgstab")
    S.enable_pair_layout()
    st = unpad_state(S, S.solve_system_active(0.2, 0.0, sp))
    return S.stats.emi_niters, S.stats.knp_niters, st, torch.stack(history[1])


@pytest.fixture(scope="module")
def port_einsum():
    """The port's two steps with the einsum twins (the CPU path), run once
    for both tests."""
    with pytest.MonkeyPatch.context() as mp:
        return _port_run(mp, ordered=False)


def test_emix_pair_bicgstab_two_steps_match_jax(port_einsum):
    """Two steps of the EMIx fixture with the BiCGStab KNP solve on the pair
    layout (the live-masked two-level apply): equal Krylov counts, phi and
    phi_M to 1e-8, c and c_elim to 1e-7 after unpad_state.  On this layout
    the solve converges slowly (7-10 iterations at rtol_knp 1e-7, 60-110 at
    1e-9 to 1e-10, in both packages), so rounding reaches further into c:
    the port's c is 3.1e-8 off the JAX package's, while the JAX package's
    own BiCGStab and GMRES solutions differ by 1.3e-6 at this rtol."""
    Sj, spj = tp.emix_jax(knp_solver="bicgstab")
    Sj.enable_pair_layout()
    sj = junpad(Sj, Sj.solve_system_active(0.2, 0.0, spj))
    emi, knp, st, _ = port_einsum
    assert Sj.stats.emi_niters == emi == [3, 9]
    assert Sj.stats.knp_niters == knp == [[7, 10], [7, 8]]
    for key, tol in (("phi", TOL), ("phi_M", TOL), ("c", 1e-7), ("c_elim", 1e-7)):
        assert rel(st[key], sj[key]) < tol, key


def test_emix_pair_bicgstab_exit_moves_with_summation_order(monkeypatch, port_einsum):
    """How far rounding alone moves the pair layout's BiCGStab solve (the
    reason the card test holds the card's pair run to the CPU's with KNP
    counts within one and phi to 1e-7, c to 1e-6): the same two steps with
    K15's kernel-ordered plain twins in place of the einsum ones, so that
    only the summation order of the dots changes, move the second step's
    preconditioned residual norms by more than 10% at some iteration
    (system 1's sixth: 3.21 against 2.17 tolerances) and c by 4.4e-8, phi
    by 9.3e-9, with equal counts."""
    _, n0, s0, h0 = port_einsum
    _, n1, s1, h1 = _port_run(monkeypatch, ordered=True)
    assert n0 == n1 == [[7, 10], [7, 8]]
    assert float(((h1 - h0).abs() / h0).max()) > 0.1
    for key, tol in (("phi", 1e-7), ("phi_M", 1e-7), ("c", 1e-6), ("c_elim", 1e-6)):
        assert 0.0 < rel(s1[key], s0[key]) < tol, key
