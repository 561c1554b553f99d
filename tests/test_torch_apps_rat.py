"""The port's rat-neuron app (knpemidg_tpu_torch.apps.run_rat_neuron)
against the JAX package's examples/run_rat_neuron.py in float64 on the
CPU: one ODE step (Solver._ode_step: the pushes, LeakSI beside
HodgkinHuxleySI, the pulls) on the synthetic bifurcating neuron (64,800
tets), started from the JAX state through state_from_numpy."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

import test_torch_parity  # noqa: F401  (puts examples/ on sys.path)
from test_torch_ode_step import _assert_steps_equal, _states

from knpemidg_tpu_torch.apps import run_rat_neuron

F64 = torch.float64


_SOLVERS = []                  # (JAX solver, port solver), built once


def _rat_neuron():
    if not _SOLVERS:
        from run_rat_neuron import build_solver

        _SOLVERS.append((build_solver(resolution=0, dtype=jnp.float64),
                         run_rat_neuron.build_solver(resolution=0, dtype=F64, device="cpu")))
    return _SOLVERS[0]


@pytest.mark.parametrize("scheme", ["rk4", "rush_larsen"])
def test_rat_neuron_ode_step_matches_jax(scheme):
    """One Solver._ode_step of the rat-neuron app from a perturbed JAX state
    carried into the port: the membrane states and parameters, phi_M and
    every ion's I_ch to rel 1e-12."""
    Sj, St = _rat_neuron()
    for S in (Sj, St):
        S.params = dataclasses.replace(S.params, ode_scheme=scheme)
    sj, st = _states(Sj, St, seed=12)
    assert [type(mm.model).__name__ for mm in st["mem"].values()] == [
        "LeakSI", "HodgkinHuxleySI"]
    _assert_steps_equal(Sj._ode_step(sj, first_step=False), St._ode_step(st, first_step=False))
