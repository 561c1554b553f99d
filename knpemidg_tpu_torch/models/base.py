"""Membrane ODE model protocol (torch port of knpemidg_tpu/models/base.py).

A model is a small object with name->index maps and two pure functions of
torch tensors.  ``rhs``/``currents`` take the state ``y`` and parameters
``p`` with the membrane-point axis last -- ``y (n_states, n)``,
``p (n_params, n)`` -- and return the same layout, so the plain path
evaluates all points at once.  ``cuda_model_id`` names the device function
the ODE kernel (``csrc/membrane_rk4.cu``) dispatches on; 0 means the model
has no CUDA right-hand side.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


class ODEModel:
    """Base: subclasses set STATE_NAMES / PARAM_DEFAULTS and implement
    rhs / currents using the `p` accessor."""

    STATE_NAMES: Sequence[str] = ()
    STATE_INIT: Sequence[float] = ()
    # name -> default value
    PARAM_DEFAULTS: Dict[str, float] = {}
    cuda_model_id: int = 0

    def __init__(self, **overrides):
        self.STATES = {n: i for i, n in enumerate(self.STATE_NAMES)}
        self.PARAMS = {n: i for i, n in enumerate(self.PARAM_DEFAULTS)}
        self._param_init = np.array(
            [overrides.get(k, v) for k, v in self.PARAM_DEFAULTS.items()],
            dtype=np.float64,
        )
        self._state_init = np.array(self.STATE_INIT, dtype=np.float64)
        self.name = type(self).__name__

    def init_states(self):
        return self._state_init.copy()

    def init_params(self):
        return self._param_init.copy()

    def p(self, params, name):
        return params[self.PARAMS[name]]

    def rhs(self, t, y, params):                      # pragma: no cover
        raise NotImplementedError

    def currents(self, t, y, params) -> Dict[str, torch.Tensor]:  # pragma: no cover
        raise NotImplementedError

    # -- Rush-Larsen split (optional) ---------------------------------------
    GATING_STATES: Sequence[str] = ()

    def gating_indices(self):
        """Tuple of gating-state indices (empty when the model declares
        none; the engine then uses RK4)."""
        return tuple(self.STATES[n] for n in self.GATING_STATES)

    def gating_rates(self, t, y, params):             # pragma: no cover
        """(alpha, beta) stacked over GATING_STATES order."""
        raise NotImplementedError


def sodium_potassium_pump_saturating(I_max, m_K, K_e, m_Na, Na_i):
    """Na/K-ATPase: I_max / ((1 + m_K/K_e)^2 (1 + m_Na/Na_i)^3)."""
    return I_max / ((1 + m_K / K_e) ** 2 * (1 + m_Na / Na_i) ** 3)


def sodium_potassium_pump_michaelis(I_max, m_K, K_e, m_Na, Na_i):
    """The astrocyte glial model's pump law:
    I_max K_e / (K_e + m_K) * Na_i^1.5 / (Na_i^1.5 + m_Na^1.5)."""
    return (
        I_max
        * (K_e / (K_e + m_K))
        * (Na_i**1.5 / (Na_i**1.5 + m_Na**1.5))
    )


def vtrap(x, y):
    """x / (1 - exp(-x/y)) with the removable singularity at x = 0 handled
    by the series y * (1 + u/2 + u^2/12), u = x/y."""
    u = x / y
    small = torch.abs(u) < 1e-4
    safe = torch.where(small, torch.ones_like(u), u)
    return torch.where(
        small, y * (1.0 + u / 2.0 + u * u / 12.0), x / (1.0 - torch.exp(-safe))
    )


def hh_gating_rates_mV(V):
    """Classic HH 1952 rate functions, V in mV, rates in 1/ms."""
    am = 0.1 * vtrap(V + 40.0, 10.0)
    bm = 4.0 * torch.exp(-(V + 65.0) / 18.0)
    ah = 0.07 * torch.exp(-(V + 65.0) / 20.0)
    bh = 1.0 / (1.0 + torch.exp(-(V + 35.0) / 10.0))
    an = 0.01 * vtrap(V + 55.0, 10.0)
    bn = 0.125 * torch.exp(-(V + 65.0) / 80.0)
    return am, bm, ah, bh, an, bn


def hh_gating_rates_SI(V):
    """Same rates with V in volts, rates in 1/s."""
    v = V * 1e3  # mV
    am = 0.1e3 * vtrap(v + 40.0, 10.0)
    bm = 4.0e3 * torch.exp(-(v + 65.0) / 18.0)
    ah = 0.07e3 * torch.exp(-(v + 65.0) / 20.0)
    bh = 1.0e3 / (torch.exp((30.0 - (v + 65.0)) / 10.0) + 1.0)
    an = 0.01e3 * vtrap(v + 55.0, 10.0)
    bn = 0.125e3 * torch.exp(-(v + 65.0) / 80.0)
    return am, bm, ah, bh, an, bn
