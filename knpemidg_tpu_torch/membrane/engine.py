"""Membrane ODE engine (torch port of knpemidg_tpu/membrane/engine.py).

Fixed-substep integration of the per-point membrane ODEs of one tag, all
points at once.  Kernel C (``csrc/membrane_rk4.cu``) carries the step on
CUDA tensors: one thread per membrane point runs every substep in
registers and writes the channel currents back into the parameters; the
RK4 kernel serves every scheme of a model without gating states, the
Rush-Larsen kernel the gated Hodgkin-Huxley model.  The plain torch version
below is what runs for CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import _cuda

# parameter names of the CUDA model slots (csrc/membrane_rk4.cu P_* enum)
CUDA_PARAMS = ("g_Na_bar", "g_K_bar", "g_leak_Na", "g_leak_K", "E_Na", "E_K",
               "E_Cl", "Cm", "stim_amplitude", "I_ch_Na", "I_ch_K", "I_ch_Cl",
               "K_e", "Na_i", "m_K", "m_Na", "I_max", "K_e_init", "K_i_init")


@dataclasses.dataclass
class MembraneState:
    """States/params for all membrane points of one tag, points LAST:
    ``states (n_states, n)``, ``params (n_params, n)``.  Updates return a
    new state (the tensors of the old one are left as they were)."""

    states: torch.Tensor
    params: torch.Tensor
    model: Any

    def has_param(self, name) -> bool:
        return name in self.model.PARAMS

    def has_state(self, name) -> bool:
        return name in self.model.STATES

    def get_state(self, name):
        return self.states[self.model.STATES[name]]

    def replace_state(self, name, values):
        states = self.states.clone()
        states[self.model.STATES[name]] = values
        return dataclasses.replace(self, states=states)


def make_membrane(model, midpoints: np.ndarray, dtype=torch.float64, *,
                  device) -> MembraneState:
    n = len(midpoints)
    s0 = np.asarray(model.init_states(), dtype=np.float64)
    p0 = np.asarray(model.init_params(), dtype=np.float64)
    return MembraneState(
        states=torch.as_tensor(np.tile(s0[:, None], (1, n)), dtype=dtype,
                               device=device),
        params=torch.as_tensor(np.tile(p0[:, None], (1, n)), dtype=dtype,
                               device=device),
        model=model,
    )


def set_param(mm: MembraneState, name: str, values) -> MembraneState:
    params = mm.params.clone()
    params[mm.model.PARAMS[name]] = torch.as_tensor(
        values, dtype=params.dtype, device=params.device)
    return dataclasses.replace(mm, params=params)


def get_param(mm: MembraneState, name: str):
    return mm.params[mm.model.PARAMS[name]]


def _as_time(t, like):
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def ode_step_plain(mm: MembraneState, t, dt: float, n_sub: int,
                   scheme: str = "rk4") -> MembraneState:
    """Advance all points by dt with n_sub substeps, then refresh the
    channel-current parameters from the final state at t + dt.

    ``scheme``: ``"rk4"`` (classic fixed-substep RK4) or ``"rush_larsen"``
    (exponential gate update, midpoint RK2 for the rest, Strang split;
    RK4 when the model declares no gating states)."""
    model = mm.model
    y, p = mm.states, mm.params
    t = _as_time(t, y)
    h = dt / n_sub
    gating = model.gating_indices() if scheme == "rush_larsen" else None
    tt = t
    if gating:
        gidx = list(gating)

        def gate_half(y, tt, hh):
            a, b = model.gating_rates(tt, y, p)
            tau_inv = a + b
            y_inf = a / tau_inv
            y = y.clone()
            y[gidx] = y_inf + (y[gidx] - y_inf) * torch.exp(-hh * tau_inv)
            return y

        def frozen(k):
            k = k.clone()
            k[gidx] = 0.0
            return k

        for _ in range(n_sub):
            y = gate_half(y, tt, 0.5 * h)
            k1 = frozen(model.rhs(tt, y, p))
            k2 = frozen(model.rhs(tt + 0.5 * h, y + 0.5 * h * k1, p))
            y = y + h * k2
            y = gate_half(y, tt + 0.5 * h, 0.5 * h)
            tt = tt + h
    else:
        for _ in range(n_sub):
            k1 = model.rhs(tt, y, p)
            k2 = model.rhs(tt + 0.5 * h, y + 0.5 * h * k1, p)
            k3 = model.rhs(tt + 0.5 * h, y + 0.5 * h * k2, p)
            k4 = model.rhs(tt + h, y + h * k3, p)
            y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            tt = tt + h
    cur = model.currents(t + dt, y, p)
    params = p.clone()
    for name, vals in cur.items():
        params[model.PARAMS[name]] = vals
    return dataclasses.replace(mm, states=y, params=params)


def _kernel_cuda(mm: MembraneState, t, dt: float, n_sub: int,
                 rush_larsen: bool) -> MembraneState:
    """Launch the RK4 or the Rush-Larsen kernel for the model's points."""
    model = mm.model
    mid = getattr(model, "cuda_model_id", 0)
    names = tuple(model.PARAMS)
    if mid == 0 or names != CUDA_PARAMS[:len(names)]:
        raise NotImplementedError(
            f"{model.name}: no CUDA right-hand side for this membrane model")
    y, p = mm.states, mm.params
    ns, n = y.shape
    _cuda.check("states", y)
    _cuda.check("params", p, y.dtype, (len(names), n))
    y_out = torch.empty_like(y)
    p_out = torch.empty_like(p)
    # the step time as the state's dtype holds it (float of a 0-d tensor)
    t_val = float(_as_time(t, y))
    stim = int(bool(getattr(model, "stimulus", False)))
    kernel = "membrane_rl" if rush_larsen else "membrane_rk4"
    _cuda.launch(kernel, "knp_" + kernel, y.dtype, y.data_ptr(), p.data_ptr(),
                 y_out.data_ptr(), p_out.data_ptr(), mid, stim, ns, len(names), n, t_val,
                 float(dt), int(n_sub))
    return dataclasses.replace(mm, states=y_out, params=p_out)


def ode_step(mm: MembraneState, t, dt: float, n_sub: int,
             scheme: str = "rk4") -> MembraneState:
    """One PDE step of the membrane ODEs: kernel C on CUDA tensors, the
    plain version on CPU tensors.  As in the plain version, a model without
    gating states runs RK4 under ``"rush_larsen"``."""
    if not mm.states.is_cuda:
        return ode_step_plain(mm, t, dt, n_sub, scheme=scheme)
    gating = mm.model.gating_indices() if scheme == "rush_larsen" else ()
    if gating and gating != (0, 1, 2):
        raise NotImplementedError(
            f"{mm.model.name}: the Rush-Larsen kernel gates states 0-2 (m, h, n)")
    return _kernel_cuda(mm, t, dt, n_sub, rush_larsen=bool(gating))
