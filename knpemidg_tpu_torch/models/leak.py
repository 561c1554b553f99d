"""Passive leak membrane model (torch port of knpemidg_tpu/models/leak.py).

Single-state (V) model: Na/K leak conductances, the saturating Na/K pump
and the SI Hodgkin-Huxley model's periodic decaying stimulus, here without
its t < 0.125 s cut-off; SI units.  The stimulus term is always present
(scaled by the stim_amplitude parameter)."""
from __future__ import annotations

import torch

from .base import ODEModel, sodium_potassium_pump_saturating


class LeakSI(ODEModel):
    STATE_NAMES = ("V",)
    STATE_INIT = (-0.07438609374462003,)     # volts
    PARAM_DEFAULTS = {
        "g_leak_Na": 1.0,       # S/m^2
        "g_leak_K": 4.0,
        "E_Na": 0.0,
        "E_K": 0.0,
        "E_Cl": 0.0,
        "Cm": 0.0,
        "stim_amplitude": 0.0,
        "I_ch_Na": 0.0,
        "I_ch_K": 0.0,
        "I_ch_Cl": 0.0,
        "K_e": 0.0,
        "Na_i": 0.0,
        "m_K": 2.0,
        "m_Na": 7.7,
        "I_max": 0.449,
    }
    cuda_model_id = 4

    def _currents(self, t, y, p_):
        p = lambda n: self.p(p_, n)
        V = y[0]
        i_stim = p("stim_amplitude") * torch.exp(-torch.remainder(t, 0.03) / 0.002)
        i_pump = sodium_potassium_pump_saturating(
            p("I_max"), p("m_K"), p("K_e"), p("m_Na"), p("Na_i")
        )
        i_Na = (p("g_leak_Na") + i_stim) * (V - p("E_Na")) + 3 * i_pump
        i_K = p("g_leak_K") * (V - p("E_K")) - 2 * i_pump
        return i_Na, i_K

    def rhs(self, t, y, p_):
        i_Na, i_K = self._currents(t, y, p_)
        return torch.stack([(-i_K - i_Na) / self.p(p_, "Cm")])

    def currents(self, t, y, p_):
        i_Na, i_K = self._currents(t, y, p_)
        return {"I_ch_Na": i_Na, "I_ch_K": i_K, "I_ch_Cl": torch.zeros_like(i_Na)}
