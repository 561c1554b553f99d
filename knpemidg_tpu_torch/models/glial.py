"""Glial membrane models with inward-rectifying (Kir) potassium channels
(torch port of knpemidg_tpu/models/glial.py).

* :class:`GlialKir`      -- passive Na leak, the Kir conductance and the
  saturating Na/K pump (emix-simulations).
* :class:`GlialKirAstro` -- adds a Cl leak channel and switches to the
  Michaelis-Menten-type pump (local-astrocyte-depolarization).
"""
from __future__ import annotations

import math

import torch

from .base import (
    ODEModel,
    sodium_potassium_pump_michaelis,
    sodium_potassium_pump_saturating,
)


def _kir_conductance(V, E_K, K_e, K_e_init, E_K_init, dphi):
    """Kir gating factor; potentials in mV.  ``E_K_init`` and ``K_e_init``
    may be Python floats (the calibration systems' constants)."""
    exp = torch.exp if isinstance(E_K_init, torch.Tensor) else math.exp
    A = 1 + math.exp(18.4 / 42.4)
    B = 1 + exp(-(0.1186e3 + E_K_init) / 0.0441e3)
    C = 1 + torch.exp((dphi + 0.0185e3) / 0.0425e3)
    D = 1 + torch.exp(-(0.1186e3 + V) / 0.0441e3)
    return torch.sqrt(K_e / K_e_init) * (A * B) / (C * D)


class GlialKir(ODEModel):
    STATE_NAMES = ("V",)
    STATE_INIT = (-83.08511451850003,)      # mV
    PARAM_DEFAULTS = {
        "g_Na_bar": 0.0,
        "g_K_bar": 0.0,
        "g_leak_Na": 0.1,       # mS/cm^2
        "g_leak_K": 1.7,
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
        "I_max": 50.0,          # muA/cm^2
        "K_e_init": 3.32597273958481,
        "K_i_init": 102.74050220804774,
    }
    cuda_model_id = 2
    # physical constants (emix m-units: mK, mJ, mC)
    TEMPERATURE = 300e3
    R = 8.314e3
    F = 96485e3

    def _currents(self, t, y, p_):
        p = lambda n: self.p(p_, n)
        V = y[0]
        i_pump = sodium_potassium_pump_saturating(
            p("I_max"), p("m_K"), p("K_e"), p("m_Na"), p("Na_i")
        )
        E_K_init = (
            self.R * self.TEMPERATURE / self.F
            * torch.log(p("K_e_init") / p("K_i_init"))
        )
        dphi = V - p("E_K")
        g_Kir = _kir_conductance(V, p("E_K"), p("K_e"), p("K_e_init"), E_K_init, dphi)
        i_Kir = p("g_leak_K") * g_Kir * (V - p("E_K"))
        i_Na = p("g_leak_Na") * (V - p("E_Na")) + 3 * i_pump
        i_K = i_Kir - 2 * i_pump
        return i_Na, i_K, torch.zeros_like(i_Na)

    def rhs(self, t, y, p_):
        i_Na, i_K, i_Cl = self._currents(t, y, p_)
        return torch.stack([(-i_K - i_Na - i_Cl) / self.p(p_, "Cm")])

    def currents(self, t, y, p_):
        i_Na, i_K, i_Cl = self._currents(t, y, p_)
        return {"I_ch_Na": i_Na, "I_ch_K": i_K, "I_ch_Cl": i_Cl}


class GlialKirAstro(GlialKir):
    STATE_INIT = (-85.85765274084892,)
    PARAM_DEFAULTS = dict(
        GlialKir.PARAM_DEFAULTS,
        g_leak_K=1.696,
        g_leak_Cl=0.05,
        m_K=1.5,
        m_Na=10.0,
        I_max=10.75975,
        K_e_init=3.092970607490389,
        K_i_init=99.3100014897692,
    )
    cuda_model_id = 5
    # astrocyte variant constants
    TEMPERATURE = 307e3
    R = 8.315e3
    F = 96500e3

    def _currents(self, t, y, p_):
        p = lambda n: self.p(p_, n)
        V = y[0]
        i_pump = sodium_potassium_pump_michaelis(
            p("I_max"), p("m_K"), p("K_e"), p("m_Na"), p("Na_i")
        )
        E_K_init = (
            self.R * self.TEMPERATURE / self.F
            * torch.log(p("K_e_init") / p("K_i_init"))
        )
        dphi = V - p("E_K")
        g_Kir = _kir_conductance(V, p("E_K"), p("K_e"), p("K_e_init"), E_K_init, dphi)
        i_Kir = p("g_leak_K") * g_Kir * (V - p("E_K"))
        i_Na = p("g_leak_Na") * (V - p("E_Na")) + 3 * i_pump
        i_K = i_Kir - 2 * i_pump
        i_Cl = p("g_leak_Cl") * (V - p("E_Cl"))
        return i_Na, i_K, i_Cl
