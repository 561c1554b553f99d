"""Hodgkin-Huxley membrane models (torch port of knpemidg_tpu/models/hh.py).

* :class:`HodgkinHuxleySI` -- SI units (V, s, S/m^2, A/m^2), stimulus
  ``stim_amplitude * exp(-mod(t, 0.03)/0.002) * (t < 0.125)``.
* :class:`HodgkinHuxleyMV` -- mV/ms/cgs units (emix-simulations), stimulus
  ``stim_amplitude * exp(-mod(t, 20)/2)``.
* :class:`HodgkinHuxleyAstro` -- the mV/ms model without a stimulus term
  and with a rebalanced pump (local-astrocyte-depolarization); its device
  function is HH-MV's.
"""
from __future__ import annotations

import torch

from .base import (
    ODEModel,
    hh_gating_rates_SI,
    hh_gating_rates_mV,
    sodium_potassium_pump_saturating,
)


class _HodgkinHuxley(ODEModel):
    STATE_NAMES = ("m", "h", "n", "V")
    GATING_STATES = ("m", "h", "n")
    _STIM_PERIOD = 20.0
    _STIM_DECAY = 2.0
    _STIM_END = None

    def __init__(self, stimulus: bool = True, **overrides):
        super().__init__(**overrides)
        self.stimulus = stimulus
        if not stimulus:
            self.name += "_no_stim"

    @staticmethod
    def _rates(V):                                    # pragma: no cover
        raise NotImplementedError

    def _currents(self, t, y, p_):
        p = lambda n: self.p(p_, n)
        m, h, n, V = y[0], y[1], y[2], y[3]
        i_stim = 0.0
        if self.stimulus:
            i_stim = p("stim_amplitude") * torch.exp(
                -torch.remainder(t, self._STIM_PERIOD) / self._STIM_DECAY)
            if self._STIM_END is not None:
                i_stim = i_stim * (t < self._STIM_END)
        i_pump = sodium_potassium_pump_saturating(
            p("I_max"), p("m_K"), p("K_e"), p("m_Na"), p("Na_i")
        )
        i_Na = (p("g_leak_Na") + p("g_Na_bar") * h * m**3 + i_stim) * (
            V - p("E_Na")
        ) + 3 * i_pump
        i_K = (p("g_leak_K") + p("g_K_bar") * n**4) * (V - p("E_K")) - 2 * i_pump
        return i_Na, i_K

    def rhs(self, t, y, p_):
        m, h, n, V = y[0], y[1], y[2], y[3]
        am, bm, ah, bh, an, bn = self._rates(V)
        i_Na, i_K = self._currents(t, y, p_)
        Cm = self.p(p_, "Cm")
        return torch.stack(
            [
                (1 - m) * am - m * bm,
                (1 - h) * ah - h * bh,
                (1 - n) * an - n * bn,
                (-i_K - i_Na) / Cm,
            ]
        )

    def gating_rates(self, t, y, p_):
        am, bm, ah, bh, an, bn = self._rates(y[3])
        return torch.stack([am, ah, an]), torch.stack([bm, bh, bn])

    def currents(self, t, y, p_):
        i_Na, i_K = self._currents(t, y, p_)
        return {"I_ch_Na": i_Na, "I_ch_K": i_K, "I_ch_Cl": torch.zeros_like(i_Na)}


class HodgkinHuxleySI(_HodgkinHuxley):
    STATE_INIT = (
        0.016648440745822956,   # m
        0.8542015627820805,     # h
        0.1882020248041632,     # n
        -0.07438609374462003,   # V (volts)
    )
    PARAM_DEFAULTS = {
        "g_Na_bar": 1200.0,     # S/m^2
        "g_K_bar": 360.0,
        "g_leak_Na": 1.0,
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
        "m_K": 2.0,             # mol/m^3
        "m_Na": 7.7,
        "I_max": 0.449,         # A/m^2
    }
    cuda_model_id = 3
    _STIM_PERIOD = 0.03
    _STIM_DECAY = 0.002
    _STIM_END = 125e-3
    _rates = staticmethod(hh_gating_rates_SI)


class HodgkinHuxleyMV(_HodgkinHuxley):
    STATE_INIT = (
        0.016651023270342777,
        0.8541791472445746,
        0.18821645700362638,
        -74.3848784437955,      # mV
    )
    PARAM_DEFAULTS = {
        "g_Na_bar": 120.0,      # mS/cm^2
        "g_K_bar": 36.0,
        "g_leak_Na": 0.1,
        "g_leak_K": 0.4,
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
        "I_max": 44.9,          # muA/cm^2
    }
    cuda_model_id = 1
    _rates = staticmethod(hh_gating_rates_mV)


class HodgkinHuxleyAstro(HodgkinHuxleyMV):
    """Astrocyte-depolarization HH neuron: no stimulus term, pump m_K = 1.5,
    m_Na = 10, I_max = 58 (HH-MV's parameter names with other values)."""

    STATE_INIT = (
        0.01365600905697864,
        0.8804834256821714,
        0.17041625484928405,
        -75.93151471235473,
    )
    PARAM_DEFAULTS = dict(
        HodgkinHuxleyMV.PARAM_DEFAULTS, m_K=1.5, m_Na=10.0, I_max=58.0
    )

    def __init__(self, **overrides):
        super().__init__(stimulus=False, **overrides)
