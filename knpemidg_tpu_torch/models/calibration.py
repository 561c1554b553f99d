"""Calibration ODE systems: coupled neuron + glia + shared bath (torch port
of knpemidg_tpu/models/calibration.py).

These extended ODE systems track membrane potentials AND ECS/ICS
concentrations in a closed three-compartment volume; integrated to steady
state at one point (membrane/engine.ode_run) they give the initial
conditions of the PDE runs (apps/run_calibration.py).

States (emix): m, h, n, V_n, V_g, K_e, K_n, K_g, Na_e, Na_n, Na_g
Astro adds:    Cl_e, Cl_n, Cl_g
"""
from __future__ import annotations

import math

import torch

from .base import (
    ODEModel,
    hh_gating_rates_mV,
    sodium_potassium_pump_michaelis,
    sodium_potassium_pump_saturating,
)
from .glial import _kir_conductance


class CalibrationEMIx(ODEModel):
    """The emix-simulations calibration system (11 states)."""

    STATE_NAMES = ("m", "h", "n", "V_n", "V_g",
                   "K_e", "K_n", "K_g", "Na_e", "Na_n", "Na_g")
    STATE_INIT = (0.01, 0.85, 0.18, -74.38, -83.08,
                  3.32, 124.15, 102.75, 100.71, 12.83, 12.39)
    PARAM_DEFAULTS = {
        "g_Na_bar": 120.0, "g_K_bar": 36.0,
        "g_leak_Na_n": 0.1, "g_leak_K_n": 0.4,
        "g_leak_Na_g": 0.1, "g_leak_K_g": 1.7,
        "Cm": 2.0, "stim_amplitude": 0.0,
        "m_K": 2.0, "m_Na": 7.7, "I_max_n": 44.9, "I_max_g": 50.0,
    }
    cuda_model_id = 6
    # compartment volumes / surface
    TEMPERATURE, R, F = 300e3, 8.314e3, 96485e3
    ICS_VOL, ECS_VOL, SURFACE = 3.42e-11 / 2.0, 7.08e-11, 2.29e-6
    K_E_INIT, K_G_INIT = 3.32597273958481, 102.74050220804774

    def _neuron_pump(self, p, K_e, Na_n):
        return sodium_potassium_pump_saturating(
            p("I_max_n"), p("m_K"), K_e, p("m_Na"), Na_n)

    def _glial_pump(self, p, K_e, Na_g):
        return sodium_potassium_pump_saturating(
            p("I_max_g"), p("m_K"), K_e, p("m_Na"), Na_g)

    def rhs(self, t, y, p_):
        p = lambda n: self.p(p_, n)
        m, h, n, V_n, V_g = y[0], y[1], y[2], y[3], y[4]
        K_e, K_n, K_g, Na_e, Na_n, Na_g = y[5], y[6], y[7], y[8], y[9], y[10]
        RTF = self.R * self.TEMPERATURE / self.F
        E_Na_n = RTF * torch.log(Na_e / Na_n)
        E_K_n = RTF * torch.log(K_e / K_n)
        E_Na_g = RTF * torch.log(Na_e / Na_g)
        E_K_g = RTF * torch.log(K_e / K_g)
        E_K_init = RTF * math.log(self.K_E_INIT / self.K_G_INIT)

        am, bm, ah, bh, an, bn = hh_gating_rates_mV(V_n)
        i_stim = p("stim_amplitude") * torch.exp(-torch.remainder(t, 20.0) / 2.0)
        i_pump_n = self._neuron_pump(p, K_e, Na_n)
        i_pump_g = self._glial_pump(p, K_e, Na_g)
        g_Kir = _kir_conductance(V_g, E_K_g, K_e, self.K_E_INIT, E_K_init,
                                 V_g - E_K_g)
        i_Kir = p("g_leak_K_g") * g_Kir * (V_g - E_K_g)
        i_Na_n = (p("g_leak_Na_n") + p("g_Na_bar") * h * m**3 + i_stim) * (
            V_n - E_Na_n) + 3 * i_pump_n
        i_K_n = (p("g_leak_K_n") + p("g_K_bar") * n**4) * (V_n - E_K_n) - 2 * i_pump_n
        i_Na_g = p("g_leak_Na_g") * (V_g - E_Na_g) + 3 * i_pump_g
        i_K_g = i_Kir - 2 * i_pump_g

        sE = self.SURFACE / (self.F * self.ECS_VOL)
        sI = self.SURFACE / (self.F * self.ICS_VOL)
        Cm = p("Cm")
        return torch.stack([
            (1 - m) * am - m * bm,
            (1 - h) * ah - h * bh,
            (1 - n) * an - n * bn,
            (-i_K_n - i_Na_n) / Cm,
            (-i_K_g - i_Na_g) / Cm,
            (i_K_n + i_K_g) * sE,
            -i_K_n * sI,
            -i_K_g * sI,
            (i_Na_n + i_Na_g) * sE,
            -i_Na_n * sI,
            -i_Na_g * sI,
        ])

    def currents(self, t, y, p_):
        return {}


class CalibrationAstro(CalibrationEMIx):
    """The local-astrocyte-depolarization calibration system (14 states: Cl,
    the Michaelis pump on glia, the astro physical constants)."""

    STATE_NAMES = CalibrationEMIx.STATE_NAMES + ("Cl_e", "Cl_n", "Cl_g")
    STATE_INIT = (
        0.01365600905697864, 0.8804834256821714, 0.17041625484928405,
        -75.93151471235473, -85.85765274084892,
        3.092970607490389, 124.13988964240784, 99.3100014897692,
        144.60625137617149, 12.850454639128186, 15.775818906083778,
        133.62525154406637, 5.0, 5.203660274163705,
    )
    PARAM_DEFAULTS = dict(
        CalibrationEMIx.PARAM_DEFAULTS,
        g_leak_K_g=1.696, g_leak_Cl_g=0.05,
        m_K=1.5, m_Na=10.0, I_max_n=58.0, I_max_g=10.75975, Cm=1.0,
    )
    cuda_model_id = 7
    TEMPERATURE, R, F = 307e3, 8.315e3, 96500e3
    K_E_INIT, K_G_INIT = 3.092970607490389, 99.3100014897692

    def _glial_pump(self, p, K_e, Na_g):
        return sodium_potassium_pump_michaelis(
            p("I_max_g"), p("m_K"), K_e, p("m_Na"), Na_g)

    def rhs(self, t, y, p_):
        p = lambda n: self.p(p_, n)
        base = super().rhs(t, y, p_)
        V_g = y[4]
        Cl_e, Cl_n, Cl_g = y[11], y[12], y[13]
        RTF = self.R * self.TEMPERATURE / self.F
        E_Cl_g = -RTF * torch.log(Cl_e / Cl_g)
        i_Cl_g = p("g_leak_Cl_g") * (V_g - E_Cl_g)
        i_Cl_n = 0.0
        sE = self.SURFACE / (self.F * self.ECS_VOL)
        sI = self.SURFACE / (self.F * self.ICS_VOL)
        dV_g = base[4] - i_Cl_g / p("Cm")
        return torch.cat([
            base[:4],
            dV_g[None],
            base[5:11],
            torch.stack([
                (-i_Cl_n - i_Cl_g) * sE,
                torch.full_like(i_Cl_g, i_Cl_n * sI),
                i_Cl_g * sI,
            ]),
        ])
