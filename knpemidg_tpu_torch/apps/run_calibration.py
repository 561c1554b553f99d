"""Calibration pipeline (the port of examples/run_calibration.py): integrate
the coupled neuron/glia/bath ODE system to steady state and print the
initial conditions for the PDE runs.

The 100,000 steps of 0.1 ms at one point are one ode_run: one kernel launch
on the card, the state in registers for every step.

    python -m knpemidg_tpu_torch.apps.run_calibration [emix|astro]
"""
import sys

import numpy as np
import torch

from ..membrane.engine import make_membrane, ode_run
from ..models.calibration import CalibrationAstro, CalibrationEMIx


def calibrate(model=None, n_steps=100_000, dt=0.1, n_sub=2, device="cuda",
              dtype=torch.float64):
    """The model's states after ``n_steps`` steps of ``dt`` from its
    STATE_INIT, by name."""
    model = model or CalibrationEMIx()
    mm = make_membrane(model, np.zeros((1, 2)), dtype=dtype, device=device)
    mm = ode_run(mm, 0.0, dt, n_steps, n_sub=n_sub)
    y = mm.states[:, 0].cpu().numpy()
    return {name: float(y[i]) for name, i in model.STATES.items()}


def main(variant="emix", device="cuda"):
    model = CalibrationEMIx() if variant == "emix" else CalibrationAstro()
    steady = calibrate(model, device=device)
    print(f"# steady state after 10 s ({variant}):")
    for name, val in steady.items():
        print(f"{name}_init = {val!r}")
    return steady


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "emix")
