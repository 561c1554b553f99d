"""The rat neuron's action potential in float64 on the CPU, through the
JAX package's examples/run_rat_neuron.py and through the port's
apps.run_rat_neuron, with the protocol chip_smoke.py's apps phase runs on
the card (tests/test_apps.py test_rat_neuron_ap_propagation's: 19 steps,
max_it_emi 1500, phi_M read at the membrane facet nearest each probe).

The EMI solves stop at rtol 1e-5 after hundreds of iterations on the
action potential's steps, so the two packages' Krylov counts part from
step 9 on and the crossing times agree to a fraction of a step, not to
round-off.  Nightly: the two runs take about 8 minutes."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parity  # noqa: F401  (puts examples/ on sys.path)

import chip_smoke
from knpemidg_tpu_torch.apps import run_rat_neuron
from knpemidg_tpu_torch.ops import assembly

N_STEPS = 19
CROSSING_TOL = 0.01           # of a step
VELOCITY_RTOL = 0.03


def _jax_crossings(tmp_path):
    """0-mV crossing times (s) at the probes and the trunk velocity (m/s)
    of the JAX package's run, read from its H5 output."""
    from run_rat_neuron import build_solver
    from knpemidg_tpu.config import SolverParams
    from knpemidg_tpu.postprocess import Results

    S = build_solver(resolution=0, dtype=jnp.float64)
    sp = SolverParams(direct_emi=False, direct_knp=False, rtol_emi=1e-5, atol_emi=1e-40,
                      rtol_knp=1e-7, atol_knp=1e-40, max_it_emi=1500)
    fname = os.path.join(str(tmp_path), "")
    S.solve_system_active(N_STEPS * S.params.dt, 0.0, sp, filename=fname, save_fields=True)
    res = Results(fname + "results.h5")
    t = {k: chip_smoke.crossing(res.membrane_series(p)["phi_M"], res.times)
         for k, p in chip_smoke.RAT_PROBES.items()}
    v = res.ap_velocity(chip_smoke.RAT_PROBES["t50"], chip_smoke.RAT_PROBES["t88"],
                        threshold=0.0, tags=[2])
    return t, v, S.params.dt


def _port_crossings():
    """The same of the port's run, phi_M read after each step."""
    S = run_rat_neuron.build_solver(0, dtype=torch.float64, device="cpu")
    idx = {k: chip_smoke.nearest_membrane_point(S, p) for k, p in chip_smoke.RAT_PROBES.items()}
    idx["v50"] = chip_smoke.nearest_membrane_point(S, chip_smoke.RAT_PROBES["t50"], tags=[2])
    idx["v88"] = chip_smoke.nearest_membrane_point(S, chip_smoke.RAT_PROBES["t88"], tags=[2])
    sel = torch.as_tensor(list(idx.values()))
    frames = [assembly.jump_phi_M_m(S.g, S.mem_dev, S.phi_init)[sel]]
    S.solve_system_active(N_STEPS * S.params.dt, 0.0, chip_smoke.app_sp(max_it_emi=1500),
                          on_step=lambda k, st: frames.append(st["phi_M"][sel].clone()))
    series = torch.stack(frames).numpy()
    times = S.params.dt * np.arange(len(frames))
    t = {k: chip_smoke.crossing(series[:, j], times) for j, k in enumerate(idx)}
    dist = np.linalg.norm(np.subtract(chip_smoke.RAT_PROBES["t88"], chip_smoke.RAT_PROBES["t50"]))
    return t, dist / abs(t["v88"] - t["v50"])


@pytest.mark.slow
@pytest.mark.nightly
def test_rat_neuron_ap_crossings_match_jax(tmp_path):
    """Every probe crosses 0 mV in both runs, each crossing within 0.01 dt
    of the JAX package's, the trunk velocities within 3% (the two runs
    agree to 0.002 dt and 0.75%)."""
    tj, vj, dt = _jax_crossings(tmp_path)
    tt, vt = _port_crossings()
    print("JAX crossings (ms)", {k: 1e3 * v for k, v in tj.items()}, "velocity", vj)
    print("port crossings (ms)", {k: 1e3 * v for k, v in tt.items()}, "velocity", vt)
    for k in chip_smoke.RAT_PROBES:
        assert tj[k] is not None and tt[k] is not None, k
        assert abs(tt[k] - tj[k]) < CROSSING_TOL * dt, (k, tt[k], tj[k])
    assert abs(vt / vj - 1) < VELOCITY_RTOL, (vt, vj)
