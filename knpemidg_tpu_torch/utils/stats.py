"""Solver statistics / instrumentation.

Mirrors the reference's per-step protocol (solver.py:1146-1211): wall-clock
spans per phase accumulated in timers, per-step solve times and Krylov
iteration counts written to ``{emi,knp}_{solve,assem,niter}_<res>.txt``
files with num-cells/dofs headers, and ANSI-colored console output
(solver.py:19-28)."""
from __future__ import annotations

import os

import numpy as np


class bcolors:
    HEADER = "\033[95m"
    OKBLUE = "\033[94m"
    OKCYAN = "\033[96m"
    OKGREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    ENDC = "\033[0m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"


class SolverStats:
    def __init__(self):
        self.ode_solve_timer = 0.0
        self.emi_solve_timer = 0.0
        self.knp_solve_timer = 0.0
        self.emi_ass_timer = 0.0
        self.knp_ass_timer = 0.0
        self.pde_step_timer = 0.0
        self.emi_niters = []
        self.knp_niters = []
        self.step_walls = []
        self.phase_records = []
        self._files = {}

    def record_step(self, step_stats, wall):
        """`step_stats` may carry a 'phases' dict of host wall times
        ({emi,knp}_{assem,solve}); only then are the per-phase stats files
        written -- a fused step has no honest phase split, and duplicating
        the step wall into both solve files (round-1 behavior) misrepresents
        them (ADVICE r1)."""
        self.pde_step_timer += wall
        self.step_walls.append(wall)
        self.emi_niters.append(int(step_stats["emi_iters"]))
        self.knp_niters.append(np.asarray(step_stats["knp_iters"]).tolist())
        phases = step_stats.get("phases") or {}
        self.emi_solve_timer += phases.get("emi_solve", 0.0)
        self.knp_solve_timer += phases.get("knp_solve", 0.0)
        self.emi_ass_timer += phases.get("emi_assem", 0.0)
        self.knp_ass_timer += phases.get("knp_assem", 0.0)
        self.phase_records.append(dict(phases))
        lines = [
            ("emi_niter", f"niter: {self.emi_niters[-1]} \n"),
            ("knp_niter", f"niter: {int(np.sum(self.knp_niters[-1]))} \n"),
        ]
        for name in ("emi_solve", "knp_solve"):
            if name in phases:
                lines.append((name, f"solve_time: {phases[name]:.4f} \n"))
        for name in ("emi_assem", "knp_assem"):
            if name in phases:
                lines.append((name, f"assembly_time: {phases[name]:.4f} \n"))
        for f, line in lines:
            if f in self._files:
                self._files[f].write(line)

    def open_files(self, path, mesh, dofs_knp, dofs_emi, solver_params):
        os.makedirs(path, exist_ok=True)
        reso = getattr(solver_params, "resolution", 0) or 0
        suffix_emi = "dir_" if solver_params.direct_emi else ""
        suffix_knp = "dir_" if solver_params.direct_knp else ""
        names = {
            "emi_solve": f"emi_solve_{suffix_emi}{reso}.txt",
            "emi_assem": f"emi_assem_{suffix_emi}{reso}.txt",
            "knp_solve": f"knp_solve_{suffix_knp}{reso}.txt",
            "knp_assem": f"knp_assem_{suffix_knp}{reso}.txt",
        }
        if not solver_params.direct_emi:
            names["emi_niter"] = f"emi_niter_{reso}.txt"
        if not solver_params.direct_knp:
            names["knp_niter"] = f"knp_niter_{reso}.txt"
        for key, fn in names.items():
            f = open(os.path.join(path, fn), "w")
            f.write(f"num cells: {mesh.num_cells} \n")
            f.write(f"dofs: {dofs_emi if key.startswith('emi') else dofs_knp} \n")
            self._files[key] = f

    def close_files(self):
        for f in self._files.values():
            f.close()
        self._files = {}

    def summary(self):
        return {
            "ode_solve_timer": self.ode_solve_timer,
            "pde_step_timer": self.pde_step_timer,
            "emi_solve_timer": self.emi_solve_timer,
            "knp_solve_timer": self.knp_solve_timer,
            "emi_ass_timer": self.emi_ass_timer,
            "knp_ass_timer": self.knp_ass_timer,
            "mean_step_wall": float(np.mean(self.step_walls)) if self.step_walls else 0.0,
            "emi_niters": self.emi_niters,
            "knp_niters": self.knp_niters,
        }
