"""knpemidg_tpu_torch -- the KNP-EMI DG splitting solver in PyTorch, with
hand-written CUDA kernels for Hopper (port of knpemidg_tpu).

The package imports torch, numpy and scipy only.  Its CUDA kernels
(``csrc/``) are compiled with nvcc at first use on a CUDA tensor."""

import torch as _torch

# the coarse GEMVs and the GMRES orthogonalisation need true f32 (TF32
# roughly doubles Krylov counts); mirrors knpemidg_tpu's "highest" matmuls
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import Ion, PhysicalParams, SolverParams, StimParams, ion_from_dict
from .solver import (Solver, StandardSolver, Traces, state_from_numpy,
                     state_to_numpy)
from .solver_emi import SolverEMI, StandardSolverEMI
from .membrane.engine import (MembraneState, get_param, make_membrane,
                              ode_step, set_param)
from .mesh.core import Mesh, build_mesh, morton_order

__all__ = [
    "Ion", "PhysicalParams", "SolverParams", "StimParams", "ion_from_dict",
    "Solver", "StandardSolver", "SolverEMI", "StandardSolverEMI", "Traces",
    "state_from_numpy", "state_to_numpy",
    "MembraneState", "make_membrane", "ode_step", "set_param", "get_param",
    "Mesh", "build_mesh", "morton_order",
]

__version__ = "0.1.0"
