"""Coupled KNP-EMI splitting solver (torch port of knpemidg_tpu/solver.py,
main path: degree 1, iterative solvers, one device; the cell layout or the
interleaved pair layout of enable_pair_layout).

Per time step (the splitting scheme):
  step 0 (ODE):  advance the membrane ODEs (kernel C on the card),
  step I (EMI):  DG solve for phi by increment-form PCG with a linear
                 predictor and the two-level + deflation preconditioner,
  step II (KNP): DG solves for all solved ions at once by batched GMRES
                 (or batched BiCGStab, ``knp_solver="bicgstab"``),
then phi_M = JUMP(phi) and the eliminated ion are updated.  A Picard step
(solve_for_time_step_picard) repeats steps I + II at a fixed time level
until the concentrations stop changing.

The MMS verification path (``mms``, solve_system_passive, cell layout) and
the direct solves take the eager step of the JAX package: EMI by a host
direct solve or PCG, then one KNP solve per ion (host direct, or GMRES).

PyTorch runs eagerly, so there is no jit layer: the Krylov loops are
Python loops and every function below works on device tensors directly.
The solver runs on the CUDA card unless the caller names another device.
``save_solver_stats`` writes the reference's per-phase stats files
(utils/stats.py) and times each phase with a device synchronise; H5 field
output and the other options the port does not carry yet raise
NotImplementedError.
"""
from __future__ import annotations

import time as _time
from typing import Any, Dict

import numpy as np
import torch

from .config import Ion, SolverParams, StimParams, ion_from_dict
from .mesh.core import Mesh
from .fem.tabulation import build_geometry, build_membrane_tables
from .ops import assembly
from .ops.pairs import (build_pair_maps, cell_bell_to_pair, emit_buffers, from_pair,
                        from_pair_host, interleave_pair_maps,
                        pair_maps_to_device, pair_matvec, pair_matvec_fan,
                        pair_matvec_multi, pair_nbr, pair_v_sums, to_pair,
                        to_pair_host)
from .ops.spmv import (bell_matvec, bell_matvec_fan, bell_matvec_multi,
                       block_jacobi_apply, block_jacobi_inverse, block_jacobi_operands)
from .solvers.direct import solve_direct
from .solvers.krylov import bicgstab_batched, gmres, gmres_batched, pcg
from .solvers.twolevel import (_np, build_moment_deflation, build_two_level,
                               compartment_ids, make_two_level, moment_galerkin_host,
                               moment_vectors, ritz_galerkin_host, ritz_lanczos_W,
                               ritz_lanczos_W_host, two_level_apply_batched,
                               two_level_apply_fn)
from .membrane import engine
from .membrane.engine import MembraneState, make_membrane, set_param, get_param
from .utils.stats import SolverStats, bcolors


def _check_supported(sp: SolverParams):
    """Raise for every solver option the port does not carry yet."""
    unsupported = []
    if sp.emi_moment_blocked:
        unsupported.append("emi_moment_blocked (the compartment-blocked moment rows, "
                           "ROADMAP.md queue 1, item 6)")
    if sp.knp_ritz:
        unsupported.append("knp_ritz")
    if sp.knp_solver not in ("gmres", "bicgstab"):
        unsupported.append(f"knp_solver={sp.knp_solver!r}")
    if sp.gmres_orth != "cgs2" or sp.gmres_rot != "replay":
        unsupported.append("gmres_orth/gmres_rot other than cgs2/replay")
    for kind in (sp.precond, sp.precond_knp):
        if kind not in ("", "two_level", "jacobi"):
            unsupported.append(f"precond {kind!r}")
    if sp.coarse_ridge < 1e-5:
        unsupported.append("coarse_ridge < 1e-5 (NaN-fallback ladder)")
    if sp.pc_refresh_factor > 0:
        unsupported.append("pc_refresh_factor")
    if sp.pair_bj not in ("halves", "full"):
        unsupported.append(f"pair_bj={sp.pair_bj!r}")
    if unsupported:
        raise NotImplementedError("knpemidg_tpu_torch does not support: "
                                  + ", ".join(unsupported))


def _resolve_device(device) -> torch.device:
    """The solver's device: the CUDA card unless the caller names another.
    Never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "knpemidg_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Traces:
    """Membrane-trace helpers handed to `update_ode`.  Index `k` refers to
    the full ion list; the last ion is the eliminated one.  ``tr`` holds
    the step's facet averages of every ion over all membrane facets
    (assembly.membrane_traces_m: plus, minus, Nernst), ``sl`` this tag's
    (start, stop) membrane slice."""

    def __init__(self, solver, tr, sl):
        self._s = solver
        self._tr = tr
        self._sl = sl

    def plus(self, k):
        """ECS-side facet-average trace of ion k on this tag's membranes."""
        return self._tr[0, k, self._sl[0]:self._sl[1]]

    def minus(self, k):
        """ICS-side facet-average trace of ion k."""
        return self._tr[1, k, self._sl[0]:self._sl[1]]

    def ion_index(self, name):
        return self._s.ion_names.index(name)


class Solver:
    """construct, then setup_domain -> setup_parameters -> setup_FEM_spaces
    -> setup_membrane_model -> solve_system_active; or, for an MMS problem
    (``mms``, knpemidg_tpu_torch.mms.problems), setup_domain ->
    setup_parameters -> setup_FEM_spaces -> solve_system_passive."""

    _emi_only = False         # SolverEMI: no KNP solve, static operator or pc

    def __init__(self, params, ion_list, degree_emi=1, degree_knp=1, mms=None,
                 dtype=None, device="cuda"):
        if degree_emi != 1 or degree_knp != 1:
            raise NotImplementedError("knpemidg_tpu_torch supports DG degree 1 only")
        self.params = params
        self.ion_list = [
            i if isinstance(i, Ion) else ion_from_dict(i) for i in ion_list
        ]
        self.mms = mms
        self.ion_names = [i.name for i in self.ion_list]
        self.N_ions = len(ion_list) - 1      # number of *solved* ions
        self.dtype = dtype or torch.float64
        self.device = _resolve_device(device)
        self.stats = SolverStats()
        self.mem_models: Dict[int, Any] = {}
        self.splitting_scheme = True
        self.pair_layout = False             # see enable_pair_layout
        self.pairs = None
        self._ode_tables = {}                # see _ode_table
        self.save_solver_stats = False       # see _io_setup

    # ------------------------------------------------------------------
    # setup phases
    # ------------------------------------------------------------------
    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    def setup_domain(self, mesh: Mesh, quad_degree=None):
        """Build geometry tables; penalty tau = 20 * gdim * degree.  Cells
        come ordered (compartment, Morton) from build_mesh, so the coarse
        chunks never mix compartments."""
        self._invalidate_caches()
        self._comp_np = compartment_ids(mesh)
        self.mesh = mesh
        qd = max(quad_degree or 4, 2)
        self.geom = build_geometry(mesh, quad_degree_cell=qd,
                                   quad_degree_facet=qd, degree=1)
        self.g = assembly.precompute_static(
            self.geom.to_device(self.dtype, device=self.device))
        self.gdim = mesh.dim
        self.tau = 20.0 * self.gdim
        self.tau_knp = 20.0 * self.gdim
        self.n_cells = mesh.num_cells
        self.nd = self.geom.nd
        ext = mesh.vertices.max(axis=0) - mesh.vertices.min(axis=0)
        self.Lp = float(ext.max())
        if self.mms is not None:
            # the MMS interface walls are the membrane facets
            self._set_membrane_tags(list(self.mms.wall_tags))
        return self

    def enable_pair_layout(self, interleave: bool = True):
        """Switch the Krylov path to the pair-block operator layout
        (ops/pairs.py): 2-cell macro rows whose block-Jacobi smoother sees
        the intra-pair coupling.  Fields and rhs stay cell-indexed; each
        solve converts its vectors once.

        The cell axis is renumbered so that pair p occupies slots (2p,
        2p+1), with inert pad cells (parallel.sharding.pad_cell_axis) as the
        dead second halves of self-pairs: the conversions become relayouts
        and the preconditioner's pair chunks cover the cell layout's
        contiguous (compartment, Morton) chunk ranges.  Fields come back in
        the padded numbering; parallel.sharding.unpad_state maps them to
        the original one.

        Call after setup_membrane_model (the renumbering must see the
        membrane cell maps) and before attach_pc.  ``interleave=False``
        (the index-map form) is not ported."""
        if self.mms is not None:
            raise ValueError("enable_pair_layout: the pair layout is not for MMS verification")
        if any(self._f_source_callable(ion) is not None for ion in self.ion_list):
            raise NotImplementedError("enable_pair_layout: ion source terms on the pair "
                                      "layout are not ported")
        if not interleave:
            raise NotImplementedError(
                "enable_pair_layout(interleave=False): the non-interleaved "
                "(cell_col) pair maps are not ported")
        if not hasattr(self, "c_init"):
            raise RuntimeError("enable_pair_layout: call setup_FEM_spaces first")
        if self.pairs is None:
            pmh = build_pair_maps(self.geom)
            # pair mass from the original numbering (pad cells are dead
            # halves and add none)
            vol = np.asarray(self.geom.vol)
            pair_mass = vol[pmh["cop"][0]] + vol[pmh["cop"][1]] * pmh["live1"]
            pmh, perm = interleave_pair_maps(pmh, self.n_cells)
            self._apply_interleave(perm)
            self.pairs_host = pmh
            self.pairs = pair_maps_to_device(pmh, self.device)
            # (2nd, npair) live mask of the pair vectors: half 0 is always
            # a real cell, half 1 of a self-pair is a pad
            live = np.stack([np.ones_like(pmh["live1"]), pmh["live1"]])
            self._pair_mask = torch.as_tensor(np.repeat(live, self.nd, axis=0),
                                              device=self.device)
            # (2nd, 2nd, 1) mask selecting the two per-cell diagonal
            # sub-blocks (the 'halves' pair_bj variant)
            self._pair_bj_halves = self._tensor(
                np.kron(np.eye(2), np.ones((self.nd, self.nd)))[:, :, None])
            self._pair_mass = self._tensor(pair_mass)
            self.pair_layout = True
            self._invalidate_caches()
        return self

    def _apply_interleave(self, perm: np.ndarray):
        """Renumber every cell-indexed solver array by the interleaved pair
        permutation: pad the cell axis with the inert cells the permutation
        references (ids >= n_cells), permute the pads into the dead half
        slots, and remap the initial fields."""
        from .parallel.sharding import pad_cell_axis, permute_cells

        nc = self.n_cells
        extra = len(perm) - nc
        pad_cell_axis(self, extra)
        # pads carry compartment id -1: no one-hot column and no moment
        # field (a pad in a real compartment would add its zeroed node
        # coordinates to that compartment's moment basis)
        self._comp_np = np.concatenate(
            [self._comp_np, np.full(extra, -1, dtype=self._comp_np.dtype)])
        permute_cells(self, perm)
        self._pad_mask = torch.as_tensor(perm < nc, device=self.device)
        self.n_cells_pad = len(perm)
        # original cell id -> padded slot (unpad_state)
        self._cell_unpad_idx = self._cell_perm_inv[:nc].copy()
        # the initial fields were built at the original size: a pad slot
        # takes its live partner's value if it has one, else cell 0's (pad
        # rows are decoupled and their increments stay zero; a live source
        # keeps the concentrations positive)
        src = perm.copy()
        partner = perm[np.arange(len(perm)) ^ 1]   # the other pair half
        dead = perm >= nc
        src[dead] = np.where(partner[dead] < nc, partner[dead], 0)
        src_t = torch.as_tensor(src, device=self.device)
        for name in ("c_init", "c_elim_init", "phi_init"):
            setattr(self, name, getattr(self, name)[..., src_t].contiguous())

    def _set_membrane_tags(self, tags):
        self.__dict__.pop("_emit_bufs", None)     # the membrane emit's are n_mem wide
        self.tables = build_membrane_tables(self.mesh, tags)
        self.mem_dev = self.tables.to_device(self.dtype, device=self.device)
        # membrane-presliced trace tensors: gathers over n_mem instead of
        # the full facet axis
        fidx = self.mem_dev["fidx"]
        self.mem_dev["Rp"] = self.g["f_Rp"][:, :, fidx]
        self.mem_dev["Rm"] = self.g["f_Rm"][:, :, fidx]
        self.mem_dev["cp"] = self.g["f_cp"][fidx]
        self.mem_dev["cm"] = self.g["f_cm"][fidx]
        # the inverse of fidx over the facet axis (-1 off the membranes):
        # the assembly kernels read membrane data by a gather, never scatter
        mof = self.tables.mem_of_facet
        self.mem_dev["inv"] = torch.as_tensor(
            np.where(mof < self.tables.n_mem, mof, -1).astype(np.int32),
            device=self.device)
        self.masks = {
            "f_sip": torch.as_tensor(self.geom.f_stag == 0, device=self.device),
            "f_mem": torch.as_tensor(self.tables.mem_of_facet < self.tables.n_mem,
                                     device=self.device),
        }
        self.n_mem = self.tables.n_mem

    def _cellwise(self, sub: Dict[int, Any]) -> np.ndarray:
        """Per-subdomain dict -> per-cell P0 array."""
        out = np.zeros(self.n_cells)
        for tag, val in sub.items():
            out[self.mesh.cell_tags == tag] = float(val)
        return out

    def _invalidate_caches(self):
        """Drop the cached static operators and compartment arrays bound to
        the previous mesh, physics or cell numbering."""
        for attr in ("_knp_static_blocks", "_comp_onehot", "_comp_ids", "_emit_bufs",
                     "_live_masks"):
            if hasattr(self, attr):
                delattr(self, attr)

    def setup_parameters(self):
        """Diffusion fields per ion + background charge."""
        self._invalidate_caches()
        p = self.params
        self.D = self._tensor(np.stack([self._cellwise(ion.D_sub)
                                        for ion in self.ion_list]))
        rho = p.rho_sub if p.rho_sub is not None else {}
        self.rho = self._tensor(self._cellwise(rho) if rho else np.zeros(self.n_cells))
        self.z = self._tensor([float(i.z) for i in self.ion_list])
        return self

    def _interp_init(self, sub, kind) -> np.ndarray:
        """Nodal interpolation of initial data per subdomain."""
        coords = self.geom.nodes                           # (nc, nd, d)
        out = np.zeros((self.n_cells, self.geom.nd))
        if kind == "function":
            return np.asarray(sub, dtype=np.float64)
        for tag, val in sub.items():
            m = self.mesh.cell_tags == tag
            if kind == "constant":
                out[m] = float(val)
            elif kind == "expression":
                out[m] = np.asarray(val(coords[m]))
            else:
                raise ValueError(
                    f"initial condition type {kind!r} not recognized -- use "
                    f"'constant', 'expression' or 'function'"
                )
        return out

    def setup_FEM_spaces(self):
        """Initial conditions for concentrations and potential."""
        c0 = [self._interp_init(ion.c_init_sub, ion.c_init_sub_type).T
              for ion in self.ion_list]
        # stacked transposes keep numpy's memory order; the kernels take
        # contiguous fields
        self.c_init = self._tensor(np.stack(c0[:-1])).contiguous()
        self.c_elim_init = self._tensor(c0[-1]).contiguous()
        self.phi_init = self._tensor(np.zeros((self.nd, self.n_cells)))
        return self

    def setup_membrane_model(self, stim_params: StimParams, odes: Dict[int, Any]):
        """One ODE system per membrane tag; Cm pushed into the ODE params,
        the stimulus applied through the spatial locator mask."""
        self._set_membrane_tags(sorted(odes))
        self.stim_params = stim_params
        self.mem_models = {}
        for tag, model in odes.items():
            s0, s1 = self.tables.slices[tag]
            mids = self.tables.midpoints[s0:s1]
            mm = make_membrane(model, mids, dtype=self.dtype, device=self.device)
            mm = set_param(mm, "Cm", np.full(s1 - s0, self.params.C_M))
            if stim_params is not None and stim_params.stimulus:
                locator = stim_params.stimulus_locator or (lambda x: True)
                mask = np.array([bool(locator(x)) for x in mids])
                for key, value in stim_params.stimulus.items():
                    cur = get_param(mm, key).cpu().numpy().copy()
                    cur[mask] = value
                    mm = set_param(mm, key, cur)
            self.mem_models[tag] = mm
        return self

    def update_ode(self, tag: int, traces: Traces) -> Dict[str, torch.Tensor]:
        """Return {ode_param_name: per-facet values} pushed into the tag's
        ODE parameters each step.  Subclasses implement this."""
        raise NotImplementedError("Subclasses must implement update_ode")

    # ------------------------------------------------------------------
    # assembly wrappers
    # ------------------------------------------------------------------
    def _phys_emi(self):
        p = self.params
        return {"F": p.F, "psi": p.psi, "C_phi": p.C_phi,
                "tau_emi": self.tau, "Lp": self.Lp}

    def _phys_knp(self):
        p = self.params
        return {"F": p.F, "psi": p.psi, "C_M": p.C_M, "dt": p.dt,
                "tau_knp": self.tau_knp}

    def _all_c(self, c, c_elim):
        return torch.cat([c, c_elim[None]], dim=0)

    def _assemble_emi(self, c, c_elim, phi_M_pad, I_ch_tot_pad, t,
                      pair: bool = False, out=None, buffers=None):
        """EMI blocks (the pair operator with ``pair``), rhs and P_diag.
        ``t``: the time of the MMS data (read only with ``mms``); ``out``:
        the pair emit's buffers, ``buffers`` the EMI emit's (see
        _emit_out).  The emit reads the cell-facet slots from the tables
        the KNP membrane emit reads (_membrane_emit_tables), the cell part
        the solver's cell tables (_cell_tables)."""
        ions = {"z": self.z, "D": self.D, "c": self._all_c(c, c_elim)}
        return assembly.assemble_emi(
            self.g, self.masks, ions, self._phys_emi(), phi_M_pad, I_ch_tot_pad,
            mem_t=self.mem_dev, splitting=self.splitting_scheme, mms=self.mms, t=t,
            pm=self.pairs if pair else None, out=out, buffers=buffers,
            tables=self._membrane_emit_tables(), cell_tables=self._cell_tables())

    @staticmethod
    def _f_source_callable(ion):
        """``Ion.f_source`` as a callable(x_qp, t) -> (q, nc), or None: a
        nonzero number becomes a constant source (integrated over the ECS,
        dx(0))."""
        fs = ion.f_source
        if callable(fs):
            return fs
        val = float(fs)
        if val == 0.0:
            return None
        return lambda x, t: torch.full((x.shape[0], x.shape[-1]), val, dtype=x.dtype,
                                       device=x.device)

    def _ion_sources(self, t):
        """The solved ions' source rows (m, nd, nc), or None without sources."""
        return assembly.ion_source_rows(
            self.g, [self._f_source_callable(ion) for ion in self.ion_list[:self.N_ions]], t)

    def _live_mask(self, dtype):
        """The pair layout's (2nd, npair) live mask in ``dtype``, made once
        per dtype (the masked preconditioner applies read it)."""
        masks = self.__dict__.setdefault("_live_masks", {})
        if dtype not in masks:
            masks[dtype] = self._pair_mask.to(dtype)
        return masks[dtype]

    def _emit_out(self, kind: str):
        """The pair emit's output buffers of the step's EMI (``kind`` "emi":
        pd, pe, P_diag) or KNP ("knp": pdK, peK) operator, made once per
        dtype (pe zero outside its owner halves, which the emit never
        writes); "emi_emit": the EMI emit's (the cell layout's operator,
        rhs and P_diag, the pair layout's A_cell, rhs and reg;
        assembly.emi_emit_buffers); "membrane_emit": the KNP membrane
        emit's (the cell layout's operator and rhs, the pair layout's drift
        blocks and rhs, b_p, b_m; assembly.knp_emit_buffers).  Only
        _pde_step passes them (the "emi_emit" and "membrane_emit" buffers
        also hold the step's cell parts, assembly.emi_cell's and
        knp_cell's, and the latter alpha_sum's alpha, which the membrane
        emit reads in the same assembly): each step's emit overwrites the
        previous step's operator, which nothing holds past its solve (the
        predictor's guess is a new tensor; the pc builds, the Ritz harvest
        and the tests emit into new tensors)."""
        bufs = self.__dict__.setdefault("_emit_bufs", {})
        key = (kind, self.dtype)
        if key not in bufs:
            if kind == "emi_emit":
                bufs[key] = assembly.emi_emit_buffers(self.g, self.dtype, self.device,
                                                      pair=self.pair_layout)
            elif kind == "membrane_emit":
                bufs[key] = assembly.knp_emit_buffers(self.g, self.mem_dev, self.N_ions,
                                                      self.dtype, self.device,
                                                      pair=self.pair_layout)
            else:
                m = None if kind == "emi" else self.N_ions
                bufs[key] = emit_buffers(self.pairs, self.nd, self.dtype, self.device, m=m,
                                         diag=kind == "emi")
        return bufs[key]

    def _bj_out(self, step: bool, kind: str, diag, halves: bool = False):
        """The step's block-Jacobi inverse buffer of its EMI (``kind``
        "emi") or KNP ("knp") solve, shaped as the diagonal blocks ``diag``
        it inverts, made once per dtype and form and kept with the emit
        buffers; zero, as the halves form needs it (it never writes the
        off-diagonal blocks).  None unless ``step``: only the step's solves
        use it, under the emit buffers' ownership rule (each step's inverse
        overwrites the previous step's, which nothing holds past its
        solve); every other caller's inverse is a new tensor."""
        if not step:
            return None
        bufs = self.__dict__.setdefault("_emit_bufs", {})
        key = ("bj_" + kind, halves, diag.dtype, tuple(diag.shape))
        if key not in bufs:
            bufs[key] = torch.zeros(diag.shape, dtype=diag.dtype, device=diag.device)
        return bufs[key]

    def _membrane_emit_tables(self):
        """The KNP membrane emit's static tables (assembly.knp_emit_tables:
        the packed cell-facet slots, which the EMI emit reads too, the
        membrane cells, the membrane facets' cells and areas), built and
        checked once per dtype and kept
        with the emit buffers: a new membrane map (_set_membrane_tags) or
        cell numbering (_invalidate_caches) drops them with those."""
        bufs = self.__dict__.setdefault("_emit_bufs", {})
        key = ("membrane_emit_tables", self.dtype)
        if key not in bufs:
            bufs[key] = assembly.knp_emit_tables(self.g, self.mem_dev)
        return bufs[key]

    def _cell_tables(self):
        """The per-cell assembly kernels' static tables (assembly.cell_tables:
        G, vol, phibar, M0, the charges z and, for alpha_sum and
        eliminated_concentration, D and rho), built and checked once per
        dtype and kept with the emit buffers: a new cell numbering or
        physics (_invalidate_caches) drops them with those."""
        bufs = self.__dict__.setdefault("_emit_bufs", {})
        key = ("cell_tables", self.dtype)
        if key not in bufs:
            bufs[key] = assembly.cell_tables(self.g, self.z, D=self.D, rho=self.rho)
        return bufs[key]

    def _knp_static(self, k):
        """The time-independent KNP operator of ion k (mass + stiffness +
        SIP), assembled once and cached."""
        if not hasattr(self, "_knp_static_blocks"):
            self._knp_static_blocks = {}
        if k not in self._knp_static_blocks:
            ion = self.ion_list[k]
            self._knp_static_blocks[k] = assembly.assemble_knp_static(
                self.g, self.masks, {"z": float(ion.z), "D": self.D[k]},
                self._phys_knp())
        return self._knp_static_blocks[k]

    # ------------------------------------------------------------------
    # one PDE time step (steps I + II + updates)
    # ------------------------------------------------------------------
    @staticmethod
    def _pads(state):
        phi_M = state["phi_M"]
        phi_M_pad = torch.cat([phi_M, phi_M.new_zeros(1)])
        I_ch = state["I_ch"]
        I_ch_pad = torch.cat([I_ch, I_ch.new_zeros((I_ch.shape[0], 1))], dim=1)
        return phi_M_pad, I_ch_pad, I_ch_pad.sum(dim=0)

    def _pde_step(self, state, solver_params: SolverParams, c_n=None,
                  advance_time: bool = True):
        """EMI solve -> KNP solves -> state updates.  ``c_n``: the time
        level's concentrations (the mass term of the KNP rhs), the state's
        by default; a Picard iteration passes the frozen level while the
        state carries the latest iterate.  ``advance_time=False`` keeps t."""
        sp_ = solver_params
        if self.mms is not None or sp_.direct_emi or sp_.direct_knp:
            return self._pde_step_eager(state, sp_, c_n, advance_time)
        c, c_elim, t = state["c"], state["c_elim"], state["t"]
        c_n = c if c_n is None else c_n
        pc = state.get("pc")
        pads = self._pads(state)

        stats = {}
        blocks, rhs, Pd = self._emi_assemble_step(state, pads)
        phi, stats["emi_iters"], stats["emi_converged"] = self._emi_solve_iterative(
            blocks, Pd, rhs, state["phi"], sp_, pc=pc.get("emi") if pc else None,
            phi_prev=state.get("phi_prev"), step=True)

        blocksK, rhsK = self._knp_assemble_step(state, phi, pads, c_n)
        c, stats["knp_iters"], stats["knp_converged"] = self._knp_solve_all(
            blocksK, rhsK, c, sp_, pcK=pc.get("knp") if pc else None, step=True)
        return self._finalize_step(state, stats, c, phi, t, advance_time)

    def _emi_assemble_step(self, state, pads):
        """The step's EMI blocks (the pair operator on the pair layout), rhs
        and P_diag at ``state``, emitted into the step's buffers
        (_emit_out); ``pads`` = _pads(state)."""
        phi_M_pad, _, I_ch_tot_pad = pads
        pair = self.pair_layout
        return self._assemble_emi(state["c"], state["c_elim"], phi_M_pad, I_ch_tot_pad,
                                  state["t"], pair=pair,
                                  out=self._emit_out("emi") if pair else None,
                                  buffers=self._emit_out("emi_emit"))

    def _knp_assemble_step(self, state, phi, pads, c_n):
        """The step's KNP operators and rhs of all solved ions at ``state``
        and the new ``phi``, emitted into the step's buffers."""
        phi_M_pad, I_ch_pad, I_ch_tot_pad = pads
        return self._knp_assemble_all(
            state["c"], state["c_elim"], phi, phi_M_pad, I_ch_pad, I_ch_tot_pad, state["t"],
            c_n, out=self._emit_out("knp") if self.pair_layout else None,
            buffers=self._emit_out("membrane_emit"))

    def _pde_step_eager(self, state, sp_: SolverParams, c_n=None, advance_time=True):
        """The step of the MMS path and the direct solves (the JAX
        package's eager branch): EMI by the host direct solve (the constant
        nullspace bordered) or PCG, then the KNP solves -- batched GMRES as
        on the main path for a non-MMS problem with iterative KNP, else one
        ion at a time, by the host direct solve or GMRES.  Each phase's
        wall, a device synchronise at its end, goes into stats["phases"]."""
        if self.pair_layout:
            raise NotImplementedError("direct solves on the pair layout are not ported")
        c, c_elim, phi, t = state["c"], state["c_elim"], state["phi"], state["t"]
        c_n = c if c_n is None else c_n
        pc = state.get("pc")
        phi_M_pad, I_ch_pad, I_ch_tot_pad = self._pads(state)
        phases, phase = self._phase_timer()
        stats = {"phases": phases}
        blocks, rhs, Pd = self._assemble_emi(c, c_elim, phi_M_pad, I_ch_tot_pad, t)
        phase("emi_assem")
        if sp_.direct_emi:
            phi = self._tensor(solve_direct(blocks, self.g["nbr"], rhs,
                                            nullspace_constant=True)).contiguous()
            stats["emi_iters"], stats["emi_converged"] = 0, True
        else:
            phi, stats["emi_iters"], stats["emi_converged"] = self._emi_solve_iterative(
                blocks, Pd, rhs, phi, sp_, pc=pc.get("emi") if pc else None,
                phi_prev=state.get("phi_prev"))
        phase("emi_solve")

        if self.mms is not None:
            blocksK, rhsK = self._knp_assemble_mms(c, phi, t, c_n)
        else:
            blocksK, rhsK = self._knp_assemble_all(c, c_elim, phi, phi_M_pad, I_ch_pad,
                                                   I_ch_tot_pad, t, c_n)
        phase("knp_assem")
        if self.mms is None and not sp_.direct_knp:
            c, stats["knp_iters"], stats["knp_converged"] = self._knp_solve_all(
                blocksK, rhsK, c, sp_, pcK=pc.get("knp") if pc else None)
        else:
            c, stats["knp_iters"], stats["knp_converged"] = self._knp_solve_per_ion(
                blocksK, rhsK, c, sp_)
        phase("knp_solve")
        return self._finalize_step(state, stats, c, phi, t, advance_time)

    def _knp_solve_per_ion(self, blocksK, rhsK, c, sp_: SolverParams):
        """One KNP solve per solved ion: the host direct solve, or
        increment-form GMRES (krylov.gmres) with a preconditioner built
        for the solve (_make_precond)."""
        new_c, iters, conv = [], [], []
        for k in range(self.N_ions):
            B, b = blocksK[k], rhsK[k]
            if sp_.direct_knp:
                new_c.append(self._tensor(solve_direct(B, self.g["nbr"], b)).contiguous())
                iters.append(0)
                conv.append(True)
                continue
            mv = lambda v, B=B: self._matvec(B, v)
            r0 = b - mv(c[k])
            res = gmres(mv, r0, torch.zeros_like(r0), self._make_precond(B, B[0], sp_, sym=False),
                        rtol=sp_.rtol_knp, atol=sp_.atol_knp, max_it=sp_.max_it_knp,
                        restart=sp_.gmres_restart, b_ref=b)
            new_c.append((c[k] + res.x).contiguous())
            iters.append(res.iters)
            conv.append(res.converged)
        return torch.stack(new_c), iters, all(conv)

    def _knp_assemble_mms(self, c, phi, t, c_n=None):
        """The MMS KNP operators and rhs of all solved ions
        (assembly.assemble_knp_mms): the static operator cached by
        attach_pc, the constant couplings C_sub of each ion; ``c_n`` the
        time level of the mass term (``c`` by default)."""
        cache = getattr(self, "_knp_static_blocks", {})
        statics = cache.get(-1)
        if statics is None:
            statics = torch.stack([self._knp_static(k) for k in range(self.N_ions)])
        ionsd = {"z": self.z[:self.N_ions], "D": self.D[:self.N_ions],
                 "c_n": c if c_n is None else c_n, "c_k": c,
                 "C_sub": [(float(ion.C_sub[0]), float(ion.C_sub[1]))
                           for ion in self.ion_list[:self.N_ions]]}
        return assembly.assemble_knp_mms(
            self.g, self.masks, ionsd, self._phys_knp(), phi, mem_t=self.mem_dev,
            mms=self.mms, t=t, static_blocks=statics, sources=self._ion_sources(t),
            tables=self._membrane_emit_tables(), cell_tables=self._cell_tables())

    def _matvec(self, blocks, v):
        """Block-ELL operator apply (kernel A on the card), single systems
        (nd, nc) and ion-batched (m, nd, nc)."""
        v = v.contiguous()
        if v.dim() == 3:
            return bell_matvec_multi(blocks, self.g["nbr"], v)
        return bell_matvec(blocks, self.g["nbr"], v)

    def _emi_solve_iterative(self, blocks, Pd, rhs, phi, sp_: SolverParams,
                             pc=None, phi_prev=None, step=False):
        """Increment-form PCG for the EMI system: solve A d = b - A phi_0
        around zero, the tolerance relative to the full rhs (b_ref).

        ``phi_prev`` enables the linear-predictor guess 2 phi_k - phi_{k-1};
        the guess with the smaller initial residual is used.  On the pair
        layout (``blocks`` a (pd, pe) tuple) the vectors convert to pairs in
        one relayout into a stack, the solve runs on pairs with the live mask
        in the nullspace projection, and the solution converts back.
        ``step``: the preconditioner's block-Jacobi inverse goes into the
        step's buffer (_bj_out)."""
        pair = isinstance(blocks, tuple)
        mask = None
        if pair:
            pm = self.pairs
            pd_, pe_ = blocks
            mv = lambda v: pair_matvec(pd_, pe_, pm, v.contiguous())
            stackc = [rhs, phi] + ([phi_prev] if phi_prev is not None else [])
            conv = to_pair(pm, stackc)
            rhs, phi = conv[0], conv[1]
            phi_prev = conv[2] if phi_prev is not None else None
            mask = self._pair_mask
        else:
            mv = lambda v: self._matvec(blocks, v)
        if phi_prev is not None:
            pred = 2.0 * phi - phi_prev
            ra = rhs - mv(phi)
            rb = rhs - mv(pred)
            use_pred = torch.dot(rb.reshape(-1), rb.reshape(-1)) < torch.dot(
                ra.reshape(-1), ra.reshape(-1))
            guess = torch.where(use_pred, pred, phi)
            r0 = torch.where(use_pred, rb, ra)
        else:
            guess = phi
            r0 = rhs - mv(phi)
        res = pcg(
            mv, r0, torch.zeros_like(phi),
            self._make_precond(blocks, Pd, sp_, pc=pc, step=step),
            rtol=sp_.rtol_emi, atol=sp_.atol_emi, max_it=sp_.max_it_emi,
            project_nullspace=True, b_ref=rhs, nullspace_mask=mask,
        )
        # on pairs the relayout carries the add (the same bits: a permutation)
        out = from_pair(self.pairs, res.x, add=guess) if pair else guess + res.x
        # the assembly and trace kernels take contiguous fields
        return out.contiguous(), res.iters, res.converged

    def _finalize_step(self, state, stats, c, phi, t, advance_time=True):
        """Post-solve updates: phi_M jump, eliminated ion (kept by the
        EMI-only solver, whose c is frozen), time (kept with
        ``advance_time=False``)."""
        phi_M = assembly.jump_phi_M_m(self.g, self.mem_dev, phi)
        # the solver's z, rho and z_elim = z[-1] from its cell tables (checked
        # once); c_elim is a new tensor each step (the state holds it)
        c_elim = state["c_elim"] if self._emi_only else assembly.eliminated_concentration(
            c, tables=self._cell_tables())
        new_state = dict(state)
        new_state.update(c=c, c_elim=c_elim, phi=phi, phi_M=phi_M,
                         t=t + self.params.dt if advance_time else t)
        if "phi_prev" in state:        # predictor base for the next step
            new_state["phi_prev"] = state["phi"]
        return new_state, stats

    def _knp_assemble_all(self, c, c_elim, phi, phi_M_pad, I_ch_pad,
                          I_ch_tot_pad, t, c_n, out=None, buffers=None):
        """KNP assembly for all solved ions in one pass:
        (blocks (m, K, nd, nd, nc), rhs (m, nd, nc)), or ((pdK, peK), rhs)
        on the pair layout (``out``: the pair emit's buffers, ``buffers``
        the membrane emit's, see _emit_out; alpha_sum writes their alpha).
        ``t``: the time of the ion sources (f_source), added to the rhs."""
        tab = self._cell_tables()
        # c and c_elim read in place (no concatenation)
        alpha_sum = assembly.alpha_sum(self.z, self.D, c, c_elim, out=buffers, tables=tab)
        # the ion-stacked static operator (-1), in pair form (-2) on the
        # pair layout, both cached by attach_pc
        cache = getattr(self, "_knp_static_blocks", {})
        statics = cache.get(-2 if self.pair_layout else -1)
        if statics is None:
            statics = torch.stack([self._knp_static(k) for k in range(self.N_ions)])
            if self.pair_layout:
                statics = cell_bell_to_pair(self.pairs, statics)
        ionsd = {"z": self.z[:self.N_ions], "D": self.D[:self.N_ions],
                 "c_n": c_n, "c_k": c}
        blocksK, rhsK = assembly.assemble_knp_all(
            self.g, self.masks, ionsd, self._phys_knp(), phi, alpha_sum,
            phi_M_pad, I_ch_pad[:self.N_ions], I_ch_tot_pad,
            mem_t=self.mem_dev, static_blocks=statics,
            splitting=self.splitting_scheme,
            pm=self.pairs if self.pair_layout else None, out=out, buffers=buffers,
            tables=self._membrane_emit_tables(), cell_tables=tab)
        src = self._ion_sources(t)
        return blocksK, rhsK if src is None else (rhsK + src).contiguous()

    @staticmethod
    def _knp_krylov(mv, r0, pcf, b_ref, sp_: SolverParams):
        """The batched KNP solve for the increment from zero, the tolerance
        relative to the full rhs ``b_ref``: GMRES, or BiCGStab (kernel K15
        on the card) with ``knp_solver="bicgstab"``."""
        kw = dict(rtol=sp_.rtol_knp, atol=sp_.atol_knp, max_it=sp_.max_it_knp, b_ref=b_ref)
        if sp_.knp_solver == "bicgstab":
            return bicgstab_batched(mv, r0, torch.zeros_like(r0), pcf, **kw)
        return gmres_batched(mv, r0, torch.zeros_like(r0), pcf, restart=sp_.gmres_restart, **kw)

    def _knp_solve_all(self, blocksK, rhsK, c, sp_: SolverParams, pcK=None, step=False):
        """Batched increment-form GMRES (or BiCGStab) over the ion axis:
        all solved ions share one Krylov loop whose matvec is one kernel
        launch.  The block-Jacobi inverse reads slot 0 of the operator in
        place; ``step``: into the step's buffer (_bj_out)."""
        if isinstance(blocksK, tuple):
            return self._knp_solve_all_pair(blocksK, rhsK, c, sp_, pcK, step)
        kind = sp_.precond_knp or sp_.precond
        mv = lambda V: self._matvec(blocksK, V)
        P_diag = blocksK[:, 0]
        inv_out = self._bj_out(step, "knp", P_diag)
        if kind == "two_level":
            data = pcK if pcK is not None else self._build_knp_pc(blocksK, sp_)
            # GMRES and BiCGStab consume (or copy) each result before the
            # next apply, so the applies reuse one buffer
            pcf = two_level_apply_batched(data, P_diag, sp_.agg_size, buffer=True,
                                          inv_out=inv_out)
        else:
            bj = block_jacobi_operands(block_jacobi_inverse(P_diag, out=inv_out))
            pcf = lambda r: block_jacobi_apply(bj, r.contiguous())
        res = self._knp_krylov(mv, rhsK - mv(c), pcf, rhsK, sp_)
        return (c + res.x).contiguous(), res.iters, res.converged

    def _knp_solve_all_pair(self, blocksK, rhsK, c, sp_: SolverParams, pcK, step=False):
        """_knp_solve_all on the pair layout: the rhs and the iterate
        convert once, the preconditioner is live-masked (its chunk prolong
        writes into the dead self-pair halves) and uses the pair_bj variant
        of the pair diagonal (the halves form inverts the two diagonal
        sub-blocks of the unmasked diagonal)."""
        kind = sp_.precond_knp or sp_.precond
        pm = self.pairs
        pdK, peK = blocksK
        mv = lambda V: pair_matvec_multi(pdK, peK, pm, V.contiguous())
        conv = to_pair(pm, [rhsK, c])
        rhs_p, c_p = conv[0], conv[1]
        lm = self._live_mask(rhs_p.dtype)
        halves = sp_.pair_bj == "halves"
        inv_out = self._bj_out(step, "knp", pdK, halves)
        if kind == "two_level":
            data = pcK if pcK is not None else self._build_knp_pc(blocksK, sp_)
            # the prolong-add applies the mask; GMRES and BiCGStab consume
            # (or copy) each result before the next apply, so the applies
            # reuse one buffer
            pcf = two_level_apply_batched(data, pdK, sp_.agg_size // 2, halves=halves,
                                          buffer=True, mask=lm, inv_out=inv_out)
        else:
            bj = block_jacobi_operands(block_jacobi_inverse(pdK, halves, inv_out), halves,
                                       buffer=True)
            pcf = lambda r: block_jacobi_apply(bj, r.contiguous()) * lm[None]
        res = self._knp_krylov(mv, rhs_p - mv(c_p), pcf, rhs_p, sp_)
        return from_pair(pm, res.x, base=c), res.iters, res.converged

    # ------------------------------------------------------------------
    # ODE step (step 0 of the splitting)
    # ------------------------------------------------------------------
    def _ode_table(self, state):
        """The static tag table of the ODE step (engine.tag_table) for the
        state's membrane models under the scheme, built once and cached."""
        scheme = self.params.ode_scheme
        key = (scheme, tuple((tag, mm.model) for tag, mm in state["mem"].items()))
        cache = self._ode_tables
        if key not in cache:
            cache[key] = engine.tag_table(
                [(mm.model, self.tables.slices[tag][0],
                  self.tables.slices[tag][1] - self.tables.slices[tag][0])
                 for tag, mm in state["mem"].items()],
                self.n_mem, [ion.name for ion in self.ion_list], scheme)
        return cache[key]

    def _ode_pushes(self, state, first_step: bool):
        """The PDE -> ODE pushes of this step (V, Nernst potentials,
        update_ode) as sources the ODE step reads in place: (tag table, one
        engine.TagPush per tag).  V is phi_M at the tag's offset, E_<ion>
        the Nernst row of the step's trace tensor, update_ode's values the
        tensors the hook returned."""
        p = self.params
        table = self._ode_table(state)
        phi_M = state["phi_M"].contiguous()
        # every ion's facet averages and Nernst potential over all membrane
        # facets, in one kernel launch; each tag reads its slice
        tr = assembly.membrane_traces_m(
            self.g, self.mem_dev, list(state["c"]) + [state["c_elim"]],
            [assembly.nernst_coef(float(ion.z), p.F, p.R, p.temperature)
             for ion in self.ion_list]).contiguous()
        # the membrane potential is skipped on the first step with a
        # constant phi_M init
        push_v = not (first_step and p.phi_M_init_type == "constant")
        nernst, row = 2 * tr.stride(0), tr.stride(1)      # tr[2, k, s0] at nernst + k row + s0
        pushes = []
        for e, (tag, mm) in zip(table.entries, state["mem"].items()):
            s0, s1 = e.s0, e.s0 + e.n
            # the membrane potential, the Nernst potentials for every ion
            push = engine.TagPush(v=(phi_M, s0) if push_v else None, params={
                slot: (tr, nernst + k * row + s0)
                for k, slot in enumerate(e.nernst_slot) if slot >= 0})
            # app-specific parameter pushes (subclass hook)
            for name, vals in self.update_ode(tag, Traces(self, tr, (s0, s1))).items():
                push.params[mm.model.PARAMS[name]] = engine.push_source(
                    vals, e.n, mm.params)
            pushes.append(push)
        return table, pushes

    def _ode_inputs(self, state, first_step: bool):
        """The membrane state of every tag with the PDE -> ODE pushes of
        this step applied (V, Nernst potentials, update_ode), ready to
        integrate."""
        _, pushes = self._ode_pushes(state, first_step)
        return {tag: engine.apply_push(mm, push)
                for (tag, mm), push in zip(state["mem"].items(), pushes)}

    def _ode_step(self, state, first_step: bool):
        """Step 0 of the splitting: the pushes, every tag's ODE step and the
        pulls (phi_M, I_ch) in one engine.ode_step_tags call (one kernel
        launch on the card)."""
        p = self.params
        table, pushes = self._ode_pushes(state, first_step)
        mems, phi_M, I_ch = engine.ode_step_tags(
            table, list(state["mem"].values()), pushes, state["t"], p.dt, p.n_steps_ODE)
        new_state = dict(state)
        new_state.update(mem=dict(zip(state["mem"], mems)), phi_M=phi_M, I_ch=I_ch)
        return new_state

    # ------------------------------------------------------------------
    # initial state
    # ------------------------------------------------------------------
    def _initial_state(self, t0: float):
        p = self.params
        if p.phi_M_init_type == "constant":
            phi_M = torch.full((self.n_mem,), float(p.phi_M_init),
                               dtype=self.dtype, device=self.device)
            # active runs: seed phi_M from each membrane model's resting V
            for tag, mm in self.mem_models.items():
                s0, s1 = self.tables.slices[tag]
                phi_M[s0:s1] = mm.get_state("V")
        elif p.phi_M_init_type == "expression":
            phi_M = self._tensor(
                [p.phi_M_init(x) for x in self.tables.midpoints]
                if callable(p.phi_M_init) else np.zeros(self.n_mem))
        elif p.phi_M_init_type == "function":
            phi_M = self._phi_M_function()
        else:
            raise ValueError(f"unknown phi_M_init_type {p.phi_M_init_type!r}")
        return {
            "c": self.c_init,
            "c_elim": self.c_elim_init,
            "phi": self.phi_init,
            "phi_prev": self.phi_init,   # linear-predictor base (EMI guess)
            "phi_M": phi_M,
            "I_ch": torch.zeros((len(self.ion_list), self.n_mem),
                                dtype=self.dtype, device=self.device),
            "t": torch.tensor(float(t0), dtype=self.dtype, device=self.device),
            "mem": dict(self.mem_models),
        }

    def _phi_M_function(self):
        """phi_M of a function-type init: the given per-facet values."""
        return self._tensor(self.params.phi_M_init)

    # ------------------------------------------------------------------
    # time loops
    # ------------------------------------------------------------------
    def solve_system_active(self, Tstop, t, solver_params: SolverParams,
                            filename=None, save_fields=False,
                            save_solver_stats=False, scan_steps: int = 0, on_step=None):
        """Full splitting scheme with membrane ODEs, one step at a time
        (``save_solver_stats``: the per-phase stats files under
        ``filename + "solver/"``, each phase timed with a device
        synchronise; no field files: H5 output is not ported; ``on_step``,
        a callable(k, state) called after each step k, reads what a caller
        wants of the fields and must leave the state as it is).  Per-step
        walls end in a device synchronise: ``self.ode_walls`` for the ODE,
        ``self.stats.step_walls`` for the PDE part."""
        if scan_steps:
            raise NotImplementedError("scan_steps: use run_block")
        _check_supported(solver_params)
        self._io_setup(filename, save_fields, save_solver_stats, solver_params)
        self.splitting_scheme = True
        state = self.attach_pc(self._initial_state(float(t)), solver_params)
        n_steps = int(round(Tstop / self.params.dt))
        refresh = solver_params.pc_refresh_every
        self.ode_walls = []
        for k in range(n_steps):
            if refresh and k and k % refresh == 0:
                state = self._refresh_pc(state, solver_params)
            ts = _time.perf_counter()
            state = self._ode_step(state, first_step=(k == 0))
            _sync(self.device)
            self.ode_walls.append(_time.perf_counter() - ts)
            self.stats.ode_solve_timer += self.ode_walls[-1]
            state = self._timed_pde_step(state, solver_params, k)
            if on_step is not None:
                on_step(k, state)
        self.stats.close_files()
        self.state = state
        return state

    def solve_system_passive(self, Tstop, t, solver_params: SolverParams, filename=None,
                             save_fields=False, save_solver_stats=False, picard=False):
        """No splitting and no ODE stepping, one PDE step at a time: the MMS
        verification runs' loop; ``picard`` makes each step a Picard step
        (solve_for_time_step_picard, recorded with a zero wall);
        ``save_solver_stats`` as in solve_system_active (no field files: H5
        output is not ported).  Per-step walls end in a device synchronise
        (``self.stats.step_walls``)."""
        _check_supported(solver_params)
        self._io_setup(filename, save_fields, save_solver_stats, solver_params)
        self.splitting_scheme = False
        state = self.attach_pc(self._initial_state(float(t)), solver_params)
        n_steps = int(round(Tstop / self.params.dt))
        for k in range(n_steps):
            if picard:
                state, st, _ = self.solve_for_time_step_picard(state, solver_params)
                self.stats.record_step(st, 0.0)
            else:
                state = self._timed_pde_step(state, solver_params, k)
        self.stats.close_files()
        self.state = state
        return state

    def solve_for_time_step_picard(self, state, solver_params: SolverParams,
                                   tol: float = 1e-4, max_iter: int = 25):
        """One time step by inner Picard iterations over steps I + II at the
        frozen time level c_n = state["c"]: t advanced first, then PDE steps
        from the latest iterate until the sup-norm change of c is at most
        ``tol``.  Raises RuntimeError when the change grows (divergence) or
        after ``max_iter`` iterations, and on an unconverged inner solve.
        Returns (state, the last inner step's stats, iterations)."""
        c_n = state["c"]
        s = dict(self.attach_pc(state, solver_params))
        s["t"] = state["t"] + self.params.dt
        eps, it, stats = float("inf"), 0, None
        while eps > tol:
            if it >= max_iter:
                raise RuntimeError(f"Picard solver: max iterations ({max_iter}) reached "
                                   f"(eps={eps})")
            it += 1
            prev_eps, prev = eps, s["c"]
            s, stats = self._pde_step(s, solver_params, c_n=c_n, advance_time=False)
            eps = float(torch.max(torch.abs(prev - s["c"])))
            if eps > prev_eps:
                raise RuntimeError(f"Picard solver diverged (eps increased {prev_eps} -> {eps})")
            self._check_convergence(stats, solver_params)
        if solver_params.verbose:
            print(f"{bcolors.OKCYAN} Summary Picard: eps = {eps}, #iters = {it} {bcolors.ENDC}")
        return s, stats, it

    # ------------------------------------------------------------------
    # solver-stats files (the reference's protocol, utils/stats.py)
    # ------------------------------------------------------------------
    def _io_setup(self, filename, save_fields, save_solver_stats, sp_: SolverParams):
        """Open the stats files under ``filename + "solver/"`` when
        ``save_solver_stats``; H5 field output is not ported."""
        if save_fields:
            raise NotImplementedError("save_fields: H5 field output (io/checkpoint.py, h5py) "
                                      "is not ported")
        if save_solver_stats and filename is None:
            raise ValueError("specify filename when saving fields/solver stats")
        self.filename = filename
        self.save_solver_stats = bool(save_solver_stats)
        if save_solver_stats:
            self.stats.open_files(filename + "solver/", self.mesh,
                                  self.N_ions * self.n_cells * self.nd,
                                  self.n_cells * self.nd, sp_)


    def run_block(self, state, solver_params: SolverParams, n_steps: int):
        """``n_steps`` full splitting steps (ODE + PDE) from ``state``; the
        counterpart of the JAX package's fused_block.  Returns
        (state, stats) with per-step lists under the same keys."""
        _check_supported(solver_params)
        self.splitting_scheme = True
        out = {"emi_iters": [], "knp_iters": [], "emi_converged": [],
               "knp_converged": []}
        for _ in range(n_steps):
            if self.mem_models:
                state = self._ode_step(state, first_step=False)
            state, st = self._pde_step(state, solver_params)
            for key in out:
                out[key].append(st[key])
        return state, out

    def _timed_pde_step(self, state, solver_params, k):
        if (self.save_solver_stats and self.mms is None and not solver_params.direct_emi
                and not solver_params.direct_knp):
            return self._timed_pde_step_phased(state, solver_params, k)
        ts = _time.perf_counter()
        state, st = self._pde_step(state, solver_params)
        _sync(self.device)
        dt_wall = _time.perf_counter() - ts
        self._check_convergence(st, solver_params)
        self.stats.record_step(st, dt_wall)
        if solver_params.verbose:
            print(f"{bcolors.WARNING} t = {float(state['t']):.6g}  k = {k} {bcolors.ENDC}")
            print(f"{bcolors.OKGREEN} emi iters: {st['emi_iters']}, "
                  f"knp iters: {st['knp_iters']}, "
                  f"step wall: {dt_wall:.4f}s {bcolors.ENDC}")
        return state

    def _phase_timer(self):
        """(phases dict, phase(name)): phase(name) synchronises the device
        and adds the wall since the previous mark to phases[name]."""
        phases, mark = {}, [_time.perf_counter()]

        def phase(name):
            _sync(self.device)
            now = _time.perf_counter()
            phases[name] = phases.get(name, 0.0) + now - mark[0]
            mark[0] = now

        return phases, phase

    def _record_phased(self, state, st, sp_: SolverParams, k, wall):
        """Check, record and print a phased step's stats."""
        self._check_convergence(st, sp_)
        self.stats.record_step(st, wall)
        if sp_.verbose:
            print(f"{bcolors.WARNING} t = {float(state['t']):.6g}  k = {k} {bcolors.ENDC}")
            print(f"{bcolors.OKGREEN} emi iters: {st['emi_iters']}, "
                  f"knp iters: {st['knp_iters']}, "
                  f"phases: { {p: round(v, 4) for p, v in st['phases'].items()} } "
                  f"{bcolors.ENDC}")

    def _timed_pde_step_phased(self, state, sp_: SolverParams, k):
        """The iterative step in four timed phases (EMI and KNP, assembly
        and solve, each ending in a device synchronise) for the stats files,
        the EMI phases only on the EMI-only solver.  As the JAX package's
        phase functions, the full step's EMI solve starts from phi without
        the linear predictor, the EMI-only step's with it."""
        phases, phase = self._phase_timer()
        t0 = _time.perf_counter()
        pc = state.get("pc")
        pads = self._pads(state)
        blocks, rhs, Pd = self._emi_assemble_step(state, pads)
        phase("emi_assem")
        phi, emi_iters, emi_conv = self._emi_solve_iterative(
            blocks, Pd, rhs, state["phi"], sp_, pc=pc.get("emi") if pc else None,
            phi_prev=state.get("phi_prev") if self._emi_only else None)
        phase("emi_solve")
        if self._emi_only:
            c, knp_iters, knp_conv = state["c"], [0] * self.N_ions, True
        else:
            blocksK, rhsK = self._knp_assemble_step(state, phi, pads, state["c"])
            phase("knp_assem")
            c, knp_iters, knp_conv = self._knp_solve_all(blocksK, rhsK, state["c"], sp_,
                                                         pcK=pc.get("knp") if pc else None)
            phase("knp_solve")
        new_state = self._finalize_step(state, {}, c, phi, state["t"])[0]
        _sync(self.device)
        st = {"emi_iters": emi_iters, "knp_iters": knp_iters, "emi_converged": emi_conv,
              "knp_converged": knp_conv, "phases": phases}
        self._record_phased(new_state, st, sp_, k, _time.perf_counter() - t0)
        return new_state

    def _check_convergence(self, st, sp_: SolverParams):
        """Fail loudly when a Krylov solve hit max_it without converging."""
        if not sp_.error_if_not_converged or st is None:
            return
        if not st.get("emi_converged", True):
            raise RuntimeError(
                f"EMI Krylov solve did not converge within "
                f"max_it_emi={sp_.max_it_emi} (rtol_emi={sp_.rtol_emi})")
        if not st.get("knp_converged", True):
            raise RuntimeError(
                f"KNP Krylov solve did not converge within "
                f"max_it_knp={sp_.max_it_knp} (rtol_knp={sp_.rtol_knp})")

    # ------------------------------------------------------------------
    # preconditioner
    # ------------------------------------------------------------------
    def _comp_arrays(self):
        """Compartment one-hot rows (n_comp, nc) and ids (nc,) on the
        device.  Inert pad cells (compartment -1, the pair layout's dead
        halves) get a zero column and id 0."""
        if not hasattr(self, "_comp_onehot"):
            comp = self._comp_np
            live = comp >= 0
            oh = np.zeros((int(comp.max()) + 1, comp.shape[0]))
            oh[comp[live], np.flatnonzero(live)] = 1.0
            self._comp_onehot = self._tensor(oh)
            self._comp_ids = torch.as_tensor(np.where(live, comp, 0).astype(np.int32),
                                             device=self.device)
        return self._comp_onehot, self._comp_ids

    def _make_precond(self, blocks, P_diag, sp_: SolverParams, pc=None, sym=True,
                      step=False):
        """Preconditioner apply of the EMI operator (``sym``) or of one
        ion's KNP operator (the per-ion solves): two-level (from the frozen
        ``pc`` data, or built on the spot: the EMI one with exact
        compartment deflation, the KNP one with the exact mass diagonal
        vol/dt) or plain block-Jacobi.  The batched KNP solve builds its
        apply in _knp_solve_all.  ``step``: the step's EMI solve, whose
        block-Jacobi inverse goes into the step's buffer (_bj_out)."""
        kind = sp_.precond if sym else (sp_.precond_knp or sp_.precond)
        if kind == "two_level" and isinstance(blocks, tuple):
            return self._make_precond_pair(blocks, P_diag, sp_, pc, step)
        if kind == "two_level":
            if pc is not None:
                # PCG consumes each result before the next apply: one buffer
                return two_level_apply_fn(pc, P_diag, sp_.agg_size, buffer=True,
                                          inv_out=self._bj_out(step, "emi", P_diag))
            comp_onehot, comp_ids = self._comp_arrays() if sym else (None, None)
            return make_two_level(
                blocks, P_diag, self.g["nbr"], sp_.agg_size, sym=sym,
                comp_onehot=comp_onehot, comp_ids=comp_ids,
                extra_diag=P_diag - blocks[0] if sym else None,
                mass_diag=None if sym else self.g["vol"] / self.params.dt,
                ridge=sp_.coarse_ridge)
        bj = block_jacobi_operands(block_jacobi_inverse(P_diag,
                                                        out=self._bj_out(step, "emi", P_diag)))
        return lambda r: block_jacobi_apply(bj, r.contiguous())

    def _make_precond_pair(self, blocks, P_diag, sp_: SolverParams, pc, step=False):
        """Two-level EMI apply on the pair layout: chunks of agg_size // 2
        pairs (agg_size cells).  The apply is live-masked: the chunk-coarse
        prolong broadcasts into the dead self-pair halves, and left
        unmasked those pollute <p, A p> through the dead-identity rows and
        CG stalls at the iteration cap.  Masked, it is the preconditioner
        restricted to the live subspace, SPD there, and the dead Krylov
        components stay exactly zero.  The halves form inverts the two
        diagonal sub-blocks of the unmasked diagonal."""
        pd_, pe_ = blocks
        agg_p = sp_.agg_size // 2
        halves = sp_.pair_bj == "halves"
        if pc is None:
            oh, ids = self._comp_arrays()
            cop0 = self.pairs["cop"][0]
            # the JAX package forms extra_diag from the masked diagonal here
            P_b = P_diag * self._pair_bj_halves if halves else P_diag
            pc = build_two_level(
                None, pair_nbr(self.pairs), agg_p, sym=True,
                comp_onehot=oh[:, cop0], comp_ids=ids[cop0],
                extra_diag=P_b - pd_, v=pair_v_sums(pd_, pe_),
                ridge=sp_.coarse_ridge)
        # the prolong-add applies the mask; PCG consumes each result before
        # the next apply, so the applies reuse one buffer
        return two_level_apply_fn(pc, P_diag, agg_p, halves=halves, buffer=True,
                                  mask=self._live_mask(P_diag.dtype),
                                  inv_out=self._bj_out(step, "emi", P_diag, halves))

    def _build_knp_pc(self, blocksK, sp_: SolverParams):
        """Per-ion two-level coarse data stacked over the ion axis (pairs:
        chunks of agg_size // 2 pairs, the pair mass on the diagonal)."""
        if isinstance(blocksK, tuple):
            pdK, peK = blocksK
            parts = [build_two_level(None, pair_nbr(self.pairs), sp_.agg_size // 2,
                                     sym=False,
                                     mass_diag=self._pair_mass / self.params.dt,
                                     v=pair_v_sums(pd_, pe_), ridge=sp_.coarse_ridge)
                     for pd_, pe_ in zip(pdK, peK)]
        else:
            parts = [build_two_level(b, self.g["nbr"], sp_.agg_size, sym=False,
                                     mass_diag=self.g["vol"] / self.params.dt,
                                     ridge=sp_.coarse_ridge)
                     for b in blocksK]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    def _emi_moment_W(self, sp_: SolverParams, host: bool = False):
        """Per-compartment moment deflation fields W (nw, nd, nc), built
        from the nodal coordinates as the device holds them (``host``: as
        numpy float64).  With ``emi_moment_order_ics`` above
        ``emi_moment_order``, each ICS compartment (one whose cells carry a
        nonzero subdomain tag) gets that order; ``emi_moment_axial`` adds
        the axial rows of elongated compartments (moment_vectors)."""
        nodes = self.g["nodes"].cpu().numpy().astype(np.float64)  # (nd, d, nc)
        coords = np.moveaxis(nodes, -1, 0)                         # (nc, nd, d)
        comp = self._comp_np
        order_per_comp = None
        if sp_.emi_moment_order_ics > sp_.emi_moment_order:
            # cell_tags are in the mesh's numbering, comp in the solver's
            # (the pair layout's padded, renumbered axis)
            tags = np.asarray(self.mesh.cell_tags)
            idx = getattr(self, "_cell_unpad_idx", None)
            comp_of_orig = comp[idx] if idx is not None else comp[: tags.shape[0]]
            order_per_comp = np.full(int(comp.max()) + 1, sp_.emi_moment_order, np.int64)
            for p in range(order_per_comp.shape[0]):
                sel = comp_of_orig == p
                if sel.any() and (tags[sel] != 0).any():
                    order_per_comp[p] = sp_.emi_moment_order_ics
        return moment_vectors(coords, comp, sp_.emi_moment_order, dtype=self.dtype,
                              device=self.device, order_per_comp=order_per_comp, host=host,
                              axial_order=sp_.emi_moment_axial)

    def _emi_moment_data(self, blocks, sp_: SolverParams):
        """Moment-deflation Galerkin data in the layout the solve applies
        it in (on pairs: the fields converted with to_pair)."""
        W = self._emi_moment_W(sp_)
        if isinstance(blocks, tuple):
            pd_, pe_ = blocks
            return build_moment_deflation(
                to_pair(self.pairs, W),
                fan=lambda X: pair_matvec_fan(pd_, pe_, self.pairs, X))
        return build_moment_deflation(
            W, fan=lambda X: bell_matvec_fan(blocks, self.g["nbr"], X))

    def _emi_moment_data_host(self, state, blocks, sp_: SolverParams):
        """Moment-deflation Galerkin in host float64 (``emi_moment_host``):
        W stays numpy and moment_galerkin_host runs on the cell blocks (on
        the pair layout freshly assembled ones: the live pair entries carry
        the same values), so the device holds one copy of the fields, the
        returned mom_W (on pairs converted with to_pair)."""
        pair = isinstance(blocks, tuple)
        blocks_c = self._assemble_emi_cell(state)[0] if pair else blocks
        W, inv, s = moment_galerkin_host(blocks_c, self.g["nbr"],
                                         self._emi_moment_W(sp_, host=True))
        W = self._tensor(W)
        return {"mom_W": to_pair(self.pairs, W) if pair else W,
                "mom_inv": self._tensor(inv), "mom_s": self._tensor(s)}

    def _pair_W_to_cell(self, W_pair):
        """pair -> cell conversion of harvested deflation fields, on the host
        (the consumer, ritz_galerkin_host, works in host float64)."""
        return from_pair_host(self.pairs_host, _np(W_pair))

    def _ritz_W_to_pair(self, W_cell):
        """cell -> pair conversion of host-built deflation fields."""
        return self._tensor(to_pair_host(self.pairs_host, _np(W_cell)))

    def _assemble_emi_cell(self, state):
        """The EMI cell-layout blocks, rhs and P_diag at ``state`` (on the
        pair layout: over the padded cell axis, for the Ritz Galerkin)."""
        phi_M_pad, _, I_ch_tot_pad = self._pads(state)
        return self._assemble_emi(state["c"], state["c_elim"], phi_M_pad,
                                  I_ch_tot_pad, state["t"])

    def _emi_ritz_data(self, state, blocks, rhs, Pd, data, sp_: SolverParams,
                       n_ritz: int):
        """Ritz deflation entries ('ritz_W', 'ritz_inv', 'ritz_s') harvested
        from the EMI operator at ``state`` with the preconditioner ``data``:
        a k-step preconditioned Lanczos (on the device, or in host float64
        with ``emi_ritz_host``), then the host float64 Galerkin on the cell
        blocks.  On the pair layout the device harvest runs with the
        production pair preconditioner (the pair_bj scope and the live
        mask) and the fields convert through the cell layout."""
        nbr = self.g["nbr"]
        # k = 40 up to the AUTO budget; larger budgets need k >= 2 n_ritz
        k = 40 if n_ritz <= 24 else 2 * n_ritz
        pair = self.pair_layout
        if sp_.emi_ritz_host:
            # the host harvest runs on CELL blocks in both layouts
            if pair:
                blocks_c, rhs_c, Pd_c = self._assemble_emi_cell(state)
                oh, ids = self._comp_arrays()
                data_c = build_two_level(
                    blocks_c, nbr, sp_.agg_size, sym=True, comp_onehot=oh,
                    comp_ids=ids, extra_diag=Pd_c - blocks_c[0],
                    ridge=sp_.coarse_ridge)
                if sp_.emi_moment_order > 0:
                    data_c.update(self._emi_moment_data(blocks_c, sp_))
            else:
                blocks_c, rhs_c, Pd_c, data_c = blocks, rhs, Pd, data
            W_h = ritz_lanczos_W_host(blocks_c, nbr, data_c, Pd_c, rhs_c,
                                      sp_.agg_size, k=k, n_ritz=n_ritz)
            ritz = ritz_galerkin_host(blocks_c, nbr, W_h, project_mean=True)
        elif pair:
            pd_, pe_ = blocks
            halves = sp_.pair_bj == "halves"
            Pd_b = Pd * self._pair_bj_halves if halves else Pd
            fn = two_level_apply_fn(data, Pd_b, sp_.agg_size // 2, halves=halves,
                                    buffer=True, mask=self._live_mask(Pd.dtype))
            W_pair = ritz_lanczos_W(
                None, None, fn, to_pair(self.pairs, rhs),
                k=k, n_ritz=n_ritz,
                matvec=lambda v: pair_matvec(pd_, pe_, self.pairs, v.contiguous()),
                mask=self._pair_mask)
            blocks_c = self._assemble_emi_cell(state)[0]
            ritz = ritz_galerkin_host(blocks_c, nbr, self._pair_W_to_cell(W_pair),
                                      project_mean=True)
        else:
            W = ritz_lanczos_W(blocks, nbr,
                               two_level_apply_fn(data, Pd, sp_.agg_size), rhs,
                               k=k, n_ritz=n_ritz)
            ritz = ritz_galerkin_host(blocks, nbr, W, project_mean=True)
        if pair:
            ritz["ritz_W"] = self._ritz_W_to_pair(ritz["ritz_W"])
        # a Galerkin of host (numpy) fields comes back in float32 on the
        # CPU (in float32 as in the JAX package); the solver applies it in
        # its own dtype on its device
        return {key: v.to(device=self.device, dtype=self.dtype)
                for key, v in ritz.items()}

    def _build_pc(self, state, sp_: SolverParams, reuse_ritz=None):
        """Frozen two-level coarse data for the EMI and the per-ion KNP
        operators at the given state: {'emi': data, 'knp': stacked data},
        or None when neither uses the two-level preconditioner, for an MMS
        problem (whose solves build theirs, _make_precond) and when both
        solves are direct.

        The EMI data takes the Ritz deflation entries ``reuse_ritz`` when
        given (a refresh), else harvests ``emi_ritz`` fields; -1 (AUTO) is
        24 on the cell layout and 0 on the pair layout."""
        if self.mms is not None or (sp_.direct_emi and sp_.direct_knp):
            return None
        n_ritz = (sp_.emi_ritz if sp_.emi_ritz >= 0
                  else (0 if self.pair_layout else 24))
        pc = {}
        phi_M_pad, I_ch_pad, I_ch_tot_pad = self._pads(state)
        if sp_.precond == "two_level" and not sp_.direct_emi:
            blocks, rhs, Pd = self._assemble_emi(state["c"], state["c_elim"],
                                                 phi_M_pad, I_ch_tot_pad, state["t"],
                                                 pair=self.pair_layout)
            comp_onehot, comp_ids = self._comp_arrays()
            if self.pair_layout:
                # coarse data over the pair axis: chunks of agg_size // 2
                # pairs (pairs never cross compartments by construction)
                cop0 = self.pairs["cop"][0]
                pc["emi"] = build_two_level(
                    None, pair_nbr(self.pairs), sp_.agg_size // 2, sym=True,
                    comp_onehot=comp_onehot[:, cop0], comp_ids=comp_ids[cop0],
                    extra_diag=Pd - blocks[0], v=pair_v_sums(*blocks),
                    ridge=sp_.coarse_ridge)
            else:
                pc["emi"] = build_two_level(
                    blocks, self.g["nbr"], sp_.agg_size, sym=True,
                    comp_onehot=comp_onehot, comp_ids=comp_ids,
                    extra_diag=Pd - blocks[0], ridge=sp_.coarse_ridge)
            if sp_.emi_moment_order > 0:
                pc["emi"].update(self._emi_moment_data_host(state, blocks, sp_)
                                 if sp_.emi_moment_host else
                                 self._emi_moment_data(blocks, sp_))
            if reuse_ritz:
                pc["emi"].update(reuse_ritz)
            elif n_ritz > 0:
                ritz = self._emi_ritz_data(state, blocks, rhs, Pd, pc["emi"], sp_,
                                           n_ritz)
                # the harvest is numerically fragile; a NaN would zero every
                # later solve's tolerance test, so drop it unless finite
                if all(bool(torch.isfinite(v).all()) for v in ritz.values()):
                    pc["emi"].update(ritz)
                else:
                    print(f"{bcolors.WARNING} emi_ritz harvest non-finite; "
                          f"disabled for this pc build {bcolors.ENDC}")
        if ((sp_.precond_knp or sp_.precond) == "two_level" and not sp_.direct_knp
                and not self._emi_only):
            blocksK, _ = self._knp_assemble_all(
                state["c"], state["c_elim"], state["phi"], phi_M_pad, I_ch_pad,
                I_ch_tot_pad, state["t"], state["c"])
            pc["knp"] = self._build_knp_pc(blocksK, sp_)
        return pc or None

    def _refresh_pc(self, state, sp_: SolverParams):
        """Rebuild the frozen preconditioner data at the current state.  The
        EMI Ritz harvest is not re-run (harvesting again mid-window is
        measured harmful in the JAX package): its entries ride through."""
        old = state.get("pc") or {}
        keep = {k: v for k, v in (old.get("emi") or {}).items()
                if k.startswith("ritz_")}
        state = {k: v for k, v in state.items() if k != "pc"}
        return self.attach_pc(state, sp_, reuse_ritz=keep or None)

    def attach_pc(self, state, sp_: SolverParams, reuse_ritz=None):
        """Attach frozen preconditioner data to a state (no-op if already
        present); ``reuse_ritz`` hands earlier Ritz entries to the build.
        Also caches the ion-stacked KNP static operator eagerly, so the
        static assembly never reruns inside a step."""
        _check_supported(sp_)
        if not self._emi_only:
            for k in range(self.N_ions):
                self._knp_static(k)
            cache = self._knp_static_blocks
            if -1 not in cache:
                cache[-1] = torch.stack([cache[k] for k in range(self.N_ions)])
            if self.pair_layout and -2 not in cache:
                # key -2: the pair-converted static operator, one conversion
                cache[-2] = cell_bell_to_pair(self.pairs, cache[-1])
        if "pc" in state:
            return state
        pc = self._build_pc(state, sp_, reuse_ritz=reuse_ritz)
        if pc is None:
            return state
        return dict(state, pc=pc)


class StandardSolver(Solver):
    """The `update_ode` of every shipped application: push the ECS trace of
    K and the ICS trace of Na into the membrane ODEs."""

    def __init__(self, *args, k_index=0, na_index=None, **kw):
        super().__init__(*args, **kw)
        self._k_index = k_index
        self._na_index = na_index  # None -> eliminated ion

    def update_ode(self, tag, traces: Traces):
        na = self._na_index if self._na_index is not None else len(self.ion_list) - 1
        return {
            "K_e": traces.plus(self._k_index),
            "Na_i": traces.minus(na),
        }


# ---------------------------------------------------------------------------
# state exchange with numpy (and through it with the JAX package)
# ---------------------------------------------------------------------------

_FIELDS = ("c", "c_elim", "phi", "phi_prev", "phi_M", "I_ch", "t")


def state_to_numpy(state) -> Dict[str, Any]:
    """Numpy copy of a solver state: the fields, the membrane states, params
    and model per tag, and the ``pc`` dict.  Works on any state whose leaves
    convert with ``np.asarray`` after moving to the host."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    out = {k: host(state[k]) for k in _FIELDS if k in state}
    out["mem"] = {tag: {"states": host(mm.states), "params": host(mm.params),
                        "model": mm.model}
                  for tag, mm in state.get("mem", {}).items()}
    if state.get("pc"):
        out["pc"] = {part: {k: host(v) for k, v in data.items()}
                     for part, data in state["pc"].items()}
    return out


def state_from_numpy(state_np, device, dtype, models=None) -> Dict[str, Any]:
    """Solver state on ``device`` in ``dtype`` from :func:`state_to_numpy`'s
    layout.  ``models`` (tag -> port model), when given, supplies the
    membrane models; otherwise each mem entry's own ``"model"`` is used."""
    def dev(v):
        return torch.as_tensor(np.array(v), dtype=dtype, device=device)

    out = {k: dev(state_np[k]) for k in _FIELDS if k in state_np}
    out["mem"] = {}
    for tag, entry in state_np.get("mem", {}).items():
        model = models[tag] if models is not None else entry["model"]
        out["mem"][tag] = MembraneState(states=dev(entry["states"]),
                                        params=dev(entry["params"]), model=model)
    if state_np.get("pc"):
        out["pc"] = {part: {k: dev(v) for k, v in data.items()}
                     for part, data in state_np["pc"].items()}
    return out
