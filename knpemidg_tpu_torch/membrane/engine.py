"""Membrane ODE engine (torch port of knpemidg_tpu/membrane/engine.py).

Fixed-substep integration of the per-point membrane ODEs, all points at
once.  Kernel C (``csrc/membrane_rk4.cu``) carries a step on CUDA tensors:
one launch for every membrane tag of a :class:`TagTable`, every substep in
registers, a lane a point (the Hodgkin-Huxley model: a group of 8 lanes a
point, its six gating rates on six of them).  It reads the solver's pushes
(V, the Nernst potentials, ``update_ode``'s values) where they lie and
writes the new states and parameters, V into the new ``phi_M`` and the
channel currents into ``I_ch``.  A model without gating states runs RK4
under ``"rush_larsen"``, the gated Hodgkin-Huxley model Rush-Larsen.  The
plain torch versions (:func:`ode_step_plain`, :func:`ode_step_tags_plain`)
are what runs for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# the tag table: every tag of a step in one launch
# ---------------------------------------------------------------------------

# csrc/membrane_rk4.cu: tags a launch takes, parameter slots, ions and the
# block kinds (0: no device function); the launcher lays out the blocks
MAX_TAGS, MAX_PARAMS, MAX_IONS = 8, len(CUDA_PARAMS), 4
KIND_HH_RK4, KIND_HH_RL, KIND_GLIAL_RK4 = 1, 2, 3


class _Tag(ctypes.Structure):
    """csrc/membrane_rk4.cu MembraneTag."""
    _fields_ = [("states", ctypes.c_void_p), ("params", ctypes.c_void_p),
                ("states_out", ctypes.c_void_p), ("params_out", ctypes.c_void_p),
                ("v_src", ctypes.c_void_p), ("src", ctypes.c_void_p * MAX_PARAMS),
                ("kind", ctypes.c_int), ("stim", ctypes.c_int), ("n", ctypes.c_int),
                ("s0", ctypes.c_int), ("n_states", ctypes.c_int),
                ("n_params", ctypes.c_int), ("ich_slot", ctypes.c_int * MAX_IONS)]


class _Table(ctypes.Structure):
    """csrc/membrane_rk4.cu MembraneTable."""
    _fields_ = [("phi_M", ctypes.c_void_p), ("I_ch", ctypes.c_void_p),
                ("n_tags", ctypes.c_int), ("n_ions", ctypes.c_int), ("n_mem", ctypes.c_int),
                ("tag", _Tag * MAX_TAGS)]


@dataclasses.dataclass(frozen=True)
class TagEntry:
    """The static part of one tag's entry: its membrane slice
    ``[s0, s0 + n)``, model, block kind (0 with ``refusal`` the reason when
    the model has no device function under the scheme) and, per ion of the
    solver, the parameter slots of ``I_ch_<ion>`` (-1: the ion's I_ch is 0)
    and of ``E_<ion>`` (-1: the model takes no Nernst potential of it)."""

    s0: int
    n: int
    model: Any
    kind: int
    refusal: str
    ich_slot: Tuple[int, ...]
    nernst_slot: Tuple[int, ...]


@dataclasses.dataclass
class TagTable:
    """The static part of a step over every tag (built once): the entries
    in step order, the membrane size they cover, the ion count, the scheme
    and, for the kernel, one ctypes table per MAX_TAGS entries with every
    field but the pointers filled in."""

    entries: Tuple[TagEntry, ...]
    n_mem: int
    n_ions: int
    scheme: str
    chunks: Tuple[_Table, ...]


@dataclasses.dataclass
class TagPush:
    """One tag's pushes of a step: V and parameter slot -> a source
    ``(tensor, offset)``, the values ``tensor.view(-1)[offset:offset + n]``
    of a contiguous tensor of the state's dtype and device."""

    v: Optional[Tuple[torch.Tensor, int]] = None
    params: Dict[int, Tuple[torch.Tensor, int]] = dataclasses.field(default_factory=dict)


def _kind(model, scheme):
    """(block kind, refusal) of a model under a scheme."""
    mid = getattr(model, "cuda_model_id", 0)
    names = tuple(model.PARAMS)
    states = tuple(model.STATES)
    if mid == 0 or names != CUDA_PARAMS[:len(names)] or states[-1:] != ("V",):
        return 0, f"{model.name}: no CUDA right-hand side for this membrane model"
    gating = model.gating_indices() if scheme == "rush_larsen" else ()
    if gating and gating != (0, 1, 2):
        return 0, f"{model.name}: the Rush-Larsen kernel gates states 0-2 (m, h, n)"
    kind = {(1, False): KIND_HH_RK4, (1, True): KIND_HH_RL,
            (2, False): KIND_GLIAL_RK4}.get((mid, bool(gating)), 0)
    return kind, "" if kind else f"{model.name}: no CUDA kernel for scheme {scheme!r}"


def tag_table(models: Sequence[Tuple[Any, int, int]], n_mem: int,
              ion_names: Sequence[str] = (), scheme: str = "rk4") -> TagTable:
    """The static table of a step over tags given as (model, s0, n) in step
    order; their slices must cover [0, n_mem) exactly, as the solver's
    membrane tables do (fem/tabulation.py), so the pulls write every point."""
    spans = sorted((s0, s0 + n) for _, s0, n in models)
    if spans[0][0] != 0 or spans[-1][1] != n_mem or any(
            a[1] != b[0] for a, b in zip(spans, spans[1:])):
        raise ValueError(f"the tags' membrane slices {spans} do not cover [0, {n_mem})")
    entries = []
    for model, s0, n in models:
        kind, refusal = _kind(model, scheme)
        slots = lambda fmt: tuple(model.PARAMS.get(fmt.format(ion), -1) for ion in ion_names)
        entries.append(TagEntry(s0=s0, n=n, model=model, kind=kind, refusal=refusal,
                                ich_slot=slots("I_ch_{}"), nernst_slot=slots("E_{}")))
    chunks = []
    if all(e.kind for e in entries) and len(ion_names) <= MAX_IONS:
        for c in range(0, len(entries), MAX_TAGS):
            tab = _Table(n_ions=len(ion_names), n_mem=n_mem)
            for j, e in enumerate(entries[c:c + MAX_TAGS]):
                tag = tab.tag[j]
                tag.kind, tag.n, tag.s0 = e.kind, e.n, e.s0
                tag.stim = int(bool(getattr(e.model, "stimulus", False)))
                tag.n_states, tag.n_params = len(e.model.STATES), len(e.model.PARAMS)
                tag.ich_slot[:len(ion_names)] = e.ich_slot
                tab.n_tags = j + 1
            chunks.append(tab)
    return TagTable(entries=tuple(entries), n_mem=n_mem, n_ions=len(ion_names),
                    scheme=scheme, chunks=tuple(chunks))


def push_source(values, n: int, like: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A pushed value as a source: a contiguous 1-D tensor of ``n`` values of
    ``like``'s dtype and device (``values`` itself where it is one; a
    scalar broadcasts, as in :func:`set_param`)."""
    v = torch.as_tensor(values, dtype=like.dtype, device=like.device)
    if v.shape != (n,):
        v = v.expand(n)
    if not v.is_contiguous():
        v = v.contiguous()
    return v, 0


def _values(src, n):
    t, off = src
    return t.view(-1)[off:off + n]


def apply_push(mm: MembraneState, push: TagPush) -> MembraneState:
    """The tag's state with its pushes applied, as new tensors (what
    replace_state for V and set_param per parameter give)."""
    n = mm.states.shape[1]
    if push.v is not None:
        mm = mm.replace_state("V", _values(push.v, n))
    if push.params:
        params = mm.params.clone()
        for slot, src in push.params.items():
            params[slot] = _values(src, n)
        mm = dataclasses.replace(mm, params=params)
    return mm


def ode_step_tags_plain(table: TagTable, mems: Sequence[MembraneState],
                        pushes: Sequence[TagPush], t, dt: float, n_sub: int):
    """Plain twin of :func:`ode_step_tags`: per tag the pushes, the step,
    and the pulls into a new phi_M and I_ch."""
    like = mems[0].states
    phi_M = torch.empty(table.n_mem, dtype=like.dtype, device=like.device)
    I_ch = torch.zeros((table.n_ions, table.n_mem), dtype=like.dtype, device=like.device)
    out = []
    for e, mm, push in zip(table.entries, mems, pushes):
        mm = ode_step_plain(apply_push(mm, push), t, dt, n_sub, scheme=table.scheme)
        phi_M[e.s0:e.s0 + e.n] = mm.get_state("V")
        for k, slot in enumerate(e.ich_slot):
            if slot >= 0:
                I_ch[k, e.s0:e.s0 + e.n] = mm.params[slot]
        out.append(mm)
    return out, phi_M, I_ch


def _ptr(src, itemsize):
    t, off = src
    return t.data_ptr() + off * itemsize


def _step_tags_cuda(table: TagTable, mems, pushes, t, dt, n_sub):
    """Kernel C over every tag: one launch per MAX_TAGS tags.  Fills the
    pointers of the static table and returns (new states, phi_M, I_ch)."""
    refused = next((e.refusal for e in table.entries if not e.kind), None)
    if refused:
        raise NotImplementedError(refused)
    if table.n_ions > MAX_IONS:
        raise NotImplementedError(f"the ODE kernel takes at most {MAX_IONS} ions")
    like = mems[0].states
    dtype, dev = like.dtype, like.device
    t_dev = _as_time(t, like)
    phi_M = torch.empty(table.n_mem, dtype=dtype, device=dev)
    I_ch = torch.empty((table.n_ions, table.n_mem), dtype=dtype, device=dev)
    size, out = ctypes.sizeof(_Table), []
    for c, tab in enumerate(table.chunks):
        tab.phi_M, tab.I_ch = phi_M.data_ptr(), I_ch.data_ptr()
        lo = c * MAX_TAGS
        rl = False
        for j, (e, mm, push) in enumerate(zip(table.entries[lo:lo + MAX_TAGS],
                                              mems[lo:lo + MAX_TAGS],
                                              pushes[lo:lo + MAX_TAGS])):
            y, p = mm.states, mm.params
            _cuda.check("states", y, dtype, (len(e.model.STATES), e.n))
            _cuda.check("params", p, dtype, (len(e.model.PARAMS), e.n))
            y_out, p_out = torch.empty_like(y), torch.empty_like(p)
            item = y.element_size()
            tag = tab.tag[j]
            tag.states, tag.params = y.data_ptr(), p.data_ptr()
            tag.states_out, tag.params_out = y_out.data_ptr(), p_out.data_ptr()
            tag.v_src = None if push.v is None else _ptr(push.v, item)
            for k in range(MAX_PARAMS):
                src = push.params.get(k)
                tag.src[k] = None if src is None else _ptr(src, item)
            out.append(MembraneState(y_out, p_out, mm.model))
            rl = rl or e.kind == KIND_HH_RL
        _cuda.launch("membrane_rl" if rl else "membrane_rk4", "knp_membrane_step", dtype,
                     ctypes.addressof(tab), size, t_dev.data_ptr(), float(dt), int(n_sub))
    return out, phi_M, I_ch


def check_sources(table: TagTable, pushes: Sequence[TagPush], like: torch.Tensor):
    """Raise unless every source of ``pushes`` is a contiguous tensor of
    ``like``'s dtype and device holding the tag's points (what the kernel
    reads through its pointer)."""
    dtype, dev = like.dtype, like.get_device()
    for e, push in zip(table.entries, pushes):
        srcs = ([push.v] if push.v is not None else []) + list(push.params.values())
        for t, off in srcs:
            if (t.dtype != dtype or t.get_device() != dev or not t.is_contiguous()
                    or off < 0 or off + e.n > t.numel()):
                raise ValueError("an ODE push source is not a contiguous tensor of the "
                                 "state's dtype and device holding the tag's points")


def ode_step_tags(table: TagTable, mems: Sequence[MembraneState],
                  pushes: Sequence[TagPush], t, dt: float, n_sub: int):
    """One PDE step of every tag's membrane ODEs with the step's pushes:
    (new states in table order, new phi_M, new I_ch).  Kernel C, one
    launch for up to MAX_TAGS tags, on CUDA tensors; the plain twin on CPU
    tensors.  The input states are left as they were."""
    check_sources(table, pushes, mems[0].states)
    if not mems[0].states.is_cuda:
        return ode_step_tags_plain(table, mems, pushes, t, dt, n_sub)
    return _step_tags_cuda(table, mems, pushes, t, dt, n_sub)


def ode_step(mm: MembraneState, t, dt: float, n_sub: int,
             scheme: str = "rk4") -> MembraneState:
    """One PDE step of one tag's membrane ODEs: a one-tag launch of kernel
    C on CUDA tensors, the plain version on CPU tensors.  As in the plain
    version, a model without gating states runs RK4 under
    ``"rush_larsen"``."""
    if not mm.states.is_cuda:
        return ode_step_plain(mm, t, dt, n_sub, scheme=scheme)
    n = mm.states.shape[1]
    table = tag_table([(mm.model, 0, n)], n, scheme=scheme)
    return _step_tags_cuda(table, [mm], [TagPush()], t, dt, n_sub)[0][0]
