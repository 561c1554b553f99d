"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a``, one compiler process
per source, all started together, and linked into one shared library with a
plain C interface, at first use, into ``_build/`` next to this file; the
library is loaded with ctypes.  Nothing here runs at import time, so the
package imports on machines without a card or a compiler.

Every kernel wrapper adds one to its entry of :data:`LAUNCHES` where it
launches, and nowhere else, so a run can show which kernels its main path
went through.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
SOURCES = ("bell_matvec.cu", "block_jacobi.cu", "membrane_rk4.cu",
           "pair_matvec.cu", "pair_relayout.cu", "pair_emit.cu", "two_level.cu",
           "assemble_emi.cu", "assemble_knp.cu", "membrane_trace.cu", "gmres.cu",
           "pcg.cu", "gather_probe.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libknpemidg_kernels.so")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
# the assembly emit kernels equal their plain versions exactly, which a
# fused multiply-add (one rounding where torch makes two) would break; the
# Krylov kernels round their updates and Givens arithmetic as the plain
# versions do
SOURCE_FLAGS = {f: ("-fmad=false",) for f in ("assemble_emi.cu", "assemble_knp.cu",
                                               "gmres.cu", "pcg.cu")}

# kernel name -> launches counted by its wrapper: one a wrapper call that
# launches on the card, however many kernels the call runs (knp_facet's
# call is two: its scalars and its sweep; knp_membrane_emit's, the KNP
# assembly's membrane rhs and emit, is two: the sweep and the membrane
# cells' rhs rows); the block-Jacobi kernels count their cell-layout
# (nd = 4), 2D (nd = 3) and pair-layout (nd = 8) instantiations apart, the
# matvec and the two-level restrict and prolong their 2D ones ("_nd3"),
# and the two-level kernels their single EMI (K6) and batched KNP (K7, "_batched") calls ("coarse": the one-launch apply of operands
# without deflation fields or As, K7's on the main path).  The assembly
# kernels (K10 emi_*, K11 alpha_sum and
# knp_*, K14 membrane_trace and eliminated_concentration), the Krylov
# kernels (K8 pcg_*, K9 gmres_*: gmres_arnoldi is a whole Arnoldi step)
# serve both layouts; K13's one launch for every tag counts as membrane_rl
# when a tag of it runs Rush-Larsen, else as membrane_rk4, and its ode_run
# launch (many steps of one tag) as membrane_run; pgather /
# pgather2 are the gather probes P1 / P2
LAUNCHES = {"bell_matvec": 0, "block_jacobi_inverse": 0,
            "block_jacobi_apply": 0, "membrane_rk4": 0, "membrane_rl": 0,
            "membrane_run": 0,
            "pair_matvec": 0, "to_pair": 0, "from_pair": 0,
            "gather_blocks_pair": 0, "block_jacobi_inverse_nd8": 0,
            "block_jacobi_apply_nd8": 0, "bell_matvec_nd3": 0,
            "block_jacobi_inverse_nd3": 0, "block_jacobi_apply_nd3": 0,
            **{f"two_level_{e}{b}": 0 for b in ("", "_batched")
               for e in ("restrict", "solve", "prolong", "coarse")},
            **{f"two_level_{e}{b}_nd3": 0 for b in ("", "_batched")
               for e in ("restrict", "prolong")},
            "emi_cell": 0, "emi_facet": 0, "emi_emit_cell": 0, "alpha_sum": 0,
            "knp_cell": 0, "knp_facet": 0, "knp_membrane_emit": 0, "membrane_trace": 0,
            "eliminated_concentration": 0,
            **{f"pcg_{e}": 0 for e in ("dot", "update", "dot2_direction")},
            **{f"gmres_{e}": 0 for e in ("start", "cgs_dot", "arnoldi", "solve_update")},
            "pgather": 0, "pgather2": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C entry point (without the _f32/_f64 suffix) -> argument types
_SIGNATURES = {
    "knp_bell_matvec": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "knp_bj_inverse": (_P, _P, _I, _I, _I, _P),
    "knp_bj_apply": (_P, _P, _P, _I, _I, _I, _I, _P),
    "knp_membrane_step": (_P, _I, _P, _D, _I, _P),
    "knp_membrane_run": (_P, _I, _D, _D, _I, ctypes.c_longlong, _P),
    "knp_pair_matvec": (_P,) * 6 + (_I,) * 4 + (_P,),
    "knp_to_pair": (_P,) * 6 + (_I,) * 4 + (_P,),
    "knp_from_pair": (_P,) * 4 + (_I,) * 3 + (_P,),
    "knp_pair_emit": (_P,) * 12 + (_I,) * 5 + (_D, _P),
    "knp_tl_restrict": (_P,) * 8 + (_I,) * 10 + (_P,),
    "knp_tl_fields_prepare": (_I,),
    "knp_tl_solve_prepare": (_P,),
    "knp_tl_solve": (_P,) * 4,
    "knp_tl_prolong": (_P,) * 8 + (_I,) * 8 + (_P,),
    "knp_tl_coarse_prepare": (_P, _I, _I, _P),
    "knp_tl_coarse": (_P,) * 5 + (_I,) * 5 + (_P,),
    "knp_emi_cell": (_P,) * 10 + (_I,) * 4 + (_D, _D, _P),
    "knp_emi_facet": (_P,) * 26 + (_I,) * 5 + (_D, _D, _D, _P),
    "knp_emi_emit_cell": (_P,) * 15 + (_I,) * 5 + (_D, _P),
    "knp_alpha_sum": (_P,) * 4 + (_I,) * 3 + (_P,),
    "knp_ion_cell": (_P,) * 8 + (_I,) * 4 + (_D, _P),
    "knp_ion_facet": (_P,) * 17 + (_I,) * 5 + (_D, _P),
    "knp_membrane_emit": (_P,) * 20 + (_I,) * 3 + (_D,) * 3 + (_P,),
    "knp_membrane_trace": (_P,) * 4 + (_D,) * 4 + (_I,) + (_P,) * 6 + (_I,) * 6 + (_P,),
    "knp_eliminated": (_P,) * 4 + (_I,) * 3 + (_D, _P),
    "knp_gmres_dot": (_P,) * 4 + (_I,) * 5 + (_P,),
    "knp_gmres_start": (_P,) * 11 + (_I,) * 6 + (_P,),
    "knp_gmres_arnoldi_grid": (_I,) * 3 + (_P,),
    "knp_gmres_arnoldi": (_P,) * 13 + (_I,) * 7 + (_P,),
    "knp_gmres_solve_update": (_P,) * 6 + (_I,) * 3 + (_P,),
    "knp_pcg_dot": (_P,) * 5 + (_I,) * 2 + (_P,),
    "knp_pcg_update": (_P,) * 7 + (_I,) * 3 + (_P,),
    "knp_pcg_dot2_direction_grid": (_I, _I, _P),
    "knp_pcg_dot2_direction": (_P,) * 6 + (_I,) * 2 + (_P,),
    "knp_pgather": (_P,) * 3 + (_I,) + (_P,),
    "knp_pgather2": (_P,) * 3 + (_I,) * 2 + (_P,),
}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    t_lib = os.path.getmtime(LIB_PATH)
    srcs = [os.path.join(_CSRC, f) for f in SOURCES + ("common.cuh",)]
    return any(os.path.getmtime(s) > t_lib for s in srcs)


def build() -> float:
    """Compile the kernels if the library is missing or older than a
    source; returns the seconds spent compiling (0.0 when up to date).
    Each source compiles in its own nvcc process, all at once; the objects
    are then linked into the library."""
    with _lock:
        if not _stale():
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        tag = f".tmp{os.getpid()}"
        objs = [os.path.join(BUILD_DIR, os.path.splitext(f)[0] + tag + ".o")
                for f in SOURCES]
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, *SOURCE_FLAGS.get(f, ()), "-c",
                 os.path.join(_CSRC, f), "-o", o],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for f, o in zip(SOURCES, objs)]
            failed = []
            for f, proc in zip(SOURCES, procs):
                out, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{f}:\n{out}{err}")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            tmp = LIB_PATH + tag
            proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc link failed:\n" + proc.stdout + proc.stderr)
            os.replace(tmp, LIB_PATH)
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
        return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        build()
        with _lock:
            if _lib is None:
                handle = ctypes.CDLL(LIB_PATH)
                for name, args in _SIGNATURES.items():
                    for sfx in ("_f32", "_f64"):
                        fn = getattr(handle, name + sfx)
                        fn.argtypes = list(args)
                        fn.restype = ctypes.c_int
                _lib = handle
    return _lib


_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
_FNS = {}                 # (entry, dtype) -> the library's C function


def _resolve(kernel: str, entry: str, dtype: torch.dtype):
    if dtype not in _SUFFIX:
        raise TypeError(f"{kernel}: CUDA kernel takes float32/float64, got {dtype}")
    fn = _FNS[(entry, dtype)] = getattr(lib(), entry + _SUFFIX[dtype])
    return fn


def launch(kernel: str, entry: str, dtype: torch.dtype, *args):
    """Call C entry point ``entry`` for ``dtype`` on the current stream of
    the current device, raise on a non-zero cudaGetLastError(), and count
    one launch of ``kernel``.  The C function is looked up once per entry
    and dtype; the stream is read as its raw handle, without building a
    stream object."""
    fn = _FNS.get((entry, dtype)) or _resolve(kernel, entry, dtype)
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()))
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    LAUNCHES[kernel] += 1


def call(entry: str, dtype: torch.dtype, *args):
    """Call C entry point ``entry`` for ``dtype`` that launches nothing (a
    set-up helper) and raise on a non-zero return."""
    fn = _FNS.get((entry, dtype)) or _resolve(entry, entry, dtype)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{entry}: failed with CUDA error {rc}")


def check(name: str, t: torch.Tensor, dtype=None, shape=None):
    """Validate a tensor handed to a kernel: on a CUDA device, contiguous,
    of the expected dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
