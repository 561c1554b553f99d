"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, into ``_build/`` next to
this file; the library is loaded with ctypes.  Nothing here runs at import
time, so the package imports on machines without a card or a compiler.

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
SOURCES = ("bell_matvec.cu", "block_jacobi.cu", "membrane_rk4.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libknpemidg_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches counted by its wrapper
LAUNCHES = {"bell_matvec": 0, "block_jacobi_inverse": 0,
            "block_jacobi_apply": 0, "membrane_rk4": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C entry point (without the _f32/_f64 suffix) -> argument types
_SIGNATURES = {
    "knp_bell_matvec": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "knp_bj_inverse": (_P, _P, _I, _I, _I, _P),
    "knp_bj_apply": (_P, _P, _P, _I, _I, _I, _P),
    "knp_membrane_rk4": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _D, _I, _P),
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
    source; returns the seconds spent compiling (0.0 when up to date)."""
    with _lock:
        if not _stale():
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = LIB_PATH + f".tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp]
        cmd += [os.path.join(_CSRC, f) for f in SOURCES]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
        os.replace(tmp, LIB_PATH)
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


def launch(kernel: str, entry: str, dtype: torch.dtype, *args):
    """Call C entry point ``entry`` for ``dtype`` on the current stream,
    raise on a non-zero cudaGetLastError(), and count one launch of
    ``kernel``."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{kernel}: CUDA kernel takes float32/float64, got {dtype}")
    fn = getattr(lib(), entry + _SUFFIX[dtype])
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    LAUNCHES[kernel] += 1


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
