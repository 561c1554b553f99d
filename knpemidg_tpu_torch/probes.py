"""Gather probes P1 and P2 (``csrc/gather_probe.cu``): the counterpart of
tools/profile_shapes.py's Pallas gathers (b) ``pgather`` and (b2)
``pgather2``, a microbenchmark of the access pattern of K1's neighbour
gather.

  pgather(idx, xsrc)   out = xsrc[idx]: idx (4, 238, 512) int32 into a
                       (121,856,) source;
  pgather2(idx, xs)    out[r, c] = xs[r, idx[r, c]]: (8, 121,856) int32 and
                       source.

Each wrapper runs its plain version (``xsrc[idx]``,
``torch.take_along_dim``) for CPU tensors and launches its kernel for CUDA
tensors.  The inputs come from a seeded numpy generator.

Usage (times both probes on the card):

    python -m knpemidg_tpu_torch.probes [--dtype float32|float64]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _cuda

NCP = 121856          # the probe's padded cell count (238 * 512)
P1_IDX_SHAPE = (4, NCP // 512, 512)
P2_SHAPE = (8, NCP)


def make_inputs(seed: int = 0, dtype=torch.float32, device="cuda"):
    """(idx1, xsrc, idx2, xs2) at the probe's shapes: int32 indices
    uniform over the source, normal values."""
    rng = np.random.default_rng(seed)
    idx1 = rng.integers(0, NCP, size=P1_IDX_SHAPE).astype(np.int32)
    xsrc = rng.normal(size=(NCP,))
    xs2 = rng.normal(size=P2_SHAPE)
    idx2 = rng.integers(0, NCP, size=P2_SHAPE).astype(np.int32)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return t(idx1, torch.int32), t(xsrc, dtype), t(idx2, torch.int32), t(xs2, dtype)


def pgather_plain(idx, xsrc):
    return xsrc[idx]


def pgather2_plain(idx, xs):
    return torch.take_along_dim(xs, idx.long(), 1)


def pgather(idx, xsrc):
    """out = xsrc[idx] (P1)."""
    if not xsrc.is_cuda:
        return pgather_plain(idx, xsrc)
    _cuda.check("idx", idx, torch.int32)
    _cuda.check("xsrc", xsrc)
    if xsrc.dim() != 1:
        raise ValueError("pgather: expected a 1-D source")
    out = torch.empty(idx.shape, dtype=xsrc.dtype, device=xsrc.device)
    _cuda.launch("pgather", "knp_pgather", xsrc.dtype, idx.data_ptr(), xsrc.data_ptr(),
                 out.data_ptr(), idx.numel())
    return out


def pgather2(idx, xs):
    """out[r, c] = xs[r, idx[r, c]] (P2)."""
    if not xs.is_cuda:
        return pgather2_plain(idx, xs)
    _cuda.check("xs", xs)
    if xs.dim() != 2:
        raise ValueError("pgather2: expected a 2-D source")
    _cuda.check("idx", idx, torch.int32, xs.shape)
    out = torch.empty_like(xs)
    _cuda.launch("pgather2", "knp_pgather2", xs.dtype, idx.data_ptr(), xs.data_ptr(),
                 out.data_ptr(), xs.shape[0], xs.shape[1])
    return out


def run(dtype=torch.float32, reps=50, seed=0):
    """Both probes on the card at their shapes, as tools/profile_shapes.py
    runs them: checked against the plain gathers, then the median of
    ``reps`` CUDA-event timings with the effective bandwidth (an int32
    index read and a value written per output).  Returns {name: (max |err|,
    ms, GB/s)}."""
    idx1, xsrc, idx2, xs2 = make_inputs(seed, dtype, "cuda")
    out = {}
    for name, fn, plain, args in (("pgather", pgather, pgather_plain, (idx1, xsrc)),
                                  ("pgather2", pgather2, pgather2_plain, (idx2, xs2))):
        err = float((fn(*args) - plain(*args)).abs().max())
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = float(np.median(times))
        nbytes = args[0].numel() * (4 + args[1].element_size())
        out[name] = (err, ms, nbytes / ms / 1e6)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probes needs a CUDA card")
    for name, (err, ms, gbs) in run(getattr(torch, args.dtype)).items():
        print(f"{name:9s} {args.dtype}: max |err| {err:.1e}, {ms:.4f} ms, {gbs:.1f} GB/s")


if __name__ == "__main__":
    main()
