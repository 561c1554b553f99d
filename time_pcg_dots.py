#!/usr/bin/env python3
"""Time K8's two reduction entries, pcg_dot and pcg_dot2, as the solver
calls them: on one work built once per solve, at chip_smoke.py's EMI vector
shapes (cell (4, 124416), pair (8, 63558)), in float32 and float64, beside
the library calls chip_smoke.py holds them to (torch.dot, torch.mv on the
stacked pair).

The package is imported from ``--root`` (default: this file's directory),
so the same measurement reads another tree, such as an unpacked parent
commit, in the same call: run it for parent, change, change, parent.  A
tree whose krylov_ops has no ``pcg_work`` gets a work built by hand (its
wrappers allocate their workspace per call).  The dots do not read the
projection mask, so both layouts run with the mean projection (mode 1).

Per entry it prints the median of 20 CUDA-event timings of one call
(``ms``, the yardstick of chip_smoke.py), the host microseconds per call
of a loop of 1,000 calls closed by one synchronise (``loop_us``), and the
device microseconds per call of 100 calls replayed as one CUDA graph
(``graph_us``: the kernels and the gaps between them, no host).
It also prints the cost of reading the current stream both ways.

Usage:  python3 time_pcg_dots.py [--root DIR]      (needs a CUDA card)
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

SHAPES = {"cell": (4, 124416), "pair": (8, 63558)}
LOOP = 1000


def cuda_ms(fn, reps=20):
    """Median milliseconds of one fn() by CUDA events, warmed up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_us(fn, calls=LOOP):
    """Host microseconds per call of ``calls`` back-to-back calls closed by
    one synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def graph_us(fn, calls=100, replays=5):
    """Device microseconds per call with the host out of the way: ``calls``
    calls captured in one CUDA graph, its replay timed by CUDA events
    (median of ``replays``); None where the call cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as exc:
        print(f"k8time  not captured: {exc}".splitlines()[0])
        return None
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return 1e3 * statistics.median(times) / calls


def stream_lookup_us(calls=100000):
    """Microseconds per read of the current stream's handle: through a
    stream object, and as the raw handle."""
    out = {}
    reads = {"current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream}
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        reads["_cuda_getCurrentRawStream"] = lambda: raw(torch._C._cuda_getDevice())
    for name, fn in reads.items():
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t0) / calls
    if raw is not None:
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            same = raw(torch._C._cuda_getDevice()) == s.cuda_stream
        out["raw handle follows torch.cuda.stream"] = same
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_pcg_dots.py needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from knpemidg_tpu_torch import _cuda
    from knpemidg_tpu_torch.ops import krylov_ops as ko

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    factory = hasattr(ko, "pcg_work")
    print(f"k8time  root {root}  package {os.path.dirname(ko.__file__)}  pcg_work {factory}")
    print(f"k8time  gpu {card}  torch {torch.__version__}")
    print(f"k8time  build {_cuda.build():.2f} s")
    for name, v in stream_lookup_us().items():
        print(f"k8time  stream {name}: {v if isinstance(v, bool) else f'{v:.3f} us'}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)
    for layout, shape in SHAPES.items():
        for dtype in (torch.float32, torch.float64):
            r, z, p, Ap = (torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                           for _ in range(4))
            n = r.numel()
            wsum = torch.tensor(float(n), dtype=dtype, device=dev)
            zero = torch.zeros_like(wsum)
            sc = torch.stack([(r * z).sum(), (z * z).sum(), zero, zero, zero, wsum])
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            wk = (ko.pcg_work(sc, flag, None, 1, n) if factory
                  else ko.PcgWork(sc=sc, flag=flag, w=None, mode=1))
            stack = torch.stack([r.view(-1), z.view(-1)])
            calls = {"pcg_dot": lambda: ko.pcg_dot(p, Ap, wk),
                     "pcg_dot2": lambda: ko.pcg_dot2(r, z, wk),
                     "torch.dot": lambda: torch.dot(p.view(-1), Ap.view(-1)),
                     "torch.mv": lambda: torch.mv(stack, z.view(-1))}
            for name, fn in calls.items():
                g = graph_us(fn)
                print(f"k8time  {layout} {str(dtype):14s} {name:10s} ms {cuda_ms(fn):.4f}  "
                      f"loop_us {loop_us(fn):.2f}  graph_us "
                      + ("not measured" if g is None else f"{g:.2f}"))


if __name__ == "__main__":
    main()
