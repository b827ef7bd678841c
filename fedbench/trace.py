"""The device trace of a run: capture with ``torch.profiler`` and reduction
to what the per-layer metrics read.

A traced window runs under the profiler (host and CUDA activities).  The
trace is exported as Chrome JSON inside the checkout, read back and
deleted.  What the metrics read:

* ``kernels``: every CUDA kernel as ``(name, start_us, end_us)``;
* ``ops``: kernels, memory copies and fills, the device's busy intervals;
* ``annotations``: the host spans the harness opened with
  ``record_function`` (``fedbench.round``, ``fedbench.grads``, ...).

Kernel names fall into three classes, frozen here: the port's own CUDA
kernels, the libraries' matrix-product and attention kernels, and every
other kernel (elementwise passes, reductions, sorts, RNG draws).
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

#: the port's hand-written kernels, by the name of their __global__
PORT_KERNELS = ("ef_sparsify_kernel", "ota_project_kernel",
                "ota_project_t_kernel", "amp_fused_kernel")
#: substrings of the matrix-product and attention kernels of cuBLAS,
#: cuBLASLt, CUTLASS and cuDNN
LIBRARY_PATTERNS = ("gemm", "gemv", "cutlass", "cublas", "xmma", "nvjet",
                    "splitk", "sm80_", "sm90_", "flash", "fmha", "cudnn")
#: the host spans' prefix, and the span a gap outside every named one is
#: charged to
SPAN_PREFIX = "fedbench."

Interval = Tuple[str, float, float]


def kernel_class(name: str) -> str:
    """``port``, ``library`` or ``other``."""
    if any(k in name for k in PORT_KERNELS):
        return "port"
    low = name.lower()
    if any(p in low for p in LIBRARY_PATTERNS):
        return "library"
    return "other"


def port_kernel(name: str) -> Optional[str]:
    """The port kernel a trace name belongs to (no kernel's name holds
    another's: ``ota_project_kernel`` is not in ``ota_project_t_kernel``)."""
    return next((k for k in PORT_KERNELS if k in name), None)


@dataclasses.dataclass
class Trace:
    """One traced window, as the metric readers see it: ``rounds`` rounds
    under the profiler, and ``spans`` (ms on CUDA events) and ``round_s``
    (host clock) of as many rounds run without it."""
    rounds: int
    kernels: List[Interval]
    ops: List[Interval]
    annotations: List[Interval]
    spans: Dict[str, List[float]]
    round_s: float
    shapes: dict
    config: dict
    losses: List[float] = dataclasses.field(default_factory=list)
    capture_s: float = 0.0       # the profiled round, export and read-back

    @property
    def window(self) -> Tuple[float, float]:
        """The traced window on the trace's clock: the first to the last
        ``fedbench.round`` span (each ends once the device is done)."""
        rounds = [a for a in self.annotations
                  if a[0] == SPAN_PREFIX + "round"]
        return min(a[1] for a in rounds), max(a[2] for a in rounds)

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) * 1e-6

    def busy_s(self) -> float:
        lo, hi = self.window
        return sum(e - s for s, e in merged(self.ops, lo, hi)) * 1e-6

    def kernel_s(self, name: str) -> Tuple[int, float]:
        """Launches and device seconds of one of the port's kernels."""
        ks = [e - s for n, s, e in self.kernels if port_kernel(n) == name]
        return len(ks), sum(ks) * 1e-6


def merged(intervals: List[Interval], lo: float,
           hi: float) -> List[Tuple[float, float]]:
    """The union of the intervals, clipped to ``[lo, hi]``, in order."""
    out: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps labelled by the host span they began in."""
    totals: Dict[str, float] = {}
    for name, s, e in tr.ops:
        key = name[:96]
        totals[key] = totals.get(key, 0.0) + (e - s) * 1e-6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    lo, hi = tr.window
    busy = merged(tr.ops, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    spans = [a for a in tr.annotations if a[0] != SPAN_PREFIX + "round"]

    def label(t: float) -> str:
        inner = [a for a in spans if a[1] <= t < a[2]]
        if not inner:
            return "round"
        return min(inner, key=lambda a: a[2] - a[1])[0][len(SPAN_PREFIX):]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[label(s), (e - s) * 1e-6] for s, e in longest]}


def capture(fn, path: Path):
    """Run ``fn()`` under the profiler; return its result and the trace's
    ``(kernels, ops, annotations)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        out = fn()
        torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    del prof
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    kernels, ops, notes = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        iv = (ev.get("name", ""), float(ev["ts"]),
              float(ev["ts"]) + float(ev.get("dur", 0.0)))
        if cat == "kernel":
            kernels.append(iv)
            ops.append(iv)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            ops.append(iv)
        elif cat == "user_annotation" and iv[0].startswith(SPAN_PREFIX):
            notes.append(iv)
    return out, kernels, ops, notes
