"""Kernel micro-benchmarks: blocked projection forward and adjoint, and the
whole AMP decode, each on its plain path and on its CUDA kernel.

The port of the reference's ``benchmarks/bench_kernels.py``.  Per size and
op it times the plain torch path (``use_kernel=False``) and the kernel
path (``use_kernel=True``) on the same tensors, and writes
``BENCH_torch_kernels.json`` at the repository's root in the schema of
``BENCH_kernels.json`` (``entries`` keyed by size, op and path), so that
``benchmarks/check_regression.py`` reads it unchanged; the file also names
the device and its power limit.

Before it is timed, every kernel output is held against its plain output
at the repo's bars -- ``ota_project`` rtol = atol = 3e-5,
``ota_project_t`` bitwise (Rademacher entries), the fused AMP decode rtol
1e-4 / atol 1e-5 -- and each kernel call must launch its kernel exactly
once on the card; a miss raises.  On the card each call is timed between
two CUDA events (the median of ``reps`` calls after ``warmup``); on the
CPU, where the kernel path takes the plain version, by the host's clock.

Sizes: ``SIZES_FULL`` on the card, ``SIZES_SMOKE`` on the CPU or with
``SMOKE=1``.

Run:  python -m repro_torch.benchmarks.bench_kernels
"""
from __future__ import annotations

import json
import os
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.benchmarks.common import REPO_ROOT

OUT_PATH = os.path.join(REPO_ROOT, "BENCH_torch_kernels.json")
SMOKE = bool(int(os.environ.get("SMOKE", "0")))

#: (name, n_blocks, c, s_block, amp_iters)
SIZES_SMOKE = [
    ("tiny", 4, 128, 32, 4),
    ("small", 16, 256, 64, 8),
]
SIZES_FULL = [
    ("medium", 64, 1024, 256, 10),
    ("large", 256, 4096, 1024, 20),
]
#: the kernel behind each op's kernel path
KERNEL_OF = {"proj_fwd": "ota_project", "proj_adj": "ota_project_t",
             "amp_decode": "amp_fused"}
#: (rtol, atol) of each op's kernel against its plain path; 0, 0: bitwise
BARS = {"proj_fwd": (3e-5, 3e-5), "proj_adj": (0.0, 0.0),
        "amp_decode": (1e-4, 1e-5)}
SEED = 7
#: untimed and timed calls of each op and path; a kernel path's calls and
#: its check launch its kernel ``1 + WARMUP + REPS`` times per size
WARMUP, REPS = 2, 10


def inputs(n_blocks: int, c: int, s_block: int, device):
    """The benchmark's inputs: x (n_blocks, c) for the forward projection
    and y (n_blocks, s_block) for the adjoint and the decode, standard
    normal from fixed seeds on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    x = torch.randn(n_blocks, c, generator=gen, device=device)
    gen.manual_seed(2)
    yb = torch.randn(n_blocks, s_block, generator=gen, device=device)
    return x, yb


def op_calls(x: torch.Tensor, yb: torch.Tensor, c: int, s_block: int,
             iters: int, use_kernel: bool) -> Dict[str, Callable]:
    """Each op as a call with no arguments, on one path."""
    from repro_torch.core.amp import amp_blocked_core
    from repro_torch.kernels import ops

    return {
        "proj_fwd": lambda: ops.ota_project(
            x, seed=SEED, s_block=s_block, rademacher=True,
            use_kernel=use_kernel),
        "proj_adj": lambda: ops.ota_project_t(
            yb, seed=SEED, c=c, rademacher=True, use_kernel=use_kernel),
        "amp_decode": lambda: amp_blocked_core(
            yb, SEED, c, iters=iters, chunk_blocks=8,
            use_kernel=use_kernel),
    }


def time_us(fn: Callable, device, warmup: int = WARMUP,
            reps: int = REPS) -> float:
    """Microseconds per call of ``fn()``: on the card the median of
    ``reps`` calls, each between two CUDA events; on the CPU the mean of
    ``reps`` calls on the host's clock."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def _kernel_launches(fn: Callable):
    """``fn()`` and the launches of each kernel it made."""
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    out = fn()
    after = ops.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def check_op(op: str, kernel_fn: Callable, plain_fn: Callable,
             device) -> Dict:
    """The kernel path's output against the plain path's at the op's bar,
    and its launches: one of the op's kernel on the card, none on the CPU.
    Raises on a miss; returns the max abs error and the launches."""
    want = plain_fn()
    out, launches = _kernel_launches(kernel_fn)
    expect = {k: 0 for k in launches}
    if device.type == "cuda":
        expect[KERNEL_OF[op]] = 1
    if launches != expect:
        raise RuntimeError(f"bench_kernels {op}: launches {launches}, "
                           f"expected {expect}")
    rtol, atol = BARS[op]
    ok = (torch.equal(out, want) if rtol == atol == 0.0
          else torch.allclose(out, want, rtol=rtol, atol=atol))
    err = float((out - want).abs().max())
    if not ok:
        raise RuntimeError(f"bench_kernels {op}: kernel path off its plain "
                           f"path (max abs err {err}; bar rtol={rtol} "
                           f"atol={atol})")
    return {"max_abs_err": err, "launches": launches[KERNEL_OF[op]]}


def bench_size(name: str, n_blocks: int, c: int, s_block: int,
               iters: int, device) -> List[Dict]:
    x, yb = inputs(n_blocks, c, s_block, device)
    plain = op_calls(x, yb, c, s_block, iters, use_kernel=False)
    kernel = op_calls(x, yb, c, s_block, iters, use_kernel=True)
    checks = {op: check_op(op, kernel[op], plain[op], device)
              for op in KERNEL_OF}
    entries = []
    for path, calls in (("plain", plain), ("kernel", kernel)):
        for op, fn in calls.items():
            us = time_us(fn, device)
            entry = {"size": name, "n_blocks": n_blocks, "c": c,
                     "s_block": s_block, "amp_iters": iters, "op": op,
                     "path": path, "us_per_call": round(us, 1)}
            if path == "kernel":
                entry.update(checks[op])
            entries.append(entry)
            print(f"  {name:8s} {op:10s} {path:6s} {us:10.1f} us/call",
                  flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return entries


def main(collect: Optional[list] = None, out_path: str = OUT_PATH,
         device=None) -> Dict:
    from repro_torch.benchmarks.common import device_info
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    smoke = SMOKE or dev.type != "cuda"
    sizes = SIZES_SMOKE if smoke else SIZES_FULL
    results = {**device_info(dev), "interpret": False, "smoke": smoke,
               "entries": []}
    for spec in sizes:
        results["entries"].extend(bench_size(*spec, device=dev))
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")
    print(f"wrote {out_path}")
    if collect is not None:
        for e in results["entries"]:
            if e["op"] == "amp_decode":
                collect.append((f"kernels/{e['size']}/{e['path']}",
                                e["us_per_call"], "amp_decode"))
    return results


if __name__ == "__main__":
    main()
