"""One run of one cell: set-up, the measured or traced window, the check
against the plain reference, and the result line.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json`` and its file ``fedbench/workloads/<cell>.json``, the
configuration file the entry names, the driver
``fedbench/drivers/<driver>.py`` the workload names, and one reader
``fedbench/metrics/<metric>.py`` for each per-layer metric.  A driver
module has a class ``Cell(config, workload, seed, device)`` with
``setup() -> readings``, ``measure(seconds) -> dict`` (its end-to-end
metrics, ``attempted``, ``failed``, ``info``), ``trace(path) ->
fedbench.trace.Trace``, ``release()`` and ``check(readings, device) ->
{"gaps": {...}}``; a metric module has ``read(trace) -> float | None``.

The last line of standard output is the result, and the last lines of
standard error are the numbers the check compared, each beside its limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

from fedbench import trace as trace_mod

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "fedbench"
#: build and kernel caches of the run, at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/fedbench/torch_extensions",
              "TRITON_CACHE_DIR": "build/fedbench/triton",
              "CUDA_CACHE_PATH": "build/fedbench/cuda"}
TRACE_PATH = ROOT / "build" / "fedbench" / "trace.json"
#: top-level modules that may not be loaded in the process that prints
#: the result: the JAX stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """A run that prints no result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``fedbench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no {kind[:-1]} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"fedbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str) -> dict:
    """The cell's entry, workload file, configuration file, and the
    metrics ``BENCHMARK.json`` lists for it."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise Refused(f"no cell {name!r} in BENCHMARK.json")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(ROOT / configs[entry["config"]]["file"])

    def listed(metrics):
        return [m for m in metrics
                if name in m.get("workloads", [name])]
    return {"entry": entry, "workload": workload, "config": config,
            "end_to_end": listed(spec["end_to_end"]),
            "per_layer": listed(spec["per_layer"])}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu,"
             "clocks_throttle_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run(cell: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", plant=None) -> dict:
    """One run; returns the result line's object.  ``device="cpu"`` drives
    a run without a card (the tests), and ``plant(driver_cell)`` may break
    the program under test first."""
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    spec = cell_spec(cell)
    wl, entry = spec["workload"], spec["entry"]
    import torch

    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise Refused("no CUDA device")
    if cuda and torch.cuda.device_count() < entry["chips"]:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell "
                      f"needs {entry['chips']}")
    driver = load_module("drivers", wl["driver"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    c = driver.Cell(spec["config"], wl, seed, device)
    if plant is not None:
        plant(c)
    readings = c.setup()
    setup_s = time.perf_counter() - t_start
    metrics, extra, breakdown = {}, {}, None
    if traced:
        tr = c.trace(TRACE_PATH)
        for m in spec["per_layer"]:
            value = load_module("metrics", m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted = len(tr.losses)
        failed = sum(not math.isfinite(x) for x in tr.losses)
        info = {"spans_ms": tr.spans, "round_s": tr.round_s,
                "capture_s": tr.capture_s,
                "kernels": len(tr.kernels), "losses": tr.losses}
        extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        breakdown = trace_mod.breakdown(tr)
        del tr
    else:
        window = c.measure(seconds)
        attempted, failed = window.pop("attempted"), window.pop("failed")
        info = window.pop("info")
        window["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    info["nvidia_smi"] = nvidia_smi() if cuda else None
    if not traced:
        window["peak_mem_gb"] = peak / 1e9
        for m in spec["end_to_end"]:
            if m["name"] not in window:
                raise Refused(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": window[m["name"]],
                                  "unit": m["unit"]}
    c.release()
    t_check = time.perf_counter()
    checked = c.check(readings, device)
    info["check_s"] = time.perf_counter() - t_check
    info["setup_s"] = setup_s
    checks = {k: {"value": checked["gaps"][k], "limit": v}
              for k, v in wl["limits"].items()}
    correct = failed == 0 and all(
        math.isfinite(x["value"]) and x["value"] <= x["limit"]
        for x in checks.values())
    emit({"info": info, "readings": readings, "check": checked})
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": entry["chips"], "memory_peak_bytes": int(peak), **extra}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start)
    except Refused as e:
        print(f"fedbench: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"fedbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    emit(result)
    return 0
