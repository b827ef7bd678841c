"""Sweep-engine benchmark: looped runs per grid point vs one batched grid.

The port of the reference's ``benchmarks/bench_sweeps.py``.  The same
A-DSGD P-bar grid runs three ways, and ``BENCH_torch_sweeps.json`` at the
repository's root gets the times in the schema of ``BENCH_sweeps.json``
(plus the device's name and power limit):

* ``looped``          -- ``run_federated`` per grid point: one round per
                         loop iteration, evaluations on the host between
                         rounds.
* ``compiled_cold``   -- ``run_sweep``: the grid's points as one batched
                         round per step, its first call included.
* ``compiled_steady`` -- a warm ``CompiledExperiment.run_grid`` over the
                         same points.

The looped and batched runs must reach the same final accuracies
(``max_final_acc_deviation == 0``), and the warm grid the sweep's; a
difference raises.  Every clock read on the card follows a synchronise.

``SMOKE=1`` shrinks to 2 grid points x 3 rounds; the default keeps the
figure-scale model (d = 7850) on a 4-point grid of 10 rounds; ``FULL=1``
runs 50 rounds.

Run:  python -m repro_torch.benchmarks.bench_sweeps
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

from repro_torch.benchmarks.common import REPO_ROOT

OUT_PATH = os.path.join(REPO_ROOT, "BENCH_torch_sweeps.json")

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
FULL = bool(int(os.environ.get("FULL", "0")))


def grid_spec():
    if SMOKE:
        return [200.0, 1000.0], 3
    if FULL:
        return [50.0, 200.0, 500.0, 1000.0], 50
    return [50.0, 200.0, 500.0, 1000.0], 10


def main(collect: Optional[list] = None, out_path: str = OUT_PATH,
         device=None) -> Dict:
    from repro_torch.benchmarks.common import (
        SCALE, clock, dataset, device_info, ota, run_series,
    )
    from repro_torch.device import resolve_device
    from repro_torch.experiments import (
        CompiledExperiment, Experiment, eval_indices, run_sweep,
    )
    from repro_torch.experiments.sweep import grid_inputs

    dev = resolve_device(device)
    p_grid, steps = grid_spec()
    data, test = dataset(iid=True)
    base = ota("a_dsgd", total_steps=steps)
    n_points = len(p_grid)

    # --- looped reference: run_federated, per grid point -------------------
    t0 = clock(dev)
    looped_final = []
    for p in p_grid:
        cfg = dataclasses.replace(base, p_avg=p)
        r = run_series("bench_sweeps", f"a_dsgd_P{int(p)}", data, test, cfg,
                       steps=steps, device=dev)
        looped_final.append(r["final_acc"])
    looped_s = clock(dev) - t0

    # --- the sweep, cold: its first call, runner construction included -----
    t0 = clock(dev)
    res = run_sweep(data, test, base, {"p_avg": p_grid}, steps=steps,
                    lr=SCALE.lr, eval_every=SCALE.eval_every, device=dev)
    compiled_cold_s = clock(dev) - t0

    # --- steady: a warm run_grid over the same points ----------------------
    exp = Experiment(cfg=base, steps=steps, lr=SCALE.lr,
                     eval_every=SCALE.eval_every)
    ce = CompiledExperiment(*data, *test, exp, device=dev)
    overrides, keys, _ = grid_inputs(ce, [{"p_avg": p} for p in p_grid],
                                     steps)
    ce.run_grid(overrides, keys)                              # warm it
    t0 = clock(dev)
    out = ce.run_grid(overrides, keys)
    compiled_steady_s = clock(dev) - t0

    # engine == loop, point for point
    compiled_final = [r["final_acc"] for r in res.records]
    max_dev = max(abs(a - b) for a, b in zip(looped_final, compiled_final))
    steady_final = out["acc"][:, eval_indices(steps, SCALE.eval_every)[-1]]
    if max_dev != 0.0 or steady_final.tolist() != compiled_final:
        raise RuntimeError(
            f"bench_sweeps: final accuracies differ: looped {looped_final}, "
            f"sweep {compiled_final}, warm grid {steady_final.tolist()}")

    results = {
        **device_info(dev),
        "smoke": SMOKE,
        "grid_points": n_points,
        "rounds": steps,
        "looped_s": round(looped_s, 3),
        "compiled_cold_s": round(compiled_cold_s, 3),
        "compiled_steady_s": round(compiled_steady_s, 3),
        "speedup_cold": round(looped_s / max(compiled_cold_s, 1e-9), 2),
        "speedup_steady": round(looped_s / max(compiled_steady_s, 1e-9), 2),
        "max_final_acc_deviation": float(max_dev),
        "final_accs": compiled_final,
    }
    for name in ("looped", "compiled_cold", "compiled_steady"):
        us = results[f"{name}_s"] / (n_points * steps) * 1e6
        results[f"{name}_us_per_round"] = round(us, 1)
        print(f"  {name:16s} {results[name + '_s']:8.2f} s total"
              f"  {us:10.1f} us/round", flush=True)
        if collect is not None:
            collect.append((f"sweeps/{name}", us,
                            results["speedup_steady"]))
    print(f"  max |looped - compiled| final acc: {max_dev:.2e}")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")
    print(f"wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
