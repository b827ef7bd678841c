"""Fig. 10 (extension): population scaling -- sampled K-cohorts over large M.

Two series through :mod:`repro_torch.population`, the sampled-cohort
engine:

* ``full``    -- the paper's fixed-total-dataset regime (Fig. 6's x-axis,
  K == M): growing M at constant M*B splits the same pool thinner; the OTA
  sum still aligns all M gradients, so accuracy must not degrade.
* ``sampled`` -- the population regime: a fixed K-device cohort sampled
  per round from M = 10^2 .. 10^4+ devices over a fixed pool, banked
  error-feedback state (capacity < M).  The cohort sees the same K
  gradients whatever M is, so accuracy must be flat in M (the
  tolerance-banded gate) -- population size costs memory O(capacity * d),
  not convergence.

Both gates are asserted at the end; a violation exits non-zero.  Writes
``BENCH_torch_population.json`` with the device's name and power limit:
``population_us_per_round`` is the per-round cost of a warm
``CompiledPopulation.run`` at the largest M, ``compiled_cold_*`` the first
call's.

Run:  python -m repro_torch.benchmarks.fig10_scaling
      SMOKE=1 python -m repro_torch.benchmarks.fig10_scaling
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from repro_torch.benchmarks.common import REPO_ROOT

OUT_PATH = os.path.join(REPO_ROOT, "BENCH_torch_population.json")

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
FULL = bool(int(os.environ.get("FULL", "0")))

#: accuracy tolerance bands for the scaling gates (SMOKE runs are short and
#: small, so the bands are loose there; the claim is "no degradation", not
#: "strict improvement" -- seed noise at reduced scale is a few points)
TOL_FULL = 0.06 if SMOKE else 0.04
TOL_SAMPLED = 0.06 if SMOKE else 0.04


def spec():
    if SMOKE:
        return dict(m_full=(5, 10), total=2000, m_sampled=(100, 10_000),
                    k=32, b=32, steps=12, capacity=2048)
    if FULL:
        return dict(m_full=(5, 10, 25), total=25_000,
                    m_sampled=(100, 1000, 10_000, 100_000), k=64, b=64,
                    steps=100, capacity=8192)
    return dict(m_full=(5, 10, 20), total=4000,
                m_sampled=(100, 1000, 10_000), k=32, b=32, steps=30,
                capacity=4096)


def main(collect: Optional[list] = None, out_path: str = OUT_PATH,
         device=None) -> Dict:
    from repro_torch.benchmarks.common import (
        SCALE, clock, dataset, device_info, emit, ota,
    )
    from repro_torch.data import synthetic
    from repro_torch.data.partition import population_partition
    from repro_torch.device import resolve_device
    from repro_torch.experiments.engine import round_keys
    from repro_torch.population import (
        CompiledPopulation, PopulationConfig, PopulationData,
        PopulationExperiment, run_population,
    )

    dev = resolve_device(device)
    sp = spec()
    steps = sp["steps"]
    eval_every = max(1, min(SCALE.eval_every, steps // 3))
    rows, summary = [], []
    results: Dict = {**device_info(dev), "smoke": SMOKE, "rounds": steps}

    # --- full participation at fixed M*B: the paper's device axis ---------
    cfg_full = ota("a_dsgd", total_steps=steps, p_avg=1.0)
    full_acc: Dict[int, float] = {}
    for m in sp["m_full"]:
        (xd, yd), test = dataset(iid=True, m=m, b=sp["total"] // m)
        pop = PopulationConfig(m_total=m, k_cohort=m)
        run = run_population(PopulationData.from_dense(xd, yd, device=dev),
                             *test, cfg_full, pop, steps=steps, lr=SCALE.lr,
                             eval_every=eval_every, device=dev)
        full_acc[m] = run.accs[-1]
        for i, acc in enumerate(run.accs):
            step = min(i * eval_every, steps - 1)
            rows.append(f"fig10,full_M{m},{step},{acc:.4f}")
        summary.append((f"fig10_full_M{m}", 0.0, run.accs[-1]))
        results[f"full_acc_M{m}"] = round(run.accs[-1], 4)

    # --- sampled K-cohort over a fixed pool: the population axis ----------
    cfg = ota("a_dsgd", total_steps=steps)
    (xtr, ytr), (xte, yte) = synthetic.make_classification(
        n_train=SCALE.n_train, n_test=SCALE.n_test, noise=SCALE.noise,
        seed=3)
    sampled_acc: Dict[int, float] = {}
    timing_cp = None
    for m in sp["m_sampled"]:
        part = population_partition(ytr, m=m, b=sp["b"], kind="iid", seed=0)
        pdata = PopulationData.from_pool(xtr, ytr, part, device=dev)
        pop = PopulationConfig(m_total=m, k_cohort=sp["k"],
                               capacity=min(sp["capacity"], m))
        run = run_population(pdata, xte, yte, cfg, pop, steps=steps,
                             lr=SCALE.lr, eval_every=eval_every, device=dev)
        sampled_acc[m] = run.accs[-1]
        for i, acc in enumerate(run.accs):
            step = min(i * eval_every, steps - 1)
            rows.append(f"fig10,sampled_M{m},{step},{acc:.4f}")
        summary.append((f"fig10_sampled_M{m}", 0.0, run.accs[-1]))
        results[f"sampled_acc_M{m}"] = round(run.accs[-1], 4)
        if m == max(sp["m_sampled"]):
            timing_cp = CompiledPopulation(
                pdata, xte, yte,
                PopulationExperiment(cfg=cfg, pop=pop, steps=steps,
                                     lr=SCALE.lr, eval_every=eval_every),
                device=dev)

    # --- timing: the population loop at the largest M, first call and warm -
    keys = round_keys(steps, device=dev)
    t0 = clock(dev)
    timing_cp.run({}, keys)
    cold_s = clock(dev) - t0
    t0 = clock(dev)
    timing_cp.run({}, keys)
    steady_s = clock(dev) - t0
    results["compiled_cold_s"] = round(cold_s, 3)
    results["population_s"] = round(steady_s, 3)
    results["compiled_cold_us_per_round"] = round(cold_s / steps * 1e6, 1)
    results["population_us_per_round"] = round(steady_s / steps * 1e6, 1)
    m_big = max(sp["m_sampled"])
    banks = timing_cp.pstate0.banks
    results["state_bytes_banked"] = int(banks.deltas.nbytes)
    results["state_bytes_dense_equiv"] = int(m_big * timing_cp.d * 4)
    print(f"  population (M={m_big}, K={sp['k']}): "
          f"{results['population_us_per_round']:.1f} us/round steady, "
          f"banked state {banks.deltas.nbytes / 1e6:.1f} MB vs "
          f"{m_big * timing_cp.d * 4 / 1e6:.1f} MB dense", flush=True)
    if collect is not None:
        collect.append(("fig10/population",
                        results["population_us_per_round"],
                        sampled_acc[m_big]))
        collect.extend(summary)

    emit(rows)

    # --- the scaling gates -------------------------------------------------
    ms = sorted(full_acc)
    ok_full = full_acc[ms[-1]] >= full_acc[ms[0]] - TOL_FULL
    print(f"gate full:    acc(M={ms[-1]}) = {full_acc[ms[-1]]:.4f} >= "
          f"acc(M={ms[0]}) - {TOL_FULL} = {full_acc[ms[0]] - TOL_FULL:.4f} "
          f"-> {'ok' if ok_full else 'FAILED'}")
    ms = sorted(sampled_acc)
    ok_sampled = sampled_acc[ms[-1]] >= sampled_acc[ms[0]] - TOL_SAMPLED
    print(f"gate sampled: acc(M={ms[-1]}) = {sampled_acc[ms[-1]]:.4f} >= "
          f"acc(M={ms[0]}) - {TOL_SAMPLED} = "
          f"{sampled_acc[ms[0]] - TOL_SAMPLED:.4f} "
          f"-> {'ok' if ok_sampled else 'FAILED'}")

    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")
    print(f"wrote {out_path}")
    if not (ok_full and ok_sampled):
        raise SystemExit("fig10 scaling gate failed")
    return results


if __name__ == "__main__":
    main()
