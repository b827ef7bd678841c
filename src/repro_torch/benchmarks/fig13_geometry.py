"""Fig. 13 (beyond the paper): cell geometry and subband scheduling.

The paper's channel model is distance-free.  This figure grounds it in a
cell (``repro_torch.core.geometry``): devices drop area-uniformly in a disk
of radius R around the base station, and a normalised power law
``(d/d0)^-gamma`` scales each device's received-power factor on top of the
small-scale Rayleigh fading.

Panel A -- cell size: the same A-DSGD run at growing R.  Shrinking
large-scale gains lower every device's effective SNR, so final accuracy
must degrade monotonically in R (the gate).  At R = d0 = 100 m the power
law is neutral; each 4x radius step costs ~18 dB at gamma = 3.

Panel B -- subband scheduling: bandwidth split into S subbands, a
registered scheduler (``repro_torch.core.scheduling``) picking which S of
the M devices transmit each round, at a fixed moderate radius.  With few
subbands the max-SNR policy (``gain_ranked``) must retain at least the
gains-blind cycle (``round_robin``) -- the gate; ``prop_fair`` rides along
ungated.

``cell_radius`` / ``n_subbands`` are batched scalars, ``scheduler`` a
static axis (one runner per policy).  Timings land in
``BENCH_torch_geometry.json`` with the device's name and power limit.

Run:  SMOKE=1 python -m repro_torch.benchmarks.fig13_geometry
"""
import json
import os

from repro_torch.benchmarks.common import (
    REPO_ROOT, SCALE, dataset, emit, seed_mean,
)

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
OUT_PATH = os.path.join(REPO_ROOT, "BENCH_torch_geometry.json")

#: panel A radii (meters): d0-neutral, then two 4x steps (~18 dB each at
#: gamma = 3) -- spans boost, paper-like, and power-starved regimes
RADII = (100.0, 400.0, 1600.0)
PATH_LOSS_EXP = 3.0
#: panel B: moderate radius (links weakened but decodable) and a small
#: subband budget, where the scheduling policy actually bites
RADIUS_B = 800.0
N_SUBBANDS = 2
SCHEDULERS = ("round_robin", "gain_ranked", "prop_fair")
#: accuracy tolerance on the ordering gates (seed-averaged finals)
TOL = 0.02
#: seed replicas averaged per grid point
SEEDS = (0, 1) if SMOKE else (0, 1, 2)


def _series_rows(rows, fig, series, mean_accs, steps):
    for i, acc in enumerate(mean_accs):
        step = min(i * SCALE.eval_every, steps - 1)
        rows.append(f"{fig},{series},{step},{acc:.4f}")


def main(collect=None, out_path: str = OUT_PATH, device=None):
    from repro_torch.benchmarks.common import device_info, ota
    from repro_torch.device import resolve_device
    from repro_torch.experiments import run_sweep

    device = resolve_device(device)
    steps = 16 if SMOKE else SCALE.steps
    dev, test = dataset()
    rows, summary, bench = [], [], {
        **device_info(device),
        "smoke": SMOKE,
        "radii": list(RADII),
        "n_subbands": N_SUBBANDS,
    }

    # --- panel A: accuracy vs cell radius (no scheduler) -----------------
    base = ota("a_dsgd", total_steps=steps, fading="rayleigh",
               geometry="disk", path_loss_exp=PATH_LOSS_EXP)
    res = run_sweep(dev, test, base,
                    {"cell_radius": list(RADII), "seed": list(SEEDS)},
                    steps=steps, lr=SCALE.lr, eval_every=SCALE.eval_every,
                    device=device)
    radius_final = {}
    for radius in RADII:
        mean_accs, us = seed_mean(
            [r for r in res.records if r["cell_radius"] == radius])
        name = f"fig13_R{int(radius)}"
        _series_rows(rows, "fig13", f"R{int(radius)}", mean_accs, steps)
        radius_final[radius] = mean_accs[-1]
        summary.append((name, us, mean_accs[-1]))
        bench[f"{name}_us_per_round"] = round(us / steps, 1)
        bench[f"{name}_final_acc"] = round(mean_accs[-1], 4)

    # --- panel B: scheduler policies at a small subband budget -----------
    sched_final = {}
    for sched in SCHEDULERS:
        base = ota("a_dsgd", total_steps=steps, fading="rayleigh",
                   geometry="disk", cell_radius=RADIUS_B,
                   path_loss_exp=PATH_LOSS_EXP, scheduler=sched,
                   n_subbands=N_SUBBANDS)
        res = run_sweep(dev, test, base, {"seed": list(SEEDS)},
                        steps=steps, lr=SCALE.lr,
                        eval_every=SCALE.eval_every, device=device)
        mean_accs, us = seed_mean(res.records)
        name = f"fig13_{sched}_S{N_SUBBANDS}"
        _series_rows(rows, "fig13", f"{sched}_S{N_SUBBANDS}", mean_accs,
                     steps)
        sched_final[sched] = mean_accs[-1]
        summary.append((name, us, mean_accs[-1]))
        bench[f"{name}_us_per_round"] = round(us / steps, 1)
        bench[f"{name}_final_acc"] = round(mean_accs[-1], 4)

    emit(rows)
    print("# fig13 radius finals: " + "  ".join(
        f"R{int(r)}={radius_final[r]:.4f}" for r in RADII))
    print("# fig13 scheduler finals @S=%d: " % N_SUBBANDS + "  ".join(
        f"{s}={sched_final[s]:.4f}" for s in SCHEDULERS))

    # --- the geometry/scheduling claims this figure pins -----------------
    checks = {}
    ordered = [radius_final[r] for r in RADII]
    checks["radius_monotone_degradation"] = all(
        ordered[i] >= ordered[i + 1] - TOL for i in range(len(ordered) - 1))
    checks["radius_actually_bites"] = ordered[0] > ordered[-1] + TOL
    checks["gain_ranked_beats_round_robin"] = (
        sched_final["gain_ranked"] >= sched_final["round_robin"] - TOL)
    checks["schedulers_above_chance"] = all(
        f > 0.15 for f in sched_final.values())
    for name, ok in checks.items():
        print(f"# fig13 {name}={ok}")
    if not all(checks.values()):
        bad = [k for k, v in checks.items() if not v]
        raise SystemExit(f"fig13: geometry gates failed: {bad}")

    with open(out_path, "w") as fh:
        json.dump(bench, fh, indent=2)
        fh.write("\n")
    print(f"# wrote {out_path}")
    if collect is not None:
        collect.extend(summary)
    return summary


if __name__ == "__main__":
    main()
