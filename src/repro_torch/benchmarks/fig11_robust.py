"""Fig. 11 (beyond the paper): Byzantine robustness of the OTA schemes.

Sweeps the persistent Byzantine fraction (``repro_torch.robust.faults``)
against the matching defence on each transport:

* **D-DSGD** -- plain-sum aggregation vs the median-relative norm cap
  (``aggregator="norm_cap"``).  Coordinate-wise trimming is not the
  digital defence: D-DSGD frames are top-k sparse, the signal sits at the
  extreme ranks per coordinate, and a trim discards exactly that; the
  per-frame norm cap leaves sparse supports intact while flattening the
  attacker's ``byz_scale`` boost.
* **A-DSGD** -- unconstrained transmitters vs the transmit-side power cap
  (``clip_power=True``).  ``make_frame`` normalises honest frames to P_t,
  so an analog attacker's only leverage is violating the power constraint;
  the cap at ``power_cap * P_t`` removes it and costs honest devices
  nothing.

The Byzantine grid and the seed replicas are one batched group per
(scheme, defence) combination -- ``byzantine_frac`` is a
``ROBUST_VMAP_AXES`` member, and the membership draw is nested in the
fraction, so the curves are paired.

Asserts (exit non-zero on violation):

* plain A-DSGD collapses at >= 10% Byzantine devices while the
  power-capped run retains accuracy;
* norm-capped D-DSGD beats plain-sum D-DSGD by a margin at the highest
  swept fraction and retains most of its clean accuracy at 10%.

``SMOKE=1`` shrinks rounds and seeds; ``FULL=1`` (common) restores the
paper-scale M, B, T.

Run:  SMOKE=1 python -m repro_torch.benchmarks.fig11_robust
"""
import os

from repro_torch.benchmarks.common import SCALE, dataset, emit, seed_mean

SMOKE = bool(int(os.environ.get("SMOKE", "0")))

#: Byzantine fractions on the batched axis (0.0 = the paired clean run)
BYZ_FRACS = (0.0, 0.1, 0.3)
#: attacker amplitude: sign_flip at this scale collapses undefended runs
BYZ_SCALE = 20.0
#: digital norm cap, in multiples of the median live-frame norm
NORM_CAP = 1.5
#: analog transmit power cap, in multiples of P_t
POWER_CAP = 1.5
#: seed replicas averaged per grid point (the Byzantine set comes from the
#: run-level fault key, so it is common across the seed replicas)
SEEDS = (0, 1) if SMOKE else (0, 1, 2)


def _sweep(dev, test, base, axes, steps, device):
    from repro_torch.experiments import run_sweep

    return run_sweep(dev, test, base, axes, steps=steps, lr=SCALE.lr,
                     eval_every=SCALE.eval_every, device=device)


def main(collect=None, device=None):
    from repro_torch.benchmarks.common import ota

    steps = 16 if SMOKE else SCALE.steps
    dev, test = dataset(iid=True)
    rows, summary = [], []
    finals = {}  # series -> {frac: seed-averaged final accuracy}

    def series_rows(series, res, static_key, static_val):
        finals[series] = {}
        for frac in BYZ_FRACS:
            recs = [r for r in res.records
                    if r["byzantine_frac"] == frac
                    and r[static_key] == static_val]
            mean_accs, us = seed_mean(recs)
            for i, acc in enumerate(mean_accs):
                step = min(i * SCALE.eval_every, steps - 1)
                rows.append(f"fig11,{series}_b{frac},{step},{acc:.4f}")
            finals[series][frac] = mean_accs[-1]
            summary.append((f"fig11_{series}_b{frac}", us, mean_accs[-1]))

    kw = dict(total_steps=steps, byz_scale=BYZ_SCALE)
    axes = {"byzantine_frac": list(BYZ_FRACS), "seed": list(SEEDS)}

    res = _sweep(dev, test, ota("d_dsgd", **kw, norm_cap=NORM_CAP),
                 {"aggregator": ["mean", "norm_cap"], **axes}, steps, device)
    series_rows("d_dsgd_plain", res, "aggregator", "mean")
    series_rows("d_dsgd_normcap", res, "aggregator", "norm_cap")

    res = _sweep(dev, test, ota("a_dsgd", **kw, power_cap=POWER_CAP),
                 {"clip_power": [False, True], **axes}, steps, device)
    series_rows("a_dsgd_plain", res, "clip_power", False)
    series_rows("a_dsgd_powercap", res, "clip_power", True)

    emit(rows)
    hi = max(BYZ_FRACS)
    a_plain, a_cap = finals["a_dsgd_plain"], finals["a_dsgd_powercap"]
    d_plain, d_cap = finals["d_dsgd_plain"], finals["d_dsgd_normcap"]
    print(f"# a_dsgd @10%: plain {a_plain[0.1]:.4f} vs powercap "
          f"{a_cap[0.1]:.4f} (clean {a_plain[0.0]:.4f})")
    print(f"# d_dsgd @{hi:.0%}: plain {d_plain[hi]:.4f} vs normcap "
          f"{d_cap[hi]:.4f} (clean {d_plain[0.0]:.4f})")

    # --- the robustness claims this figure pins --------------------------
    checks = {
        # plain analog collapses under a 10% power-boosting attacker...
        "a_dsgd_plain_collapses": a_plain[0.1] <= 0.5 * a_plain[0.0],
        # ...while the power cap retains most of the clean accuracy
        "a_dsgd_powercap_retains": a_cap[0.1] >= 0.8 * a_cap[0.0],
        "a_dsgd_powercap_beats_plain": a_cap[0.1] >= a_plain[0.1] + 0.25,
        # the digital norm cap beats the plain sum where it degrades most
        "d_dsgd_normcap_beats_plain": d_cap[hi] >= d_plain[hi] + 0.10,
        "d_dsgd_normcap_retains": d_cap[0.1] >= 0.8 * d_cap[0.0],
    }
    for name, ok in checks.items():
        print(f"# fig11 {name}={ok}")
    if not all(checks.values()):
        bad = [k for k, v in checks.items() if not v]
        raise SystemExit(f"fig11: robustness gates failed: {bad}")
    if collect is not None:
        collect.extend(summary)
    return summary


if __name__ == "__main__":
    main()
