"""Fig. 9 (beyond the paper): the channel-realism axis of the fading suite.

The qualitative trend of the fading follow-ups (Amiri & Gunduz,
arXiv:1907.09769; Amiri, Duman & Gunduz, arXiv:1907.03909) on the
deterministic surrogate: A-DSGD accuracy under

* ``perfect``   -- truncated channel inversion with perfect CSI
                   (``a_dsgd_fading``),
* ``csi_err``   -- inversion driven by a noisy estimate
                   (``a_dsgd_csi_err``; the whole ``csi_err_var`` grid and
                   the seed replicas are one batched group), and
* ``blind``     -- no CSI at the transmitters, K-antenna PS combining
                   (``a_dsgd_blind``),

with the ordering ``blind <= csi_err <= perfect`` on seed-averaged final
accuracies, which the script asserts (exit non-zero on violation), and
``fig9_gap`` rows with each series' gap to perfect CSI.

``SMOKE=1`` shrinks rounds and seeds; ``FULL=1`` (common) restores the
paper-scale M, B, T.

Run:  SMOKE=1 python -m repro_torch.benchmarks.fig9_fading
"""
import os

from repro_torch.benchmarks.common import SCALE, dataset, emit, seed_mean

SMOKE = bool(int(os.environ.get("SMOKE", "0")))

#: CSI-error variances on the batched axis (larger = blinder devices)
ERR_VARS = (0.1, 0.8)
#: PS antenna count for the blind scheme, far below the hardening regime
#: (K >> M), so the combiner's residual misalignment and noise enhancement
#: (~M/K) cost enough accuracy for the ordering gate to have a margin at
#: smoke scale
PS_ANTENNAS = 2
#: truncation threshold shared by the CSI-driven schemes
THRESHOLD = 0.3
#: seed replicas averaged per grid point (a common fading realisation
#: across schemes: the comparison is paired)
SEEDS = (0, 1) if SMOKE else (0, 1, 2)


def _sweep(dev, test, base, axes, steps, device):
    from repro_torch.experiments import run_sweep

    return run_sweep(dev, test, base, axes, steps=steps, lr=SCALE.lr,
                     eval_every=SCALE.eval_every, device=device)


def main(collect=None, device=None):
    from repro_torch.benchmarks.common import ota

    steps = 16 if SMOKE else SCALE.steps
    dev, test = dataset(iid=True)
    kw = dict(total_steps=steps, fading_threshold=THRESHOLD,
              ps_antennas=PS_ANTENNAS)
    rows, summary = [], []
    finals = {}  # series -> seed-averaged final accuracy

    def series_rows(series, recs):
        mean_accs, us = seed_mean(recs)
        for i, acc in enumerate(mean_accs):
            step = min(i * SCALE.eval_every, steps - 1)
            rows.append(f"fig9,{series},{step},{acc:.4f}")
        finals[series] = mean_accs[-1]
        summary.append((f"fig9_{series}", us, mean_accs[-1]))

    res = _sweep(dev, test, ota("a_dsgd_fading", **kw),
                 {"seed": list(SEEDS)}, steps, device)
    series_rows("perfect", res.records)

    res = _sweep(dev, test, ota("a_dsgd_csi_err", **kw),
                 {"csi_err_var": list(ERR_VARS), "seed": list(SEEDS)},
                 steps, device)
    for ev in ERR_VARS:
        recs = [r for r in res.records if r["csi_err_var"] == ev]
        series_rows(f"csi_err_v{ev}", recs)

    res = _sweep(dev, test, ota("a_dsgd_blind", **kw),
                 {"seed": list(SEEDS)}, steps, device)
    series_rows(f"blind_K{PS_ANTENNAS}", res.records)

    # --- the fading-paper trend: blind <= csi_err <= perfect -------------
    perfect = finals["perfect"]
    blind = finals[f"blind_K{PS_ANTENNAS}"]
    for series, acc in finals.items():
        rows.append(f"fig9_gap,{series},{steps - 1},{perfect - acc:.4f}")
    emit(rows)
    lo, hi = (finals[f"csi_err_v{v}"] for v in (max(ERR_VARS), min(ERR_VARS)))
    print(f"# ordering: blind {blind:.4f}"
          f" <= csi_err(v={max(ERR_VARS)}) {lo:.4f}"
          f" <= csi_err(v={min(ERR_VARS)}) {hi:.4f}"
          f" <= perfect {perfect:.4f}")
    tol = 0.01  # seed-averaged; allow a whisker of eval noise
    ok = blind <= lo + tol and lo <= hi + tol and hi <= perfect + tol
    print(f"# fig9 ordering_ok={ok}")
    if not ok:
        raise SystemExit("fig9: fading-suite accuracy ordering violated")
    if collect is not None:
        collect.extend(summary)
    return summary


if __name__ == "__main__":
    main()
