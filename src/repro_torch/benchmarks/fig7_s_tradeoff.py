"""Paper Fig. 7: A-DSGD bandwidth/iteration trade-off, s in {d/10, d/5, d/2}.

(a) accuracy vs iteration; (b) accuracy vs total transmitted symbols t*s.

Run:  python -m repro_torch.benchmarks.fig7_s_tradeoff
"""
from repro_torch.benchmarks.common import SCALE, dataset, emit, sweep_series

TAGS = {0.1: "d10", 0.2: "d5", 0.5: "d2"}


def main(collect=None, device=None):
    rows, summary = [], []
    dev, test = dataset(iid=True)
    res, s = sweep_series("fig7", dev, test, {"s_frac": [0.1, 0.2, 0.5]},
                          lambda r: f"a_dsgd_s{TAGS[r['s_frac']]}",
                          rows=rows, device=device, scheme="a_dsgd",
                          k_frac=0.8, p_avg=50.0)
    summary.extend(s)
    # (b): symbol-count series for the same records
    d = 7850
    for rec in res.records:
        s_frac = rec["s_frac"]
        for i, acc in enumerate(rec["accs"]):
            step = min(i * SCALE.eval_every, SCALE.steps - 1)
            rows.append(f"fig7b,a_dsgd_s{TAGS[s_frac]},"
                        f"{int(step * s_frac * d)},{acc:.4f}")
    emit(rows)
    if collect is not None:
        collect.extend(summary)
    return summary


if __name__ == "__main__":
    main()
