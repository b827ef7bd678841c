"""Paper Fig. 4: P-bar in {200, 1000} -- A-DSGD robust, D-DSGD degrades.

Per scheme, the P-bar grid is one batched group.

Run:  python -m repro_torch.benchmarks.fig4_power_sweep
"""
from repro_torch.benchmarks.common import dataset, emit, sweep_series


def main(collect=None, device=None):
    rows, summary = [], []
    dev, test = dataset(iid=True)
    _, s = sweep_series("fig4", dev, test,
                        {"scheme": ["a_dsgd", "d_dsgd"],
                         "p_avg": [200.0, 1000.0]},
                        lambda r: f"{r['scheme']}_P{int(r['p_avg'])}",
                        rows=rows, device=device)
    summary.extend(s)
    _, s = sweep_series("fig4", dev, test, {"scheme": ["ideal"]},
                        lambda r: "ideal", rows=rows, device=device)
    summary.extend(s)
    emit(rows)
    if collect is not None:
        collect.extend(summary)
    return summary


if __name__ == "__main__":
    main()
