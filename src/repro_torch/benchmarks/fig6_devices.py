"""Paper Fig. 6: (M, B) scaling at fixed M*B, P-bar in {1, 500}.

Each (M, B) pair re-splits the data (B changes with M), so M is swept at
the dataset level; within each split the P-bar axis is batched.

Run:  python -m repro_torch.benchmarks.fig6_devices
"""
from repro_torch.benchmarks.common import dataset, emit, sweep_series


def main(collect=None, device=None):
    rows, summary = [], []
    total = 4000
    for m in (5, 10):
        dev, test = dataset(iid=True, m=m, b=total // m)
        _, s = sweep_series(
            "fig6", dev, test,
            {"scheme": ["a_dsgd", "d_dsgd"], "p_avg": [1.0, 500.0]},
            lambda r: f"{r['scheme']}_M{m}_P{int(r['p_avg'])}",
            rows=rows, device=device, s_frac=0.25)
        summary.extend(s)
    emit(rows)
    if collect is not None:
        collect.extend(summary)
    return summary


if __name__ == "__main__":
    main()
