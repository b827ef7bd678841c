"""Paper Fig. 5: channel bandwidth s in {d/2, 3d/10} -- A-DSGD robust.

s changes the projector's shape, so ``s_frac`` is a static sweep axis:
four runners.

Run:  python -m repro_torch.benchmarks.fig5_bandwidth
"""
from repro_torch.benchmarks.common import dataset, emit, sweep_series

TAGS = {0.5: "d2", 0.3: "3d10"}


def main(collect=None, device=None):
    rows, summary = [], []
    dev, test = dataset(iid=True, m=10)
    _, s = sweep_series("fig5", dev, test,
                        {"scheme": ["a_dsgd", "d_dsgd"],
                         "s_frac": [0.5, 0.3]},
                        lambda r: f"{r['scheme']}_s{TAGS[r['s_frac']]}",
                        rows=rows, device=device)
    summary.extend(s)
    emit(rows)
    if collect is not None:
        collect.extend(summary)
    return summary


if __name__ == "__main__":
    main()
