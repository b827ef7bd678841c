"""Paper Fig. 2: test accuracy of all five schemes, IID and non-IID.

Each data split runs as one engine grid: the five schemes are static axis
values, one runner each.

Run:  python -m repro_torch.benchmarks.fig2_schemes   (FULL=1: paper scale)
"""
from repro_torch.benchmarks.common import (
    PAPER_SCHEMES, dataset, emit, sweep_series,
)


def main(collect=None, device=None):
    rows, summary = [], []
    for iid, tag in ((True, "iid"), (False, "noniid")):
        dev, test = dataset(iid=iid)
        _, s = sweep_series("fig2", dev, test,
                            {"scheme": list(PAPER_SCHEMES)},
                            lambda r: f"{r['scheme']}_{tag}", rows=rows,
                            device=device)
        summary.extend(s)
    emit(rows)
    if collect is not None:
        collect.extend(summary)
    return summary


if __name__ == "__main__":
    main()
