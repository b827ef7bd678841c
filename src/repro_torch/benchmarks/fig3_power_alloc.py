"""Paper Fig. 3: D-DSGD power-allocation schedules (eq. 45) vs A-DSGD.

The four schedules are one batched group: ``power_schedule`` is a batched
sweep axis (each schedule is a different (T,) P_t array, and the digital
bit budget q_t is precomputed on the host per point).

Run:  python -m repro_torch.benchmarks.fig3_power_alloc
"""
from repro_torch.benchmarks.common import dataset, emit, sweep_series


def main(collect=None, device=None):
    rows, summary = [], []
    dev, test = dataset(iid=True)
    _, s = sweep_series(
        "fig3", dev, test,
        {"power_schedule": ["constant", "lh_stair", "lh_steps", "hl_steps"]},
        lambda r: f"d_dsgd_{r['power_schedule']}", rows=rows,
        device=device, scheme="d_dsgd", p_avg=200.0)
    summary.extend(s)
    _, s = sweep_series("fig3", dev, test, {"scheme": ["a_dsgd", "ideal"]},
                        lambda r: r["scheme"], rows=rows, device=device,
                        p_avg=200.0)
    summary.extend(s)
    emit(rows)
    if collect is not None:
        collect.extend(summary)
    return summary


if __name__ == "__main__":
    main()
