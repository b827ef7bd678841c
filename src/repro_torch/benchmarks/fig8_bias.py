"""Fig. 8 (beyond the paper): robustness to biased data distributions.

The paper's §VI non-IID experiment claims A-DSGD is *more robust to bias*
than D-DSGD.  Here the bias is a continuous knob: devices draw their class
proportions from Dirichlet(beta) (``repro_torch/data/partition.py``), so
beta -> inf is IID and smaller beta is heavier label skew.  For each beta
both schemes run as one engine grid; the ``fig8_rel`` rows report accuracy
*retention* relative to the same scheme's near-IID run.

Run:  python -m repro_torch.benchmarks.fig8_bias
"""
from repro_torch.benchmarks.common import dataset, emit, sweep_series

#: near-IID anchor first; decreasing beta = increasing label skew
BETAS = (100.0, 1.0, 0.25)
SCHEMES = ("a_dsgd", "d_dsgd")


def main(collect=None, device=None):
    from repro_torch.data.partition import label_bias

    rows, summary = [], []
    final = {}
    for beta in BETAS:
        dev, test = dataset(partition="dirichlet", beta=beta)
        bias = label_bias(dev[1])
        print(f"# beta={beta}: label bias (mean TV) = {bias:.3f}",
              flush=True)
        _, s = sweep_series(
            "fig8", dev, test, {"scheme": list(SCHEMES)},
            lambda r: f"{r['scheme']}_beta{beta}", rows=rows, device=device,
            p_avg=500.0)
        summary.extend(s)
        for (name, _, acc), scheme in zip(s, SCHEMES):
            final[(scheme, beta)] = acc
    # accuracy retention vs the near-IID anchor (beta = BETAS[0])
    for scheme in SCHEMES:
        for beta in BETAS:
            rel = final[(scheme, beta)] / max(final[(scheme, BETAS[0])],
                                              1e-9)
            rows.append(f"fig8_rel,{scheme},{beta},{rel:.4f}")
    emit(rows)
    if collect is not None:
        collect.extend(summary)
    return summary


if __name__ == "__main__":
    main()
