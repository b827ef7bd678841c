"""Quickstart: federated over-the-air SGD on the port in ~40 lines.

Ten simulated edge devices train the paper's single-layer classifier over a
bandwidth-limited Gaussian MAC with A-DSGD (analog over-the-air
aggregation), compared with the error-free link.  Each run is one
``run_compiled`` loop over rounds with no host round trip.

Run:  python -m repro_torch.examples.quickstart
"""
from repro_torch.configs.base import OTAConfig
from repro_torch.data.synthetic import federated_split, make_classification
from repro_torch.experiments import run_compiled


def main(device=None):
    # 1) data: 10 devices x 400 local samples (MNIST surrogate, offline)
    (x_train, y_train), (x_test, y_test) = make_classification(
        n_train=8000, n_test=2000, noise=6.0, seed=3)
    x_dev, y_dev = federated_split(x_train, y_train, m=10, b=400, iid=True)

    # 2) the channel: s = d/2 uses of a Gaussian MAC, average power 500;
    #    A-DSGD = error feedback + top-k + compressive projection + AMP at
    #    the PS.  Every scheme name resolves through the registry in
    #    repro_torch.core.schemes (a_dsgd_fading adds a truncated-inversion
    #    Rayleigh MAC).
    adsgd = OTAConfig(scheme="a_dsgd", s_frac=0.5, k_frac=0.25, p_avg=500.0,
                      sigma2=1.0, total_steps=40, projection="dense",
                      amp_iters=20, mean_removal_steps=10)
    fading = OTAConfig(scheme="a_dsgd_fading", s_frac=0.5, k_frac=0.25,
                       p_avg=500.0, sigma2=1.0, total_steps=40,
                       projection="dense", amp_iters=20,
                       mean_removal_steps=10, fading_threshold=0.3)
    ideal = OTAConfig(scheme="ideal", total_steps=40)

    # 3) train -- one run_compiled loop per config
    for name, cfg in (("error-free shared link", ideal), ("A-DSGD", adsgd),
                      ("A-DSGD (Rayleigh fading)", fading)):
        run = run_compiled(x_dev, y_dev, x_test, y_test, cfg, steps=40,
                           lr=1e-3, eval_every=10, device=device)
        print(f"{name:24s} accuracy trajectory: "
              + " ".join(f"{a:.3f}" for a in run.accs))


if __name__ == "__main__":
    main()
