"""Theorem 1: evaluate the Pr{E_T} bound terms for the paper's setting.

Host arithmetic only (:mod:`repro_torch.core.convergence`); no device.

Run:  python -m repro_torch.benchmarks.convergence_bound
"""
import time

from repro_torch.core import convergence as cv


def main(collect=None, device=None):
    """``device`` is accepted for the registry's sake: the bound is host
    arithmetic."""
    t0 = time.perf_counter()
    d, s = 7850, 3925
    rows = []
    print("figure,series,T,bound")
    for k_frac in (0.5, 0.9):
        k = int(k_frac * s)
        kw = dict(d=d, k=k, s_tilde=s - 2, m=25, sigma=1.0, g_bound=1.0)
        for T in (10**4, 10**5, 10**6):
            sv = cv.sum_v_constant_power(T, p_avg=500.0, **kw)
            eta = 0.5 * cv.eta_max(T, 1.0, 1.0, 1.0, sv)
            b = (cv.theorem1_bound(T, eta=eta, c_strong=1.0, eps=1.0,
                                   g_bound=1.0, sum_v=sv, theta_star_norm=10.0)
                 if eta > 0 else float("inf"))
            rows.append((k_frac, T, b))
            print(f"thm1,k{k_frac},{T},{b:.4g}")
    dt = (time.perf_counter() - t0) * 1e6 / max(len(rows), 1)
    if collect is not None:
        collect.append(("thm1_bound", dt, rows[-1][2]))
    return rows


if __name__ == "__main__":
    main()
