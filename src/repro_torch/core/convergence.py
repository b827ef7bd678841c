"""Convergence-analysis quantities of the paper (§V) — evaluated numerically.

Implements lambda, sigma_max, rho(delta) (Lemma 2, chi-square quantile),
v(t) (Lemma 4, eq. 37b), its closed-form sum for P_t = P (eq. 42), and the
Theorem-1 bound on Pr{E_T}.  Host-side numpy: these feed tests and the
``benchmarks/convergence_bound.py`` harness, not the training loop.
"""
from __future__ import annotations

import math



def lambda_val(d: int, k: int) -> float:
    """lambda = sqrt((d - k)/d) (Corollary 1)."""
    return math.sqrt((d - k) / d)


def sigma_max(d: int, s_tilde: int) -> float:
    """Asymptotic largest singular value of A: sqrt(d/s_tilde) + 1 (App. A)."""
    return math.sqrt(d / s_tilde) + 1.0


def _gammainc_lower_reg(a: float, x: float) -> float:
    """Regularized lower incomplete gamma P(a, x) (series + continued frac)."""
    if x < 0 or a <= 0:
        raise ValueError
    if x == 0:
        return 0.0
    if x < a + 1.0:
        # series
        term = 1.0 / a
        total = term
        n = a
        for _ in range(10000):
            n += 1.0
            term *= x / n
            total += term
            if abs(term) < abs(total) * 1e-14:
                break
        return total * math.exp(-x + a * math.log(x) - math.lgamma(a))
    # continued fraction for Q(a,x), P = 1 - Q
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    dd = 1.0 / b
    h = dd
    for i in range(1, 10000):
        an = -i * (i - a)
        b += 2.0
        dd = an * dd + b
        if abs(dd) < tiny:
            dd = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        dd = 1.0 / dd
        delta = dd * c
        h *= delta
        if abs(delta - 1.0) < 1e-14:
            break
    q = math.exp(-x + a * math.log(x) - math.lgamma(a)) * h
    return 1.0 - q


def chi2_quantile(df: int, p: float) -> float:
    """x with P(df/2, x/2) = p, by bisection."""
    lo, hi = 0.0, max(10.0 * df, 100.0)
    while _gammainc_lower_reg(df / 2.0, hi / 2.0) < p:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _gammainc_lower_reg(df / 2.0, mid / 2.0) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def rho(delta: float, d: int) -> float:
    """Lemma 2: Pr{||u|| >= sigma_u rho(delta)} = delta for u ~ N(0, I_d)."""
    return math.sqrt(chi2_quantile(d, 1.0 - delta))


def v_t(t: int, *, d: int, k: int, s_tilde: int, m: int, p_t: float,
        sigma: float, g_bound: float, delta_prob: float = 1e-3) -> float:
    """Per-step perturbation bound v(t) (Lemma 4, eq. 37b)."""
    lam = lambda_val(d, k)
    smax = sigma_max(d, s_tilde)
    rr = rho(delta_prob, d)
    geo = (1.0 - lam ** (t + 1)) / (1.0 - lam)
    term1 = lam * ((1.0 + lam) * (1.0 - lam ** t) / (1.0 - lam) + 1.0) * g_bound
    term2 = rr * sigma / (m * math.sqrt(p_t)) * (smax * geo * g_bound + 1.0)
    return term1 + term2


def sum_v_constant_power(T: int, *, d: int, k: int, s_tilde: int, m: int,
                         p_avg: float, sigma: float, g_bound: float,
                         delta_prob: float = 1e-3) -> float:
    """Closed form of sum_{t=0}^{T-1} v(t) for P_t = P-bar (paper eq. 42).

    Note: the paper's printed (42) carries (1 - lam^{T+1}) in the second
    correction term; summing its own v(t) (eq. 37b) exactly gives
    lam (1 - lam^T) — we use the self-consistent form (difference < 1%, and
    vanishing in T).  Recorded in EXPERIMENTS.md as a suspected typo.
    """
    lam = lambda_val(d, k)
    smax = sigma_max(d, s_tilde)
    rr = rho(delta_prob, d)
    a = (2.0 * lam * g_bound / (1.0 - lam)
         + rr * sigma / (m * math.sqrt(p_avg)) * (smax * g_bound / (1.0 - lam) + 1.0))
    b = (lam * (1.0 + lam) * (1.0 - lam ** T) * g_bound / (1.0 - lam) ** 2
         + rr * sigma * smax * lam * (1.0 - lam ** T) * g_bound
         / (m * math.sqrt(p_avg) * (1.0 - lam) ** 2))
    return a * T - b


def eta_max(T: int, c_strong: float, eps: float, g_bound: float,
            sum_v: float) -> float:
    """Learning-rate ceiling of Theorem 1 (eq. 40)."""
    return 2.0 * (c_strong * eps * T - math.sqrt(eps) * sum_v) / (T * g_bound ** 2)


def theorem1_bound(T: int, *, eta: float, c_strong: float, eps: float,
                   g_bound: float, sum_v: float, theta_star_norm: float) -> float:
    """Pr{E_T} bound (eq. 41). Returns +inf when the denominator is <= 0."""
    denom_rate = 2.0 * eta * c_strong * eps - eta ** 2 * g_bound ** 2
    if denom_rate <= 0:
        return float("inf")
    lipschitz = 2.0 * math.sqrt(eps) / denom_rate
    denom = T - eta * lipschitz * sum_v
    if denom <= 0:
        return float("inf")
    return (eps / (denom_rate * denom)) * math.log(
        math.e * theta_star_norm ** 2 / eps)
