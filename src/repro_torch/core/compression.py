"""Gradient compression primitives (paper §III, §IV and the §VI baselines).

Top-k selection comes in two flavours: exact (paper scale) and the sampled
quantile threshold of the blocked path.  The digital baselines quantize to
a per-step budget q_t: SBC for D-DSGD, signs for SignSGD, stochastic levels
for QSGD.  Every function works on the last axis, so leading device and
point axes ride along; a budget ``q_t`` broadcasts against the rows.  The
host-side bit accounting that sizes q_t is the reference's numpy code,
copied unchanged.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import rng
from repro_torch.device import row_sum
from repro_torch.rng import fma_f32


def top_k_sparsify(v: torch.Tensor, k: int) -> torch.Tensor:
    """Exact sp_k: keep the k largest-magnitude entries of v (paper Alg. 1).

    Ties with the k-th magnitude are kept too, as in the reference.
    """
    mag = v.abs()
    kth = torch.topk(mag, min(k, v.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(mag >= kth, v, 0.0)


def topk_threshold(v: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest |v| (exact)."""
    return torch.topk(v.abs(), min(k, v.shape[-1]), dim=-1).values[..., -1]


def _quantile_linear(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q, axis=-1)`` (method "linear") bit for bit.

    ``torch.quantile`` rounds differently, so this codes jnp's formula over
    a sort: ``h = f32(q) * (n - 1)``, ``w = h - floor(h)``, then
    ``lo * (1 - w) + hi * w`` with the first product fused into the add, as
    XLA contracts it.  A row holding a NaN gives NaN, as in jnp.
    """
    n = a.shape[-1]
    srt = torch.sort(a, dim=-1).values
    h = np.float32(np.float32(q) * np.float32(n - 1))
    lo_i = int(np.clip(np.floor(h), 0, n - 1))
    hi_i = int(np.clip(np.ceil(h), 0, n - 1))
    w = np.float32(h - np.floor(h))
    lo, hi = srt[..., lo_i], srt[..., hi_i]
    out = fma_f32(lo, float(np.float32(1.0) - w), hi * float(w))
    return torch.where(torch.isnan(a).any(dim=-1), float("nan"), out)


def sampled_topk_threshold(v: torch.Tensor, k: int, key=None,
                           n_samples: int = 1 << 16) -> torch.Tensor:
    """Approximate k-th largest |v| from a strided sample, per row.

    ``key`` is accepted for the reference's signature and unused: the
    reference's docstring speaks of a key-derived start offset, but its
    code samples from offset 0, and this follows the code.
    """
    d = v.shape[-1]
    n = min(n_samples, d)
    stride = d // n
    if stride <= 1:
        sample = v.abs()
    else:
        sample = v[..., 0:n * stride:stride].abs()
    return _quantile_linear(sample, 1.0 - (k / d))


def error_feedback(g: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """g^ec = g + Delta (paper Alg. 1 line 5)."""
    return g + delta


def residual(g_ec: torch.Tensor, g_sp: torch.Tensor) -> torch.Tensor:
    """Delta' = g^ec - g^sp (paper eq. 10)."""
    return g_ec - g_sp


# ---------------------------------------------------------------------------
# digital baselines (paper §III, §VI): quantize to the bit budget q_t
# ---------------------------------------------------------------------------


def _qth(values: torch.Tensor, q_t, q_max: int) -> torch.Tensor:
    """The q_t-th entry of each row of descending top-``q_max`` values, as
    ``(..., 1)``: only that entry of a top-k is used, so ``torch.topk``'s
    values give the reference's bits whatever ``q_max`` is."""
    q_t = torch.as_tensor(q_t, device=values.device)
    qi = torch.clamp(q_t.to(torch.int64) - 1, 0, q_max - 1)
    qi = qi.expand(values.shape[:-1])[..., None]
    return values.gather(-1, qi)


def _budget_on(q_t, v: torch.Tensor) -> torch.Tensor:
    """``q_t > 0`` per row, as ``(..., 1)`` against ``(..., d)`` rows."""
    q_t = torch.as_tensor(q_t, device=v.device)
    return (q_t > 0).expand(v.shape[:-1])[..., None]


def sbc_quantize(v: torch.Tensor, q_t, q_max: int) -> torch.Tensor:
    """Sparse binary compression with a dynamic budget q_t <= q_max.

    Keep the q_t largest and q_t smallest entries of each row (by value);
    the side whose surviving entries have the larger mean magnitude wins:
    its entries are set to that mean, the other side is zeroed (paper
    §III).  ``q_t`` is an integer tensor broadcasting against the rows;
    ``q_max`` the static bound of the top-k.
    """
    q_max = min(q_max, v.shape[-1])
    hi = _qth(torch.topk(v, q_max, dim=-1).values, q_t, q_max)
    lo = -_qth(torch.topk(-v, q_max, dim=-1).values, q_t, q_max)
    pos_keep = (v >= hi) & (v > 0)
    neg_keep = (v <= lo) & (v < 0)
    npos = torch.clamp(pos_keep.sum(-1, keepdim=True), min=1)
    nneg = torch.clamp(neg_keep.sum(-1, keepdim=True), min=1)
    # (G, M, d) rows sum point by point (device.row_sum)
    mu_pos = row_sum(torch.where(pos_keep, v, 0.0))[..., None] / npos
    mu_neg = row_sum(torch.where(neg_keep, v, 0.0))[..., None] / nneg
    pos_wins = mu_pos > mu_neg.abs()
    out = torch.where(pos_wins, torch.where(pos_keep, mu_pos, 0.0),
                      torch.where(neg_keep, mu_neg, 0.0))
    return torch.where(_budget_on(q_t, v), out, 0.0)


def signsgd_compress(v: torch.Tensor, q_t, q_max: int) -> torch.Tensor:
    """Top-q_t by magnitude, transmit signs (eq. 43)."""
    q_max = min(q_max, v.shape[-1])
    tau = _qth(torch.topk(v.abs(), q_max, dim=-1).values, q_t, q_max)
    keep = (v.abs() >= tau) & _budget_on(q_t, v)
    return torch.where(keep, torch.sign(v), 0.0)


def qsgd_compress(v: torch.Tensor, q_t, q_max: int, bits: int,
                  key: torch.Tensor) -> torch.Tensor:
    """Top-q_t entries quantized with QSGD stochastic rounding (eq. 44).

    q(v_i) = ||v_sel|| * sign(v_i) * xi_i, xi in {0, 1/L, ..., 1}, L =
    2^bits, rounded up with probability ``scaled - floor``.  ``key`` holds
    one key per row, ``(..., 2)``: each row draws ``uniform(key, (d,))`` as
    the reference's per-device call does.  The norm is ``sqrt(sum(x*x))``
    as ``jnp.linalg.norm`` computes it; its sum runs in torch's order, an
    ulp from XLA's, which can move one entry's level (a change of norm/L),
    point by point for ``(G, M, d)`` rows (``device.row_sum``).
    """
    q_max = min(q_max, v.shape[-1])
    tau = _qth(torch.topk(v.abs(), q_max, dim=-1).values, q_t, q_max)
    keep = (v.abs() >= tau) & _budget_on(q_t, v)
    v_sel = torch.where(keep, v, 0.0)
    norm = torch.sqrt(row_sum(v_sel * v_sel))[..., None]
    norm = torch.clamp(norm, min=1e-12)
    levels = float(2 ** bits)
    scaled = v_sel.abs() / norm * levels
    floor = torch.floor(scaled)
    prob = scaled - floor
    u = rng.uniform(key, v.shape[-1:])
    level = floor + (u < prob).to(v.dtype)
    return torch.sign(v_sel) * level / levels * norm


# ---------------------------------------------------------------------------
# bit accounting (host-side, numpy): the reference's code, unchanged
# ---------------------------------------------------------------------------


def _log2_binom_np(d: int, q: np.ndarray) -> np.ndarray:
    from math import lgamma
    q = np.asarray(q, np.float64)
    out = np.zeros_like(q)
    ln2 = np.log(2.0)
    for i, qq in np.ndenumerate(q):
        qq = float(qq)
        if qq <= 0 or qq >= d:
            out[i] = 0.0
        else:
            out[i] = (lgamma(d + 1) - lgamma(qq + 1) - lgamma(d - qq + 1)) / ln2
    return out


def mac_bit_budget(s: int, m: int, p_t: np.ndarray, sigma2: float) -> np.ndarray:
    """R_t = s/(2M) log2(1 + M P_t / (s sigma^2))  (paper eq. 8)."""
    p_t = np.asarray(p_t, np.float64)
    return s / (2.0 * m) * np.log2(1.0 + m * p_t / (s * sigma2))


def ddsgd_bits(d: int, q: np.ndarray) -> np.ndarray:
    """r_t = log2 C(d, q_t) + 33   (paper eq. 9)."""
    return _log2_binom_np(d, q) + 33.0


def signsgd_bits(d: int, q: np.ndarray) -> np.ndarray:
    """r_t = log2 C(d, q) + q   (paper eq. 43)."""
    return _log2_binom_np(d, q) + np.asarray(q, np.float64)


def qsgd_bits(d: int, q: np.ndarray, l_q: int) -> np.ndarray:
    """r_t = 32 + log2 C(d, q) + (1 + l_Q) q   (paper eq. 44)."""
    return 32.0 + _log2_binom_np(d, q) + (1.0 + l_q) * np.asarray(q, np.float64)


def max_q_for_budget(d: int, budget: float, bits_fn, q_cap: int | None = None) -> int:
    """Largest integer q with bits_fn(d, q) <= budget (paper: choose q_t)."""
    hi = min(d // 2, q_cap) if q_cap else d // 2
    lo = 0
    if bits_fn(d, np.asarray([1.0]))[0] > budget:
        return 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if bits_fn(d, np.asarray([float(mid)]))[0] <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def digital_q_schedule(d: int, s: int, m: int, p_ts: np.ndarray, sigma2: float,
                       scheme: str = "d_dsgd", l_q: int = 2,
                       q_cap: int | None = None) -> np.ndarray:
    """Host-precomputed q_t for every step of a digital scheme."""
    budgets = mac_bit_budget(s, m, p_ts, sigma2)
    try:
        fn = functools.partial(BIT_COSTS[scheme], l_q=l_q)
    except KeyError:
        raise ValueError(f"no bit-cost model for scheme {scheme!r}; known: "
                         f"{', '.join(sorted(BIT_COSTS))}") from None
    return np.asarray([max_q_for_budget(d, float(b), fn, q_cap) for b in budgets],
                      np.int32)


#: per-scheme bit-cost models r_t(q) used to size the q_t schedule; digital
#: Scheme subclasses (repro_torch.core.schemes) are looked up here by their
#: registered name.
BIT_COSTS = {
    "d_dsgd": lambda d, q, l_q: ddsgd_bits(d, q),
    "ddsgd": lambda d, q, l_q: ddsgd_bits(d, q),
    "signsgd": lambda d, q, l_q: signsgd_bits(d, q),
    "qsgd": lambda d, q, l_q: qsgd_bits(d, q, l_q),
}
