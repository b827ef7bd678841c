"""Hierarchical aggregation: devices -> edge-site OTA sums -> backhaul.

The port of the reference's ``repro/population/hierarchy.py``.  Devices
associate with edge sites; each site receives the OTA superposition of its
own devices plus its own receiver AWGN, and the sites' partial sums reach
the PS over a backhaul that may add one more noisy hop:

    y = sum_j ( sum_{m in site j} x_m + z_j ) + z_bh.

``site_noise_scale`` (a site's variance relative to the flat MAC's sigma^2)
and ``backhaul_sigma2`` are per-round scalars a sweep batches; at
``n_sites = 1`` the population engine takes the flat ``mac_sum``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.device import sqrt_f32, xla_sum
from repro_torch.robust import aggregators


def site_assignment(m: int, n_sites: int) -> np.ndarray:
    """(M,) int32 device -> edge-site map (round-robin: balanced sites)."""
    return (np.arange(m) % n_sites).astype(np.int32)


def site_mac_sum(frames: torch.Tensor, sites: torch.Tensor, n_sites: int,
                 key: torch.Tensor, sigma2, site_noise_scale=1.0,
                 backhaul_sigma2=0.0,
                 site_trim_frac: float = 0.0) -> torch.Tensor:
    """Two-stage MAC: per-site OTA partial sums, then the PS combine.

    ``frames`` (K, s) cohort channel frames, ``sites`` (K,) the site of each
    row; ``(G, K, s)``, ``(G, K)`` and ``(G, 2)`` keys for G points.  Site
    j adds AWGN of variance ``sigma2 * site_noise_scale`` keyed
    ``fold_in(key, j)``; the combine adds ``backhaul_sigma2`` keyed
    ``fold_in(key, n_sites)``.  ``site_trim_frac > 0`` (static) takes the
    coordinate-wise trimmed mean of the sites' observations, scaled back to
    a sum, instead of their sum.

    The reference's ``jit`` folds ``segment_sum(frames) + z`` into a scatter
    onto the site noise: each site's observation starts from its noise and
    adds its rows in row order.  ``index_add_`` and ``scatter_add_`` use
    atomics on the card, whose order (and so whose bits) change from run to
    run, so the rows are added here one after the other, each onto its own
    site only.  The noise is ``erf_inv(u) * (sqrt(sigma2) * sqrt(2))``
    (:func:`repro_torch.rng.normal_scaled`), the backhaul's added with one
    fused multiply-add.
    """
    s = frames.shape[-1]
    dev = frames.device

    def scalar(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)
    sig_site = scalar(sigma2) * scalar(site_noise_scale)
    site_keys = rng.fold_in(key, torch.arange(n_sites, device=dev))
    obs = rng.normal_scaled(site_keys, (s,), sqrt_f32(sig_site)[..., None])
    onehot = sites.long()[..., None] == torch.arange(n_sites, device=dev)
    for k in range(frames.shape[-2]):
        obs = torch.where(onehot[..., k, :, None],
                          obs + frames[..., k, None, :], obs)
    if site_trim_frac > 0.0:
        alive = torch.ones(obs.shape[:-1], dtype=torch.bool, device=dev)
        y = aggregators.robust_combine(
            obs, alive, float(n_sites), aggregator="trimmed_mean",
            trim_frac=site_trim_frac)
    else:
        y = xla_sum(obs, dim=-2)
    e = rng.normal_over_sqrt2(rng.fold_in(key, n_sites), (s,))
    c = rng.sqrt2_times(sqrt_f32(scalar(backhaul_sigma2)))
    return rng.fma_f32(e, c.reshape(c.shape + (1,) * (y.dim() - c.dim())), y)
