"""Gradient sparsification (paper §III, §IV): the port's A-DSGD part.

Top-k selection comes in two flavours: exact (paper scale) and the sampled
quantile threshold of the blocked path.  Every function works on the last
axis, so a leading device axis rides along.  The digital baselines' SBC,
SignSGD and QSGD compressors and their bit accounting are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

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
