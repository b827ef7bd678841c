"""Straggler model: per-device compute latency with a deadline cutoff.

The port of the reference's ``repro/population/stragglers.py``.  Device
m's round latency is ``speed_m * Exp(1)``: a lognormal slowdown drawn once
per run times a per-round exponential draw.  Devices past
``straggler_deadline`` drop out of the cohort mask and bank their update
like deep-faded ones.  The deadline is a compare a sweep batches; at the
default ``inf`` every finite latency passes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng


def init_speed(key: torch.Tensor, m: int, speed_sigma: float) -> torch.Tensor:
    """(M,) lognormal slowdown factors; sigma = 0 means all-equal (1.0).
    ``exp(sigma * z)`` as the reference computes it outside ``jit``."""
    if speed_sigma <= 0:
        return torch.ones((m,), dtype=torch.float32, device=key.device)
    z = float(np.float32(speed_sigma)) * rng.normal(key, (m,))
    return rng.exp_f32(z)


def latencies(key: torch.Tensor, speed: torch.Tensor) -> torch.Tensor:
    """Per-round compute latencies for the cohort's speed factors (K,),
    ``(G, K)`` with ``(G, 2)`` keys."""
    return speed * rng.exponential(key, speed.shape[-1:])


def deadline_mask(lat: torch.Tensor, deadline) -> torch.Tensor:
    """(K,) bool: which devices finished before the deadline (0-dim, or
    ``(G,)`` for G points)."""
    d = torch.as_tensor(deadline, dtype=lat.dtype, device=lat.device)
    return lat <= d[..., None]
