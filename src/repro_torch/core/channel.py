"""The Gaussian MAC and the analog frame layout (paper §II, §IV, §IV-A).

Frame layout (static length = s_tilde + 2, covering both §IV variants):

    x_m = [ sqrt(a) * (g_tilde - mu * 1),  sqrt(a) * mu,  sqrt(a) ]

with mu = mean(g_tilde) when mean-removal is active (paper: the first ~20
iterations) and mu = 0 otherwise.

    alpha = P_t / (||g_tilde||^2 - (s_tilde - 1) * mu^2 + 1)      (eq. 22)

PS-side normalisation (eq. 25 / eq. 18):

    y_body = (y[:s_tilde] + y[s_tilde] * 1) / y[s_tilde + 1]

The reference vmaps its per-device functions; here a leading device axis is
written out, so ``make_frame`` takes ``(..., s_tilde)`` projections and
``(...)`` power budgets.  The fading helpers are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import rng


def make_frame(g_tilde: torch.Tensor, p_t,
               use_mean_removal) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the channel frames of ``(..., s_tilde)`` projections.

    Returns ``(frame (..., s_tilde + 2), alpha (...))``; ``use_mean_removal``
    is a bool or 0/1 scalar.
    """
    s_tilde = g_tilde.shape[-1]
    use = float(use_mean_removal)
    mu = use * g_tilde.mean(dim=-1, keepdim=True)
    energy = (g_tilde * g_tilde).sum(dim=-1, keepdim=True) \
        - (s_tilde - 1) * mu * mu + 1.0
    p_t = torch.as_tensor(p_t, dtype=g_tilde.dtype, device=g_tilde.device)
    alpha = p_t[..., None] / torch.clamp(energy, min=1e-12)
    ra = torch.sqrt(alpha)
    frame = torch.cat([ra * (g_tilde - mu), ra * mu, ra], dim=-1)
    return frame, alpha[..., 0]


def frame_power(frame: torch.Tensor) -> torch.Tensor:
    """||x_m||^2 per frame -- tests assert == P_t (paper eq. 12/21)."""
    return (frame * frame).sum(dim=-1)


def awgn(key: torch.Tensor, shape, sigma2: float) -> torch.Tensor:
    return float(np.sqrt(np.float32(sigma2))) * rng.normal(key, shape)


def mac_sum(frames: torch.Tensor, key: torch.Tensor,
            sigma2: float) -> torch.Tensor:
    """Simulation path: y = sum_m x_m + z  over a leading device axis."""
    y = frames.sum(dim=0)
    return y + awgn(key, y.shape, sigma2)


#: a received scale slot below this is indistinguishable from the unit-
#: variance AWGN -- the PS then skips the rescale (scale 1.0) instead of
#: amplifying a noise reading
SCALE_SLOT_FLOOR = 1e-3


def ps_normalize(y: torch.Tensor, use_mean_removal) -> torch.Tensor:
    """Recover the PS observation body (eq. 18 / eq. 25).

    The clean scale slot is ``sum_m sqrt(alpha_m) > 0`` by construction;
    noise-dominated readings (<= SCALE_SLOT_FLOOR) fall back to scale 1.0.
    """
    body, mu_slot, scale_slot = y[:-2], y[-2], y[-1]
    use = float(use_mean_removal)
    scale = torch.where(scale_slot > SCALE_SLOT_FLOOR, scale_slot, 1.0)
    return (body + use * mu_slot) / scale
