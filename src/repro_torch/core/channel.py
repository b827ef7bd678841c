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
``(...)`` power budgets.  A sweep's grid adds a leading point axis G in
front of the devices: ``mac_sum`` and ``frame_power`` then take
``(G, M, s)`` frames (``mac_sum`` one key per point, ``(G, 2)``), and
``ps_normalize`` ``(G, s_tilde + 2)``.  The fading helpers at the bottom
implement the ``a_dsgd_fading`` scheme's truncated channel inversion.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.fading import (
    complex_normals, magnitude, point_scalar, sqrt_f32,
)
from repro_torch.device import per_point, row_sum


def make_frame(g_tilde: torch.Tensor, p_t,
               use_mean_removal) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the channel frames of ``(..., s_tilde)`` projections.

    Returns ``(frame (..., s_tilde + 2), alpha (...))``; ``use_mean_removal``
    is a bool or 0/1 scalar.  ``(G, M, s_tilde)`` projections of G points
    build point by point: their row sums would round a point unlike its own
    call if batched (see :func:`device.row_sum`).
    """
    if g_tilde.dim() == 3:
        p_t = torch.as_tensor(p_t, dtype=g_tilde.dtype,
                              device=g_tilde.device).expand(g_tilde.shape[:-1])
        return per_point(lambda g, p: make_frame(g, p, use_mean_removal),
                         g_tilde, p_t, rank=2)
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
    """||x_m||^2 per frame -- tests assert == P_t (paper eq. 12/21);
    ``(G, M, s)`` frames sum point by point (:func:`device.row_sum`)."""
    return row_sum(frame * frame)


def awgn(key: torch.Tensor, shape, sigma2) -> torch.Tensor:
    """``sqrt(sigma2) * normal(key, shape)`` (``(..., *shape)`` for a stack
    of keys).  A 0-dim tensor ``sigma2`` (a channel's noise enhancement)
    takes the form the reference's ``jit`` gives a traced scale: the draw's
    ``sqrt(2)`` moved onto it (:func:`repro_torch.rng.normal_scaled`)."""
    if isinstance(sigma2, torch.Tensor):
        return rng.normal_scaled(key, shape, sqrt_f32(sigma2.float()))
    return float(np.sqrt(np.float32(sigma2))) * rng.normal(key, shape)


def mac_sum(frames: torch.Tensor, key: torch.Tensor, sigma2) -> torch.Tensor:
    """Simulation path: y = sum_m x_m + z over the device axis.

    ``frames`` (M, s) with one key (2,), or (G, M, s) with a key per point
    (G, 2): each point sums its own devices and draws its AWGN from its own
    key.  ``sigma2`` is a python float, or a 0-dim or ``(G,)`` float32
    tensor when the channel scales it (the blind PS combiner); the noise
    is then ``sqrt(sigma2) * z`` added with one fused multiply-add, as the
    reference's ``jit`` compiles a traced variance.
    """
    y = frames.sum(dim=-2)
    shape = y.shape[key.dim() - 1:]
    if not isinstance(sigma2, torch.Tensor):
        return y + awgn(key, shape, sigma2)
    scale = sqrt_f32(sigma2.to(torch.float32))[..., None]
    return rng.fma_f32(scale, rng.normal(key, shape), y)



def site_awgn(key: torch.Tensor, shape, sigma2, n_sites: int,
              site_noise_scale=1.0) -> torch.Tensor:
    """Summed receiver noise of a hierarchical MAC of ``n_sites`` edge sites.

    Site ``j`` adds AWGN of variance ``sigma2 * site_noise_scale`` keyed
    ``fold_in(key, j)``; combining the sites' partial sums at the PS adds
    their noises.  Both scalars are python floats or 0-dim float32 tensors;
    a stack of keys ``(..., 2)`` gives ``(..., *shape)``, each key's noise.
    As the reference's ``jit`` compiles it: the normal draw's ``sqrt(2)``
    moves onto the scale ``c = sqrt(sigma2 * site_noise_scale)``, and the
    sum over the sites takes each site's product with one fused
    multiply-add, ``z = fma(e_j, c, z)`` in site order (bitwise
    ``jax.jit`` of the reference up to 32 sites, the length XLA sums
    without windows).
    """
    dev = key.device
    site_dim = key.dim() - 1

    def scalar(v):
        # a python float filled on the device: no copy from the host
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32)
        return torch.full((), v, dtype=torch.float32, device=dev)
    sig = scalar(sigma2) * scalar(site_noise_scale)
    c = rng.sqrt2_times(sqrt_f32(sig))
    e = rng.normal_over_sqrt2(
        rng.fold_in(key, torch.arange(n_sites, device=dev)), shape)
    z = e.select(site_dim, 0) * c
    for j in range(1, n_sites):
        z = rng.fma_f32(e.select(site_dim, j), c, z)
    return z

#: a received scale slot below this is indistinguishable from the unit-
#: variance AWGN -- the PS then skips the rescale (scale 1.0) instead of
#: amplifying a noise reading
SCALE_SLOT_FLOOR = 1e-3


def ps_normalize(y: torch.Tensor, use_mean_removal) -> torch.Tensor:
    """Recover the PS observation body (eq. 18 / eq. 25).

    The clean scale slot is ``sum_m sqrt(alpha_m) > 0`` by construction;
    noise-dominated readings (<= SCALE_SLOT_FLOOR) fall back to scale 1.0.
    """
    body, mu_slot, scale_slot = y[..., :-2], y[..., -2:-1], y[..., -1:]
    use = float(use_mean_removal)
    scale = torch.where(scale_slot > SCALE_SLOT_FLOOR, scale_slot, 1.0)
    return (body + use * mu_slot) / scale


# ---------------------------------------------------------------------------
# fading MAC (beyond-paper: the §II extension realised in the follow-up [34])
# ---------------------------------------------------------------------------


def rayleigh_gains(key: torch.Tensor, m: int) -> torch.Tensor:
    """|h_m| for a flat Rayleigh-fading block: |CN(0,1)| magnitudes, the
    draw and the fused sum of squares of :mod:`repro_torch.core.fading`."""
    return magnitude(*complex_normals(key, m))


def truncated_inversion_power(h: torch.Tensor, threshold=0.3):
    """Truncated channel inversion (follow-up [34] §III).

    Devices with ``|h_m|`` below the threshold stay silent; the rest
    pre-invert, so the usable received power is ``P_t * h_m**2``.  Returns
    ``(h**2 * active, active)``.  ``threshold`` is a float, or a 0-dim or
    ``(G,)`` tensor for G points of ``(G, m)`` gains.
    """
    active = h >= point_scalar(threshold, h.device)
    return torch.where(active, h * h, 0.0), active
