"""Geometry-grounded channel model: placement-derived large-scale gains.

The port of the reference's ``repro/core/geometry.py``.  Devices are drawn
uniformly on a disk of radius ``cell_radius`` around a BS mast of height
``bs_height``; each gets the normalised power-law gain

    g_m = G_bs * G_user * (d_m / d0) ** (-gamma),

composed multiplicatively onto the small-scale fading draw.  Positions come
from the run-level :func:`geometry_base_key`, so a ``seed`` sweep axis
holds the placement fixed; ``cell_radius`` and ``path_loss_exp`` enter as
multiplies (``exp(-gamma * log(d / d0))``), so a grid carries them as
``(G,)`` per-point values.  The arithmetic is the reference's as its
``jit`` compiles it: the sum under the square root fused, XLA's float32
``exp`` and ``log`` (:func:`repro_torch.rng.exp_f32`, ``log_f32``), and
the division by the constant ``d0`` a product with its float32 reciprocal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.fading import point_scalar, sqrt_f32

#: recognised geometry kinds (validated by spec_from_cfg)
GEOMETRIES = ("none", "disk")

#: salt decorrelating the run-level placement stream from every other
#: consumer of OTAConfig.seed (fading streams, fault traces, projectors)
GEOMETRY_SEED_SALT = 0x6E00

#: speed of light, for the absolute (Friis) link budget
SPEED_OF_LIGHT = 299_792_458.0


@dataclass(frozen=True)
class GeometrySpec:
    """Static description of the cell geometry: the placement model, the
    antenna gains, the BS mast height, the carrier (diagnostics only) and
    the normalisation distance ``ref_dist``."""

    kind: str = "disk"
    carrier_freq: float = 915e6
    bs_gain_db: float = 5.0
    user_gain_db: float = 0.0
    bs_height: float = 10.0
    ref_dist: float = 100.0


def spec_from_cfg(cfg) -> GeometrySpec:
    """Build the spec from an OTAConfig, validating the kind."""
    if cfg.geometry not in GEOMETRIES:
        raise ValueError(
            f"unknown geometry {cfg.geometry!r}; known: {GEOMETRIES}")
    return GeometrySpec(
        kind=cfg.geometry if cfg.geometry != "none" else "disk",
        carrier_freq=cfg.carrier_freq, bs_gain_db=cfg.bs_gain_db,
        user_gain_db=cfg.user_gain_db, bs_height=cfg.bs_height,
        ref_dist=cfg.geo_ref_dist)


def geometry_base_key(seed: int, device=None) -> torch.Tensor:
    """Run-level key anchoring the device placement."""
    return rng.PRNGKey(seed ^ GEOMETRY_SEED_SALT, device=device)


def unit_positions(key: torch.Tensor, m: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r, theta) of m devices uniform on the unit disk (``r = sqrt(U)``)."""
    uv = rng.uniform(key, (2, m))
    two_pi = float(np.float32(2.0 * math.pi))
    return sqrt_f32(uv[..., 0, :]), two_pi * uv[..., 1, :]


def device_distances(key: torch.Tensor, m: int, cell_radius,
                     spec: GeometrySpec) -> torch.Tensor:
    """``(..., m)`` 3-D device-to-BS distances for a disk cell: the
    horizontal distance and the mast height, the sum of squares fused."""
    r_unit, _theta = unit_positions(key, m)
    horiz = point_scalar(cell_radius, key.device) * r_unit
    h = np.float32(spec.bs_height)
    return sqrt_f32(rng.fma_f32(horiz, horiz, float(h * h)))


def large_scale_gains(key: torch.Tensor, m: int, cell_radius, path_loss_exp,
                      spec: GeometrySpec) -> torch.Tensor:
    """``(..., m)`` normalised large-scale power gains
    ``g_ant * exp(-gamma * log(max(d / d0, 1e-6)))``; a ``(G,)`` radius or
    exponent gives ``(G, m)``."""
    d = device_distances(key, m, cell_radius, spec)
    g_ant = float(np.float32(10.0 ** ((spec.bs_gain_db + spec.user_gain_db)
                                      / 10.0)))
    inv_ref = float(np.float32(1.0) / np.float32(spec.ref_dist))
    ratio = torch.clamp(d * inv_ref, min=float(np.float32(1e-6)))
    gamma = point_scalar(path_loss_exp, key.device)
    return g_ant * rng.exp_f32(-gamma * rng.log_f32(ratio))


def _log10_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log10``: XLA's float32 log over the float32 log of 10."""
    ten = torch.full((), 10.0, dtype=torch.float32, device=x.device)
    return rng.log_f32(x) / rng.log_f32(ten)


def fspl_db(dist_m, carrier_freq) -> torch.Tensor:
    """Free-space path loss in dB: ``20 log10(4 pi d f / c)`` (Friis)."""
    d = torch.clamp(torch.as_tensor(dist_m, dtype=torch.float32),
                    min=float(np.float32(1e-3)))
    f = float(np.float32(carrier_freq))
    arg = float(np.float32(4.0 * math.pi)) * d * f
    arg = arg / torch.full((), float(np.float32(SPEED_OF_LIGHT)),
                           dtype=torch.float32, device=d.device)
    return 20.0 * _log10_f32(arg)


def link_budget_db(dist_m, path_loss_exp, spec: GeometrySpec
                   ) -> torch.Tensor:
    """Absolute received-power budget (dB, relative to transmit power):
    Friis loss up to ``spec.ref_dist``, then the ``path_loss_exp`` power law
    beyond it.  Diagnostics only."""
    d = torch.clamp(torch.as_tensor(dist_m, dtype=torch.float32),
                    min=float(np.float32(1e-3)))
    gamma = torch.as_tensor(path_loss_exp, dtype=torch.float32,
                            device=d.device)
    ref = torch.full((), float(np.float32(spec.ref_dist)),
                     dtype=torch.float32, device=d.device)
    loss = fspl_db(ref, spec.carrier_freq) + 10.0 * gamma * _log10_f32(
        torch.clamp(d / ref, min=1.0))
    return float(np.float32(spec.bs_gain_db + spec.user_gain_db)) - loss
