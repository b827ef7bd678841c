"""Robust aggregation: trimmed-mean / median / norm-cap combines, and the
analog transmit power cap.

The port of the reference's ``repro/robust/aggregators.py``.  The digital
drivers sum the device frames; one Byzantine device then moves the
aggregate arbitrarily.  The combines here bound that influence,
coordinate-wise (trim, median) or per frame (norm cap), and each returns a
*sum-equivalent* vector (the robust mean times the effective device count),
so the scheme's decode, which divides by that count, needs no change.

Frames are ``(..., m, s)`` with the devices on the second axis from the
end; a sweep's grid puts G points in front, with ``(G,)`` scalars.  Dead
rows (masked-out, erased, dropped devices) go to ``+inf`` before the sort,
and the rank window, computed from the live row count, excludes them.  As
in the reference, the sorted-and-trimmed sum re-associates the reduction,
so the drivers keep the literal sum on the static ``aggregator="mean"``
path.

Every sum follows XLA's CPU order under ``jit`` (read from its LLVM IR,
jax 0.9.0), with elementwise ops only: along a frame in windows of 32
(:func:`repro_torch.device.xla_sum`), the rank window across the devices
one row after the other, and the norm-capped sum, whose product XLA fuses
into the reduction, in vectors of 8 devices at the paper's 25.  So the
combines are bitwise ``jax.jit`` of the reference, and a grid point keeps
its own call's bits.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.device import XLA_REDUCE_WINDOW, sqrt_f32, xla_sum


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A float or a 0-dim / ``(G,)`` tensor as float32 on ``like``'s
    device."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _n_alive(alive: torch.Tensor) -> torch.Tensor:
    return torch.clamp(alive.to(torch.float32).sum(-1), min=1.0)


def _rank_window_mean(frames: torch.Tensor, alive: torch.Tensor, lo, hi):
    """Mean over the sort ranks ``[lo, hi]`` of each coordinate, dead rows
    excluded; ``lo``, ``hi`` are 0-dim or ``(G,)`` inclusive rank bounds
    within the live rows.  Live rows sort before the ``+inf`` dead rows, a
    NaN after both (``torch.sort`` and ``jnp.sort`` both put NaN last)."""
    x = torch.where(alive[..., None], frames, torch.inf)
    xs = torch.sort(x, dim=-2).values
    i = torch.arange(frames.shape[-2], dtype=torch.float32,
                     device=frames.device)[:, None]
    keep = (i >= lo[..., None, None]) & (i <= hi[..., None, None])
    count = torch.clamp(hi - lo + 1.0, min=1.0)
    return xla_sum(torch.where(keep, xs, 0.0), dim=-2) / count[..., None]


def trimmed_mean(frames: torch.Tensor, alive: torch.Tensor,
                 trim_frac) -> torch.Tensor:
    """``(..., s)`` coordinate-wise trimmed mean over the live rows: the
    ``floor(trim_frac * n_alive)`` smallest and largest values of each
    coordinate are discarded."""
    n = _n_alive(alive)
    lo = torch.floor(_scalar(trim_frac, frames) * n)
    # degenerate cohorts: never trim away every row
    lo = torch.minimum(lo, torch.clamp(torch.ceil(n * 0.5) - 1.0, min=0.0))
    return _rank_window_mean(frames, alive, lo, n - 1.0 - lo)


def median(frames: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """``(..., s)`` coordinate-wise median over the live rows (the mean of
    the one or two middle ranks)."""
    n = _n_alive(alive)
    lo = torch.floor((n - 1.0) * 0.5)
    return _rank_window_mean(frames, alive, lo, n - 1.0 - lo)


def _row_energy(frames: torch.Tensor) -> torch.Tensor:
    """``sum(frames * frames, axis=-1, keepdims=True)`` in XLA's CPU order:
    a row longer than 32 squares first and sums in windows of 32; a shorter
    one is one loop, where LLVM fuses each square into the running sum,
    except at 5 to 8 entries, which it sums unfused (measured with jax
    0.9.0 on rows of 1 to 32 entries)."""
    n = frames.shape[-1]
    if n > XLA_REDUCE_WINDOW or 5 <= n <= 8:
        return xla_sum(frames * frames, dim=-1)[..., None]
    acc = frames[..., 0] * frames[..., 0]
    for i in range(1, n):
        acc = rng.fma_f32(frames[..., i], frames[..., i], acc)
    return acc[..., None]


#: device counts at which XLA's CPU backend vectorises the norm-capped sum
#: across the devices (jax 0.9.0, measured for 1 to 40 devices); at 20 to
#: 23 it takes an order not reproduced here (ROADMAP queue 3), elsewhere it
#: sums the devices one after the other
_LANE_DEVICES = frozenset((19, *range(24, 33)))


def _device_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the devices (axis -2) of the norm-capped product, which XLA
    fuses into its reduction.  At ``_LANE_DEVICES`` devices: vectors of 8
    devices summed one after the other, their 8 lanes summed by halves
    (``llvm.vector.reduce.fadd``), then the last ``m mod 8`` devices one by
    one; at other counts one device after the other.  Elementwise adds
    only."""
    m = x.shape[-2]
    if m not in _LANE_DEVICES:
        return xla_sum(x, dim=-2)
    full = m - m % 8
    acc = x[..., 0:8, :] + 0.0
    for i in range(8, full, 8):
        acc = acc + x[..., i:i + 8, :]
    while acc.shape[-2] > 1:
        half = acc.shape[-2] // 2
        acc = acc[..., :half, :] + acc[..., half:, :]
    total = acc[..., 0, :]
    for i in range(full, m):
        total = total + x[..., i, :]
    return total


def norm_capped_sum(frames: torch.Tensor, alive: torch.Tensor,
                    cap) -> torch.Tensor:
    """``(..., s)`` sum of the live frames, each L2-clipped to ``cap`` times
    the median live-row norm.  Honest frames at or below the cap pass with
    scale exactly 1.0; a non-finite row contributes exactly zero, and a
    majority-poisoned round (a non-finite median norm) gives zero."""
    cap = _scalar(cap, frames)
    nrm = sqrt_f32(_row_energy(frames))                     # (..., m, 1)
    med = median(nrm, alive)                                # (..., 1)
    cap_abs = (cap[..., None] * torch.where(torch.isfinite(med), med, 0.0)
               )[..., None, :]                              # (..., 1, 1)
    finite = torch.isfinite(nrm)
    scale = torch.where(nrm <= cap_abs, 1.0,
                        cap_abs / torch.clamp(nrm, min=1e-30))
    scale = torch.where(finite, scale, 0.0)
    f_safe = torch.where(finite, frames, 0.0)
    return _device_sum(f_safe * scale * alive[..., None].to(frames.dtype))


def robust_combine(frames: torch.Tensor, alive: torch.Tensor, m_eff, *,
                   aggregator: str, trim_frac=0.1,
                   norm_cap=1.0) -> torch.Tensor:
    """Sum-equivalent robust combine (the digital drivers' hook): ``m_eff``
    times the robust mean, so a decode dividing by ``m_eff`` recovers the
    robust mean.  ``aggregator`` is static; the rest are tensors."""
    if aggregator in ("trimmed_mean", "median"):
        mean = (trimmed_mean(frames, alive, trim_frac)
                if aggregator == "trimmed_mean" else median(frames, alive))
        return mean * _scalar(m_eff, frames)[..., None]
    if aggregator == "norm_cap":
        return norm_capped_sum(frames, alive, norm_cap)
    raise ValueError(f"unknown aggregator {aggregator!r}; "
                     "known: mean | trimmed_mean | median | norm_cap")


def clip_frame_power(frames: torch.Tensor, p_max) -> torch.Tensor:
    """Transmit-side hardware power cap for ``(..., m, n)`` analog frames:
    rows whose energy exceeds ``p_max`` (0-dim, or ``(G,)`` one per point)
    are rescaled onto it; rows at or below it pass with scale exactly 1.0.
    An honest frame carries ``P_t``, so a cap of ``power_cap * P_t`` with
    ``power_cap > 1`` leaves it alone and flattens a Byzantine device's
    power boost."""
    p_max = _scalar(p_max, frames)[..., None, None]
    energy = _row_energy(frames)
    scale = torch.where(energy > p_max,
                        sqrt_f32(p_max / torch.clamp(energy, min=1e-30)),
                        1.0)
    return frames * scale
