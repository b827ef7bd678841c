"""Banked, shard-addressed per-device state for M-large populations.

The port of the reference's ``repro/population/state.py``.  The dense
engine carries per-device state as ``(M, d)`` tensors, which caps M at a
few dozen.  Here the population's d-sized state (error accumulators) is
*banked*: a ``(n_banks, bank_size, d)`` tensor addressed by ``slot =
device_id % S`` (``S = n_banks * bank_size`` slots), with gather / scatter
cohort views, so a round only touches ``(K, d)`` rows.

``capacity == m_total`` (the default) gives every device its own slot: error
feedback is exact, and a K == M cohort is the dense engine bitwise.
``capacity < m_total`` makes the banks a direct-mapped cache: devices that
share a slot evict each other, and an evicted device restarts from the cold
state ``Delta = 0``.  An ``owner`` tag per slot detects cold slots.

A sweep's grid keeps one set of banks per point: every function here also
takes banks with a leading point axis ``G`` and ``(G, K)`` cohorts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.device import div_f32, resolve_device


@dataclass(frozen=True)
class PopulationConfig:
    """Static description of one device population.

    ``m_total`` devices keep persistent state; each round samples a
    ``k_cohort``-device cohort.  ``capacity`` (0 = ``m_total``) bounds the
    banked error-feedback slots; ``bank_size`` sets the bank granularity.
    The churn, straggler and hierarchy fields parameterise the availability,
    latency and edge-site models; ``avail_rate``, ``straggler_deadline``
    and the two site-noise scalars are per-round data a sweep batches.
    """

    m_total: int
    k_cohort: int
    bank_size: int = 256
    capacity: int = 0  # 0 => one slot per device (exact error feedback)
    # churn: arrival/departure trace + per-round Bernoulli availability
    arrival_spread: float = 0.0  # fraction of the run over which devices arrive
    mean_lifetime: float = 0.0  # mean rounds before departure; 0 => immortal
    avail_rate: float = 1.0  # per-round availability probability (batched)
    # stragglers: lognormal compute speeds, exponential latency, deadline
    speed_sigma: float = 0.0  # lognormal sigma of per-device slowdown
    straggler_deadline: float = float("inf")  # round deadline (batched)
    # large-scale channel gains (received-power factors, static per device)
    shadowing_sigma_db: float = 0.0
    # hierarchy: devices -> edge-site partial OTA sums -> backhaul combine
    n_sites: int = 1
    site_noise_scale: float = 1.0  # per-site AWGN variance scale (batched)
    backhaul_sigma2: float = 0.0  # inter-site combine noise (batched)
    # robust backhaul: trimmed mean over the sites' partials (static; 0.0
    # keeps the plain sum)
    site_trim_frac: float = 0.0
    seed: int = 0

    def __post_init__(self) -> None:
        if not 0 < self.k_cohort <= self.m_total:
            raise ValueError(
                f"k_cohort must be in (0, m_total]; got K={self.k_cohort}, "
                f"M={self.m_total}"
            )
        if self.capacity < 0 or self.bank_size <= 0 or self.n_sites <= 0:
            raise ValueError("capacity/bank_size/n_sites must be positive")

    @property
    def state_capacity(self) -> int:
        return self.capacity or self.m_total

    @property
    def n_banks(self) -> int:
        return -(-self.state_capacity // self.bank_size)


class BankedState(NamedTuple):
    """Direct-mapped banked store of per-device ``(d,)`` vectors."""

    deltas: torch.Tensor  # (n_banks, bank_size, d) error accumulators
    owner: torch.Tensor  # (n_banks, bank_size) int32 device id, -1 = empty


class PopulationState(NamedTuple):
    """The whole population's persistent state.

    Only ``banks`` evolves round to round (it rides the carry); the
    ``(M,)`` fields are drawn once per run.
    """

    banks: BankedState
    gains: torch.Tensor  # (M,) large-scale received-power factors
    speed: torch.Tensor  # (M,) compute slowdown factors (>= 0)
    arrival: torch.Tensor  # (M,) int32 first round the device exists
    departure: torch.Tensor  # (M,) int32 first round after it leaves
    site: torch.Tensor  # (M,) int32 edge-site assignment


#: departure round of an immortal device (any int32 far above any horizon)
NEVER = 1 << 30


def init_banks(capacity: int, bank_size: int, d: int, dtype=torch.float32,
               device=None, points: Optional[int] = None) -> BankedState:
    """All-cold banks: ``ceil(capacity / bank_size)`` banks, owner = -1,
    with a leading axis of ``points`` for a grid."""
    n_banks = -(-capacity // bank_size)
    lead = () if points is None else (points,)
    dev = resolve_device(device)
    return BankedState(
        deltas=torch.zeros((*lead, n_banks, bank_size, d), dtype=dtype,
                           device=dev),
        owner=torch.full((*lead, n_banks, bank_size), -1, dtype=torch.int32,
                         device=dev),
    )


def _address(banks: BankedState, cohort: torch.Tensor):
    """(bank, slot) coordinates of each cohort device (direct-mapped), and
    the point index of each row (``None`` without a point axis)."""
    bank_size = banks.owner.shape[-1]
    n_slots = banks.owner.shape[-2] * bank_size
    slot = cohort.long() % n_slots
    point = None
    if cohort.dim() == 2:
        point = torch.arange(cohort.shape[0], device=cohort.device)[:, None]
        point = point.expand(cohort.shape)
    return point, slot // bank_size, slot % bank_size


def _index(point, b, s):
    return (b, s) if point is None else (point, b, s)


def gather_cohort(banks: BankedState, cohort: torch.Tensor) -> torch.Tensor:
    """``(K, d)`` cohort view of the banked state; cold slots read as zeros.

    A slot is live for a device iff its owner tag is the device's id: a
    fresh or evicted device reads the cold state ``Delta = 0``."""
    idx = _index(*_address(banks, cohort))
    live = banks.owner[idx].long() == cohort.long()
    return torch.where(live[..., None], banks.deltas[idx],
                       torch.zeros((), dtype=banks.deltas.dtype,
                                   device=cohort.device))


def scatter_cohort(banks: BankedState, cohort: torch.Tensor,
                   new_deltas: torch.Tensor) -> BankedState:
    """Write the cohort's updated accumulators back, claiming the slots.

    With capacity < m_total two cohort devices can share a slot; the lowest
    device id (the earliest row: cohorts are sorted) wins.  Torch has no
    scatter that drops rows, so every row of a shared slot writes the
    winner's row and id: the writes agree, whatever their order.  The banks
    are copied, not written in place (a guard may restore the old ones).
    """
    point, b, s = _address(banks, cohort)
    same = (b[..., :, None] == b[..., None, :]) & (s[..., :, None]
                                                   == s[..., None, :])
    winner = same.to(torch.int8).argmax(dim=-1)    # the first such row
    rows = torch.gather(cohort.long(), -1, winner)
    vals = torch.gather(new_deltas, -2, winner[..., None].expand(
        new_deltas.shape))
    idx = _index(point, b, s)
    return BankedState(
        deltas=banks.deltas.index_put(idx, vals.to(banks.deltas.dtype)),
        owner=banks.owner.index_put(idx, rows.to(torch.int32)),
    )


def init_population(pop: PopulationConfig, d: int, steps: int,
                    dtype=torch.float32, key: Optional[torch.Tensor] = None,
                    device=None) -> PopulationState:
    """Draw the run-level per-device arrays and allocate cold banks.

    ``steps`` anchors the arrival trace: a fraction ``arrival_spread`` of the
    run is the window over which devices first appear.  The reference draws
    these arrays eagerly, outside ``jit``, so each product and division here
    rounds on its own (``10 ** (db / 10)`` through XLA's ``powf``).
    """
    from repro_torch.population import churn, hierarchy, stragglers

    dev = resolve_device(device)
    if key is None:
        key = rng.PRNGKey(pop.seed, device=dev)
    m = pop.m_total
    k_gain, k_speed, k_churn = rng.split(key, 3)
    if pop.shadowing_sigma_db > 0:
        db = float(np.float32(pop.shadowing_sigma_db)) * rng.normal(k_gain,
                                                                    (m,))
        gains = rng.pow_f32(torch.full_like(db, 10.0), div_f32(db, 10.0))
    else:
        gains = torch.ones((m,), dtype=torch.float32, device=dev)
    arrival, departure = churn.init_arrival_departure(
        k_churn, m, steps, pop.arrival_spread, pop.mean_lifetime)
    return PopulationState(
        banks=init_banks(pop.state_capacity, pop.bank_size, d, dtype, dev),
        gains=gains,
        speed=stragglers.init_speed(k_speed, m, pop.speed_sigma),
        arrival=arrival,
        departure=departure,
        site=torch.from_numpy(hierarchy.site_assignment(m, pop.n_sites)).to(
            dev),
    )
