"""Subband scheduling: which devices transmit on which subband each round.

The port of the reference's ``repro/core/scheduling.py``.  A
:class:`Scheduler` is registered under a name and resolved from an
``OTAConfig`` by :func:`get_scheduler` (``scheduler="none"`` resolves to
``None``: no scheduling op runs).  :func:`schedule` turns the scheduler's
per-device priorities into the round's transmit set, the top
``n_subbands`` by a stable ranking, with masked-out devices ranked last; the
only carried piece is prop_fair's ``(m,)`` average-rate vector, which
rides the engine's carry.

Every function takes a leading point axis: gains ``(G, m)``, a ``(G,)``
``n_subbands`` and a ``(G, m)`` state rank and update each point on its
own (an argsort per row, elementwise updates).  The arithmetic is the
reference's as its ``jit`` compiles it: XLA's ``log1p``, the average's
update fused into one multiply-add, and the division by the constant
horizon a product with its float32 reciprocal.

Schedulers: ``round_robin`` (round t serves ``(t*S + j) mod M``),
``gain_ranked`` (the S largest received-power factors) and ``prop_fair``
(``log1p(gain)`` over an exponentially averaged served rate).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.fading import point_scalar

#: round-key salt for the scheduler draw (0 MAC AWGN, 1 encode, 2 channel,
#: 3 availability, 4 cohort sampling, 5 straggler latency, 6 fault trace)
SALT_SCHED = 7

SCHEDULER_REGISTRY: Dict[str, Type["Scheduler"]] = {}


def register_scheduler(name: str):
    """Class decorator: register a Scheduler subclass under ``name``."""
    def deco(cls: Type["Scheduler"]) -> Type["Scheduler"]:
        cls.name = name
        SCHEDULER_REGISTRY[name] = cls
        return cls
    return deco


def registered_schedulers() -> Tuple[str, ...]:
    """Every registered scheduler name (registration order)."""
    return tuple(SCHEDULER_REGISTRY)


def get_scheduler(cfg) -> Optional["Scheduler"]:
    """Resolve ``cfg.scheduler`` through the registry; ``"none"`` is
    ``None``.  A real scheduler needs ``n_subbands >= 1``."""
    if cfg.scheduler == "none":
        return None
    try:
        cls = SCHEDULER_REGISTRY[cfg.scheduler]
    except KeyError:
        raise KeyError(
            f"unknown scheduler {cfg.scheduler!r}; registered: "
            f"{', '.join(sorted(SCHEDULER_REGISTRY))}") from None
    if cfg.n_subbands < 1:
        raise ValueError(
            f"scheduler {cfg.scheduler!r} needs n_subbands >= 1; got "
            f"{cfg.n_subbands}")
    return cls(cfg)


def _floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.mod``: the C remainder (exact), moved into the divisor's sign
    where it is non-zero and of the other sign."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


class Scheduler:
    """Base scheduler: a priority rule plus an optional ``(m,)`` float32
    state (``has_state``)."""

    name: str = "?"
    has_state: bool = False

    def __init__(self, cfg):
        self.cfg = cfg

    def init_state(self, m: int, device=None) -> torch.Tensor:
        """``(m,)`` carried scheduler state (read only when ``has_state``)."""
        return torch.zeros((m,), dtype=torch.float32, device=device)

    def priority(self, key, t, gains, state, n_subbands) -> torch.Tensor:
        """``(..., m)`` per-device priority, pure in its inputs."""
        raise NotImplementedError

    def update(self, state, gains, scheduled) -> torch.Tensor:
        """Next round's carried state (only called when ``has_state``)."""
        return state


@register_scheduler("round_robin")
class RoundRobinScheduler(Scheduler):
    """Deterministic cycle: round t serves devices ``(t*S + j) mod M``,
    realised as the priority ``-((idx - t*S) mod M)``; S is rounded to the
    nearest integer (ties to even)."""

    def priority(self, key, t, gains, state, n_subbands):
        m = gains.shape[-1]
        s = torch.round(point_scalar(n_subbands, gains.device))
        offset = _floor_mod(float(np.float32(t)) * s, float(m))
        idx = torch.arange(m, dtype=torch.float32, device=gains.device)
        return -_floor_mod(idx - offset, float(m))


@register_scheduler("gain_ranked")
class GainRankedScheduler(Scheduler):
    """Max-SNR: serve the S devices with the largest received-power
    factors this round (post-geometry, post-fading)."""

    def priority(self, key, t, gains, state, n_subbands):
        return gains.to(torch.float32)


@register_scheduler("prop_fair")
class PropFairScheduler(Scheduler):
    """Proportional fairness: priority ``log1p(gain) / max(avg, eps)``; the
    served average updates as ``avg' = (1 - 1/tc) avg + (1/tc) r *
    scheduled`` with the static horizon ``tc = cfg.pf_horizon``."""

    has_state = True
    _EPS = 1e-6

    def priority(self, key, t, gains, state, n_subbands):
        rate = rng.log1p(gains.to(torch.float32))
        return rate / torch.clamp(state, min=float(np.float32(self._EPS)))

    def update(self, state, gains, scheduled):
        tc = np.float32(max(float(self.cfg.pf_horizon), 1.0))
        keep = float(np.float32(1.0) - np.float32(1.0) / tc)
        inv_tc = float(np.float32(1.0) / tc)
        rate = rng.log1p(gains.to(torch.float32))
        served = rate * scheduled.to(torch.float32)
        return rng.fma_f32(torch.full_like(state, keep), state,
                           served * inv_tc)


def schedule(scheduler: Scheduler, key: torch.Tensor, t, gains: torch.Tensor,
             n_subbands, state: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One round's transmit set: ``(scheduled (..., m) bool, new_state)``.

    Masked-out devices rank last (priority -inf) and are never scheduled;
    the ranking is a stable argsort, so ties break by device index.
    ``new_state`` is ``None`` for stateless schedulers; the caller keeps a
    masked device's state.
    """
    prio = scheduler.priority(key, t, gains, state, n_subbands)
    if mask is not None:
        prio = torch.where(mask, prio, -torch.inf)
    order = torch.argsort(-prio, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True).to(torch.float32)
    scheduled = rank < point_scalar(n_subbands, gains.device)
    if mask is not None:
        scheduled = scheduled & mask
    new_state = (scheduler.update(state, gains, scheduled)
                 if scheduler.has_state else None)
    return scheduled, new_state
