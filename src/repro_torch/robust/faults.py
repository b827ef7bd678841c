"""Deterministic fault traces: who misbehaves, when, and how.

The port of the reference's ``repro/robust/faults.py``.  A fault trace is a
pure function of ``(fault_key, round_key, device_id)``, so the engine, a
resumed run and a sweep's grid all see the same faults.  Two key streams
with different lifetimes:

* **persistent Byzantine membership** comes from the run-level
  ``fault_key`` (:func:`fault_base_key`, derived from ``OTAConfig.seed``):
  a device is Byzantine for the whole run, and since membership thresholds
  one fixed uniform draw per device, the Byzantine sets are nested in
  ``byzantine_frac``: a swept fraction grows the attacker set;
* **transient faults** (NaN/Inf frame poisoning, stale-update replay,
  mid-round dropout, digital packet erasure) redraw each round from the
  fault-salted round key (``fold_in(round_key, SALT_FAULT)``).

The draws are ``rng.uniform`` and ``rng.fold_in``, bitwise
``jax.random``'s, so every :class:`FaultDraw` field is the reference's bit
for bit.  The rates are float32 tensors: 0-dim for a run, ``(G,)`` for a
sweep's grid, each broadcast against the devices as ``[..., None]``, and
round keys ``(G, 2)`` give ``(G, m)`` draws.  The fault kind and the
attack shape are static strings.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import rng
from repro_torch.device import take

#: round-key salt owned by the fault layer (0 MAC AWGN, 1 encode, 2 channel
#: draw, 3 availability, 4 cohort sampling, 5 straggler latency)
SALT_FAULT = 6

#: decorrelates the run-level Byzantine stream from the fading stream
FAULT_SEED_SALT = 0x0FA1175


def fault_base_key(seed: int, device=None) -> torch.Tensor:
    """Run-level key anchoring the persistent Byzantine membership: a
    function of ``OTAConfig.seed``, not of the round keys, so a ``seed``
    sweep axis holds the Byzantine set fixed across its points."""
    return rng.PRNGKey(seed ^ FAULT_SEED_SALT, device=device)


class FaultDraw(NamedTuple):
    """One round's fault realisation over ``m`` devices, ``(..., m)`` bool
    each.  ``byz`` is the persistent Byzantine set; one of ``poison`` /
    ``stale`` / ``dropout`` carries the transient draw (the static
    ``fault_kind`` picks which; the others are all False); ``erased`` is the
    independent digital packet-erasure draw; ``poison_value`` is the static
    NaN/Inf payload."""
    byz: torch.Tensor
    poison: torch.Tensor
    stale: torch.Tensor
    dropout: torch.Tensor
    erased: torch.Tensor
    poison_value: float = float("nan")


def _rate(v, device) -> torch.Tensor:
    """A rate (float, 0-dim or ``(G,)``) as float32, shaped to broadcast
    against a trailing device axis."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)[..., None]


def byzantine_set(fault_key: torch.Tensor, m: int,
                  byzantine_frac) -> torch.Tensor:
    """``(m,)`` bool persistent Byzantine membership, nested in the
    fraction; ``(G, m)`` for a ``(G,)`` fraction."""
    u = rng.uniform(fault_key, (m,))
    return u < _rate(byzantine_frac, u.device)


def fault_draw(fault_key: torch.Tensor, key: torch.Tensor, m: int, *,
               byzantine_frac, fault_rate, erasure_prob,
               fault_kind: str = "nan") -> FaultDraw:
    """The fault trace of one round.  ``key`` is the fault-salted round key
    (``fold_in(round_key, SALT_FAULT)``), ``(G, 2)`` for G points."""
    if fault_kind not in ("nan", "inf", "stale", "dropout"):
        raise ValueError(f"unknown fault_kind {fault_kind!r}; "
                         "known: nan | inf | stale | dropout")
    byz = byzantine_set(fault_key, m, byzantine_frac)
    hit = rng.uniform(key, (m,)) < _rate(fault_rate, key.device)
    erased = (rng.uniform(rng.fold_in(key, 1), (m,))
              < _rate(erasure_prob, key.device))
    none = torch.zeros_like(hit)
    return FaultDraw(
        byz=byz,
        poison=hit if fault_kind in ("nan", "inf") else none,
        stale=hit if fault_kind == "stale" else none,
        dropout=hit if fault_kind == "dropout" else none,
        erased=erased,
        poison_value=float("inf") if fault_kind == "inf" else float("nan"),
    )


def apply_gradient_faults(grads: torch.Tensor, fault: FaultDraw, *,
                          byz_attack: str = "sign_flip",
                          byz_scale=10.0) -> torch.Tensor:
    """Device-side (pre-encode) gradient transforms of ``(..., m, d)``
    gradients: a Byzantine device sends ``-byz_scale * g`` (``sign_flip``)
    or ``byz_scale * g`` (``scale``); a stale device sends g = 0, so its
    encode replays what its error accumulator banked.  Poisoning, dropout
    and erasure act on the frame and the transmit set, in the drivers."""
    if byz_attack not in ("sign_flip", "scale"):
        raise ValueError(f"unknown byz_attack {byz_attack!r}; "
                         "known: sign_flip | scale")
    sgn = -1.0 if byz_attack == "sign_flip" else 1.0
    scale = sgn * torch.as_tensor(byz_scale, dtype=grads.dtype,
                                  device=grads.device)
    g = torch.where(fault.byz[..., None], scale[..., None, None] * grads,
                    grads)
    return torch.where(fault.stale[..., None], 0.0, g)


def apply_frame_faults(frames: torch.Tensor, fault: FaultDraw) -> torch.Tensor:
    """Air-interface poisoning: a faulty transmitter's whole frame is the
    NaN/Inf payload.  Applied after encode and after any transmit-side
    power clip (a limiter cannot repair a broken DAC)."""
    value = torch.tensor(fault.poison_value, dtype=frames.dtype,
                         device=frames.device)
    return torch.where(fault.poison[..., None], value, frames)


def take_rows(fault: FaultDraw, cohort: torch.Tensor) -> FaultDraw:
    """The cohort's rows of a full-population fault draw; a ``(G, K)``
    cohort takes each point's own rows."""
    return FaultDraw(*(take(v, cohort, v.dim() - 1) for v in fault[:5]),
                     fault.poison_value)
