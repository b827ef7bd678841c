"""Churn: arrival/departure traces and per-round availability.

The port of the reference's ``repro/population/churn.py``.  Two time
scales compose into one bool mask per round: a run-level arrival-departure
trace (device m exists during ``[arrival_m, departure_m)``, arrivals spread
over the first ``arrival_spread`` of the run, exponential lifetimes of mean
``mean_lifetime`` rounds, 0 = immortal) and a per-round Bernoulli
availability draw at rate ``avail_rate``, a compare a sweep batches.  At
the defaults every device is available every round (``uniform < 1.0``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.population.state import NEVER


def init_arrival_departure(key: torch.Tensor, m: int, steps: int,
                           arrival_spread: float = 0.0,
                           mean_lifetime: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(arrival, departure) int32 round indices per device, drawn as the
    reference draws them outside ``jit`` (each product rounded alone)."""
    k_arr, k_life = rng.split(key)
    if arrival_spread > 0:
        window = float(np.float32(max(1.0, arrival_spread * steps)))
        arrival = torch.floor(rng.uniform(k_arr, (m,)) * window).to(
            torch.int32)
    else:
        arrival = torch.zeros((m,), dtype=torch.int32, device=key.device)
    if mean_lifetime > 0:
        life = torch.ceil(rng.exponential(k_life, (m,))
                          * float(np.float32(mean_lifetime))).to(torch.int32)
        departure = arrival + torch.clamp(life, min=1)
    else:
        departure = torch.full((m,), NEVER, dtype=torch.int32,
                               device=key.device)
    return arrival, departure


def availability(arrival: torch.Tensor, departure: torch.Tensor, t,
                 key: torch.Tensor, avail_rate) -> torch.Tensor:
    """(M,) bool: device exists at round t AND is up this round; ``(G, M)``
    for ``(G, 2)`` keys and a ``(G,)`` rate."""
    present = (arrival <= t) & (t < departure)
    rate = torch.as_tensor(avail_rate, dtype=torch.float32,
                           device=key.device)
    up = rng.uniform(key, arrival.shape) < rate[..., None]
    return present & up
