"""Deterministic (seed, t)-keyed cohort sampling.

The port of the reference's ``repro/population/sampler.py``.  Each round
draws K of the available devices uniformly without replacement by the
Gumbel-top-k trick: an iid Gumbel score per device, ``-inf`` for the
unavailable ones, the K best taken.  The draw is a pure function of the
round key (``fold_in(round_key, SALT_SAMPLE)``).

The cohort is returned sorted by device id, so the K == M cohort is
``arange(M)`` and the round matches the dense engine bitwise.  Each row's
pre-sort score rank comes with it: masking ``rank >= k_active`` keeps the
top ``k_active`` scores, which puts K on a batched sweep axis.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import rng


def sample_cohort(key: torch.Tensor, avail: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw K participants from the available devices.

    ``avail``: (M,) bool availability this round; ``(G, M)`` with ``(G,
    2)`` keys for G points.  Returns ``(cohort, member, rank)``: device ids
    (K,) sorted ascending; a bool mask of the rows that are genuinely
    available (with fewer than K devices up, the tail rows are unavailable
    fillers the caller masks out); and each row's score rank in [0, K).

    With fewer than K devices up, scores tie at ``-inf``; the reference's
    ``lax.top_k`` then takes the lower index first.  ``torch.topk`` orders
    no ties, so the K best come from a stable descending sort, which keeps
    equal scores in index order.
    """
    m = avail.shape[-1]
    if not 0 < k <= m:
        raise ValueError(f"need 0 < k <= M; got k={k}, M={m}")
    score = rng.gumbel(key, (m,)) + torch.where(avail, 0.0, -torch.inf)
    ids = torch.sort(score, dim=-1, descending=True, stable=True).indices
    ids = ids[..., :k]
    order = torch.argsort(ids, dim=-1)
    cohort = torch.gather(ids, -1, order)
    return cohort, torch.gather(avail, -1, cohort), order
