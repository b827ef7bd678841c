"""Data partitioning: how M edge devices see the training set (port copy).

The port's own numpy copy of the two partitioners of the reference's
``repro/data/partition.py`` that the paper's protocols use, behind the same
entry point :func:`make_partition`:

``iid``
    Each device draws B samples uniformly without replacement (paper §VI).

``label_shards``
    The paper's two-class protocol, generalised: devices receive
    ``shards_per_device`` single-class shards each, dealt so that every
    device's classes are distinct.

Both are deterministic given ``seed`` and draw exactly what the reference
draws, so the two packages split the same data the same way.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

PARTITION_KINDS = ("iid", "label_shards", "dirichlet")


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# IID
# ---------------------------------------------------------------------------


def partition_iid(y: np.ndarray, m: int, b: int, seed: int = 0) -> np.ndarray:
    """(m, b) sample indices, drawn uniformly without replacement."""
    if m * b > len(y):
        raise ValueError(f"cannot place {m}x{b} samples from {len(y)}")
    return _rng(seed).choice(len(y), (m, b), replace=False)


# ---------------------------------------------------------------------------
# label shards (the paper's non-IID protocol, generalised)
# ---------------------------------------------------------------------------


def label_shard_assignment(m: int, shards_per_device: int, n_classes: int,
                           seed: int = 0) -> np.ndarray:
    """(m, shards_per_device) class ids — which classes each device holds.

    The ``m * shards_per_device`` shards form shard groups of ``n_classes``
    shards; each full group covers every class exactly once, so globally
    each class appears in exactly ``total // n_classes`` (+- 1) shards.
    When the shard count is not a multiple of ``n_classes``, the remainder
    group covers a random class subset (no repeats within the group).

    Shards are dealt so every device's classes are **distinct** (the paper
    protocol: exactly two classes per device at ``shards_per_device=2``):
    each device takes the ``shards_per_device`` classes with the most
    undealt shards, random ties — the max-remaining-first rule keeps class
    counts balanced, so no device is ever forced into a repeat (possible
    only in the degenerate ``shards_per_device > n_classes`` case, where
    repeats are unavoidable and allowed).
    """
    total = m * shards_per_device
    rng = _rng(seed)
    g, rem = divmod(total, n_classes)
    counts = np.full(n_classes, g, np.int64)
    if rem:
        counts[rng.choice(n_classes, rem, replace=False)] += 1
    assign = np.empty((m, shards_per_device), np.int64)
    for dev in rng.permutation(m):
        # distinct classes, most-undealt-shards first (random tie-break)
        priority = np.where(counts > 0, counts + rng.random(n_classes),
                            -np.inf)
        take = np.argsort(-priority)[:shards_per_device]
        take = take[counts[take] > 0]
        if len(take) < shards_per_device:      # degenerate: spd > n_classes
            take = np.concatenate([take, rng.choice(
                n_classes, shards_per_device - len(take))])
        counts[take[:shards_per_device]] -= 1
        assign[dev] = rng.permutation(take[:shards_per_device])
    return assign


def partition_label_shards(y: np.ndarray, m: int, b: int,
                           shards_per_device: int = 2, n_classes: int = 0,
                           seed: int = 0) -> np.ndarray:
    """(m, b) indices: device holds b/shards_per_device samples per shard."""
    n_classes = n_classes or int(y.max()) + 1
    assign = label_shard_assignment(m, shards_per_device, n_classes, seed)
    by_class = [np.flatnonzero(y == c) for c in range(n_classes)]
    rng = _rng(seed + 1)
    per = b // shards_per_device
    counts = [per] * (shards_per_device - 1) + [b - per * (shards_per_device - 1)]
    idx = np.empty((m, b), np.int64)
    for dev in range(m):
        off = 0
        for s, c in enumerate(assign[dev]):
            n_take = counts[s]
            pool = by_class[c]
            idx[dev, off:off + n_take] = rng.choice(
                pool, n_take, replace=n_take > len(pool))
            off += n_take
    return idx


# ---------------------------------------------------------------------------
# unified entry point
# ---------------------------------------------------------------------------


def make_partition(x: np.ndarray, y: np.ndarray, m: int, b: int,
                   kind: str = "iid", beta: float = 1.0,
                   shards_per_device: int = 2, n_classes: int = 0,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Split (x, y) into per-device tensors (x_dev (M,B,d), y_dev (M,B))."""
    if kind == "iid":
        idx = partition_iid(y, m, b, seed)
    elif kind == "label_shards":
        idx = partition_label_shards(y, m, b, shards_per_device, n_classes,
                                     seed)
    elif kind == "dirichlet":
        raise NotImplementedError("partition kind 'dirichlet' is not ported yet")
    else:
        raise ValueError(
            f"unknown partition kind {kind!r}; known: {PARTITION_KINDS}")
    return x[idx], y[idx]
