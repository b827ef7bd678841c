"""Data partitioning: how M edge devices see the training set (port copy).

The port's own numpy copy of the three partitioners of the reference's
``repro/data/partition.py`` that the paper's protocols use, behind the same
entry point :func:`make_partition`:

``iid``
    Each device draws B samples uniformly without replacement (paper §VI).

``label_shards``
    The paper's two-class protocol, generalised: devices receive
    ``shards_per_device`` single-class shards each, dealt so that every
    device's classes are distinct.

``dirichlet``
    Each device's class proportions ~ Dirichlet(beta): the biased split
    behind the paper's claim that A-DSGD is the more robust to bias.

All three are deterministic given ``seed`` and draw exactly what the
reference draws, so the two packages split the same data the same way.

For M-large populations (:mod:`repro_torch.population`),
:class:`PopulationPartition` assigns shards by index arithmetic: O(N + C)
arrays, and a cohort's ``(K, B)`` rows computed on demand, on the device,
inside the round.  :func:`label_bias` measures a split's bias.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
# Dirichlet(beta)
# ---------------------------------------------------------------------------


def partition_dirichlet(y: np.ndarray, m: int, b: int, beta: float,
                        n_classes: int = 0, seed: int = 0) -> np.ndarray:
    """(m, b) indices: device class proportions ~ Dirichlet(beta).

    Samples are drawn from each class pool with replacement only when a
    pool is exhausted (heavy skew at small beta can demand more samples of
    one class than exist).
    """
    if beta <= 0:
        raise ValueError(f"beta must be > 0, got {beta}")
    n_classes = n_classes or int(y.max()) + 1
    rng = _rng(seed)
    by_class = [np.flatnonzero(y == c) for c in range(n_classes)]
    props = rng.dirichlet(np.full(n_classes, beta), size=m)
    idx = np.empty((m, b), np.int64)
    for dev in range(m):
        classes = rng.choice(n_classes, b, p=props[dev])
        counts = np.bincount(classes, minlength=n_classes)
        off = 0
        for c in range(n_classes):
            n_take = int(counts[c])
            if not n_take:
                continue
            pool = by_class[c]
            idx[dev, off:off + n_take] = rng.choice(
                pool, n_take, replace=n_take > len(pool))
            off += n_take
        rng.shuffle(idx[dev])
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
        idx = partition_dirichlet(y, m, b, beta, n_classes, seed)
    else:
        raise ValueError(
            f"unknown partition kind {kind!r}; known: {PARTITION_KINDS}")
    return x[idx], y[idx]


# ---------------------------------------------------------------------------
# population-scale shard assignment (repro_torch.population): O(M) arithmetic
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PopulationPartition:
    """Shard assignment for an M-large population as index arithmetic.

    ``iid``
        one (N,) permutation ``order``; device m's j-th sample is
        ``order[(m*B + j) mod N]``: consecutive windows of one shuffled
        epoch, wrapping once M*B > N.

    ``label_shards``
        global shard ``t = m*spd + s`` holds class ``class_perm[t mod C]``,
        and the ``u = t div C``-th use of a class reads rows ``[u*per,
        u*per + per)`` of that class's shuffled pool, wrapping mod the pool
        size.

    :meth:`sample_indices` is gather and mod arithmetic on the device of
    the ids it is given, so the population engine computes a cohort's
    ``(K, B)`` rows in the round and nothing (M, B)-sized exists.  The
    arrays are numpy, as the reference's; their device copies are made
    once per device.
    """

    kind: str
    m: int
    b: int
    n: int
    n_classes: int = 0
    order: Optional[np.ndarray] = None       # (N,) iid sample permutation
    class_perm: Optional[np.ndarray] = None  # (C,) label_shards class cycle
    pools: Optional[np.ndarray] = None       # (C, P) padded per-class pools
    sizes: Optional[np.ndarray] = None       # (C,) true pool sizes
    shards_per_device: int = 0
    _tables: Dict = field(default_factory=dict, compare=False, repr=False)

    def tables(self, device) -> Dict[str, torch.Tensor]:
        """The index arrays as int64 tensors on ``device``, copied once."""
        dev = torch.device(device)
        key = str(dev)
        if key not in self._tables:
            names = (("order",) if self.kind == "iid"
                     else ("class_perm", "pools", "sizes"))
            self._tables[key] = {
                k: torch.from_numpy(np.asarray(getattr(self, k),
                                               np.int64)).to(dev)
                for k in names}
        return self._tables[key]

    def sample_indices(self, devices) -> torch.Tensor:
        """(K, B) training-set rows of the device ids ``devices`` (K,);
        ``(G, K, B)`` for ``(G, K)`` ids."""
        dev = torch.as_tensor(devices).long()
        tab = self.tables(dev.device)
        dev = dev[..., None]
        j = torch.arange(self.b, dtype=torch.int64, device=dev.device)
        if self.kind == "iid":
            return tab["order"][(dev * self.b + j) % self.n]
        per = self.b // self.shards_per_device
        t = dev * self.shards_per_device + j // per
        cls = tab["class_perm"][t % self.n_classes]
        pos = ((t // self.n_classes) * per + j % per) % tab["sizes"][cls]
        return tab["pools"][cls, pos]

    def device_labels(self, device: int) -> np.ndarray:
        """The distinct classes device ``device`` holds (host helper)."""
        if self.kind == "iid":
            raise ValueError("iid devices have no fixed class set")
        t = device * self.shards_per_device + np.arange(
            self.shards_per_device)
        return np.asarray(self.class_perm)[t % self.n_classes]


def population_partition(y: np.ndarray, m: int, b: int, kind: str = "iid",
                         shards_per_device: int = 2, n_classes: int = 0,
                         seed: int = 0) -> PopulationPartition:
    """Build a :class:`PopulationPartition` in O(N + C), no (M, B) table.

    ``dirichlet`` is unsupported at population scale, as in the reference:
    its per-device proportion draws are O(M * C) state with no arithmetic
    shortcut.
    """
    n = len(y)
    if kind == "iid":
        return PopulationPartition(kind="iid", m=m, b=b, n=n,
                                   order=_rng(seed).permutation(n))
    if kind == "label_shards":
        n_classes = n_classes or int(y.max()) + 1
        if shards_per_device > n_classes:
            raise ValueError(
                f"population label_shards needs shards_per_device <= "
                f"n_classes; got {shards_per_device} > {n_classes}")
        if b % shards_per_device:
            raise ValueError(
                f"population label_shards needs shards_per_device | b; "
                f"got B={b}, spd={shards_per_device}")
        rng = _rng(seed)
        pools_l = [rng.permutation(np.flatnonzero(y == c))
                   for c in range(n_classes)]
        sizes = np.asarray([len(p) for p in pools_l], np.int64)
        if sizes.min() == 0:
            raise ValueError("every class needs at least one sample")
        pools = np.zeros((n_classes, int(sizes.max())), np.int64)
        for c, p in enumerate(pools_l):
            pools[c, :len(p)] = p
        return PopulationPartition(
            kind="label_shards", m=m, b=b, n=n, n_classes=n_classes,
            class_perm=rng.permutation(n_classes), pools=pools, sizes=sizes,
            shards_per_device=shards_per_device)
    raise ValueError(
        f"unknown population partition kind {kind!r}; known: "
        "('iid', 'label_shards')")


def population_label_bias(part: PopulationPartition, y: np.ndarray,
                          devices=None, n_classes: int = 0) -> float:
    """:func:`label_bias` of a population split, from a device subsample:
    only the sampled devices' label rows (O(K * B)) are materialised."""
    devices = (np.arange(part.m) if devices is None
               else np.asarray(devices))
    idx = part.sample_indices(torch.from_numpy(devices)).numpy()
    return label_bias(np.asarray(y)[idx], n_classes)


def label_bias(y_dev: np.ndarray, n_classes: int = 0) -> float:
    """Mean total-variation distance device-histogram vs global histogram.

    0 for IID class marginals; approaches (C-1)/C as every device collapses
    onto a single class.
    """
    n_classes = n_classes or int(y_dev.max()) + 1
    global_h = np.bincount(y_dev.reshape(-1), minlength=n_classes).astype(
        np.float64)
    global_h /= global_h.sum()
    tvs = []
    for dev in range(y_dev.shape[0]):
        h = np.bincount(y_dev[dev], minlength=n_classes).astype(np.float64)
        h /= h.sum()
        tvs.append(0.5 * np.abs(h - global_h).sum())
    return float(np.mean(tvs))
