"""Deterministic synthetic data pipelines, the port's own numpy copies.

* :class:`TokenStream` — language-model token batches for the zoo models:
  a fixed-seed Markov-ish stream (a bigram permutation mixed with noise) so
  the loss has learnable structure; sharded per data-parallel replica.
* :func:`make_classification` stands in for MNIST: 10-class 28x28 "images"
  drawn from class-conditioned low-rank Gaussian templates (60k train /
  10k test, d = 7850 for the single-layer model).

Both are copies of the reference's ``repro/data/synthetic.py`` functions of
the same names, so both packages build the same arrays from the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass
class TokenStream:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        """Deterministic batch for (step, shard): int32 tokens
        ``(batch / n_shards, seq_len)``."""
        if self.batch % n_shards:
            raise ValueError(f"batch {self.batch} does not split over "
                             f"{n_shards} shards")
        b = self.batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        # structured stream: x_t follows x_{t-1} through a fixed
        # permutation, mixed with noise -> learnable bigram structure
        perm = np.random.default_rng(self.seed).permutation(self.vocab)
        toks = np.empty((b, self.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        noise = rng.integers(0, self.vocab, (b, self.seq_len))
        follow = rng.random((b, self.seq_len)) < 0.8
        for t in range(1, self.seq_len):
            toks[:, t] = np.where(follow[:, t], perm[toks[:, t - 1]],
                                  noise[:, t])
        return {"tokens": toks}


def make_classification(n_train: int = 60000, n_test: int = 10000,
                        n_classes: int = 10, dim: int = 784, seed: int = 0,
                        rank: int = 16, noise: float = 0.9):
    """Class-conditioned low-rank Gaussian images, normalised like MNIST."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(n_classes, dim)).astype(np.float32)
    factors = rng.normal(size=(n_classes, rank, dim)).astype(np.float32) / np.sqrt(rank)

    def sample(n, seed2):
        r = np.random.default_rng(seed2)
        y = r.integers(0, n_classes, n)
        z = r.normal(size=(n, rank)).astype(np.float32)
        x = templates[y] + np.einsum("nr,nrd->nd", z, factors[y]) * 0.5
        x = x + noise * r.normal(size=(n, dim)).astype(np.float32)
        x = (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-6)
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train, seed + 1)
    x_te, y_te = sample(n_test, seed + 2)
    return (x_tr, y_tr), (x_te, y_te)


def federated_split(x: np.ndarray, y: np.ndarray, m: int, b: int,
                    iid: bool = True, n_classes: int = 10, seed: int = 0,
                    kind: str = "", beta: float = 1.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Assign B samples to each of M devices (paper §VI).

    Thin front-end over :mod:`repro_torch.data.partition`.  ``iid`` keeps the
    paper's two protocols (uniform / two classes per device); ``kind``
    overrides it with any registered partitioner (``iid`` |
    ``label_shards`` | ``dirichlet``).  Returns (x_dev (M, B, d), y_dev (M, B)).
    """
    from repro_torch.data.partition import make_partition
    if not kind:
        kind = "iid" if iid else "label_shards"
    return make_partition(x, y, m, b, kind=kind, beta=beta,
                          n_classes=n_classes, seed=seed)
