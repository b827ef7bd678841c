"""Carry weights and training state between the JAX package and the port.

The JAX package hands over its params, Adam state and ``(M, d)`` error
accumulators as numpy arrays (``jax.device_get``); :func:`to_torch` turns
any such tree of dicts, tuples and lists (an engine's scan carry is a
tuple) into tensors on a device, the card unless the caller names another,
and :func:`to_numpy` turns the port's trees back.  Dtypes are kept (the
Adam step count stays int32).

The flat gradient layout follows ``jax.flatten_util.ravel_pytree``, which
orders a dict's leaves by sorted key: for ``{"w": (784, 10), "b": (10,)}``
the flat vector is ``[b (10), w (7840) row-major]``, and a nested dict
sorts its keys at every level (a zoo model's ``blocks`` < ``embed`` <
``final_norm`` < ``lm_head``, each layer leaf stacked ``(n_layers,
...)``).  Which entries land in which projection block, and so every
parity case, depends on that order, so :func:`ravel` and :func:`unravel`
are the port's only flatteners.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_torch(tree, device=None):
    """numpy arrays (in nested dicts, tuples, lists) -> tensors on ``device``.

    ``device=None`` is the card (:func:`repro_torch.device.resolve_device`)
    and raises without one; CPU callers pass ``device="cpu"``.
    """
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, dev) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def to_numpy(tree):
    """tensors (in nested dicts, tuples, lists) -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tree of dicts in ``jax.tree.leaves`` order: a dict's
    keys sorted at every level, so ``{"blocks": {...}, "embed": ...}``
    gives every leaf under ``blocks`` (in its own sorted order) first."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, the other trees' matching
    leaves as further arguments; the keys in ``tree``'s order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def ravel(params, batch_dims: int = 0) -> torch.Tensor:
    """Flatten a tree of dicts of tensors in ``ravel_pytree`` order.

    With ``batch_dims=1`` every leaf carries a leading device axis that is
    kept: ``{"b": (M, 10), "w": (M, 784, 10)}`` -> ``(M, 7850)``.
    """
    leaves = tree_leaves(params)
    lead = leaves[0].shape[:batch_dims]
    return torch.cat([v.reshape(*lead, -1) for v in leaves], dim=batch_dims)


def unravel(flat: torch.Tensor, template, batch_dims: int = 0):
    """Inverse of :func:`ravel` for a tree of dicts shaped like
    ``template`` (whose leaves need only a ``shape``): views into ``flat``.

    With ``batch_dims=1`` ``flat`` and every leaf of ``template`` carry a
    leading axis that is kept: ``(G, 7850)`` -> ``{"b": (G, 10), "w": (G,
    784, 10)}``.
    """
    off = 0

    def build(node):
        nonlocal off
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        shape = tuple(node.shape)
        n = math.prod(shape[batch_dims:])
        out = flat[..., off:off + n].reshape(shape)
        off += n
        return out

    out = build(template)
    if off != flat.shape[-1]:
        raise ValueError(f"flat vector has {flat.shape[-1]} entries, the "
                         f"template {off}")
    return out
