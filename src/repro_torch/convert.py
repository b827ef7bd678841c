"""Carry weights and training state between the JAX package and the port.

The JAX package hands over its params, Adam state and ``(M, d)`` error
accumulators as numpy arrays (``jax.device_get``); :func:`to_torch` turns
any such tree of dicts, tuples and lists (an engine's scan carry is a
tuple) into tensors on a device, the card unless the caller names another,
and :func:`to_numpy` turns the port's trees back.  Dtypes are kept (the
Adam step count stays int32).

The flat gradient layout follows ``jax.flatten_util.ravel_pytree``, which
orders a dict's leaves by sorted key: for ``{"w": (784, 10), "b": (10,)}``
the flat vector is ``[b (10), w (7840) row-major]``.  Which entries land in
which projection block, and so every parity case, depends on that order,
so :func:`ravel` and :func:`unravel` are the port's only flatteners.
"""
from __future__ import annotations

from typing import Dict

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


def ravel(params: Dict[str, torch.Tensor], batch_dims: int = 0) -> torch.Tensor:
    """Flatten a dict of tensors in ``ravel_pytree`` order (sorted keys).

    With ``batch_dims=1`` every leaf carries a leading device axis that is
    kept: ``{"b": (M, 10), "w": (M, 784, 10)}`` -> ``(M, 7850)``.
    """
    leaves = [params[k] for k in sorted(params)]
    lead = leaves[0].shape[:batch_dims]
    return torch.cat([v.reshape(*lead, -1) for v in leaves], dim=batch_dims)


def unravel(flat: torch.Tensor,
            template: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`ravel` for a dict shaped like ``template``."""
    out, off = {}, 0
    for k in sorted(template):
        n = template[k].numel()
        out[k] = flat[off:off + n].reshape(template[k].shape)
        off += n
    if off != flat.shape[0]:
        raise ValueError(f"flat vector has {flat.shape[0]} entries, the "
                         f"template {off}")
    return out
