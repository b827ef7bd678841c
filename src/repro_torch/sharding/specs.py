"""Parameter and cache partition specs, as pure functions of shapes.

The port of the reference's ``repro/sharding/specs.py`` over the port's
:class:`~repro_torch.sharding.P` and :class:`~repro_torch.sharding.Mesh`.
Rule-based: for every param leaf, shard the widest dimension divisible by
the ``'model'`` axis size (skipping the leading layer-stack dimension of
the stacked blocks); replicate otherwise.  MoE expert tensors shard the
expert dim when divisible (expert parallelism); embeddings and the LM head
shard the vocab.  Batch dims of inputs and caches shard over the data axes
(at the call sites).

A leaf's path is the reference's ``jax.tree_util.keystr`` of it
(``"['blocks']['attn']['wq']"``), so the stacked-root rule reads the same
string in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.convert import tree_map
from repro_torch.sharding import Mesh, P

_STACKED_ROOTS = ("blocks", "encoder")


def _leaf_spec(path: str, shape, model_size: int, model_axis: str = "model"):
    if model_size <= 1 or len(shape) == 0:
        return P()
    start = 1 if any(f"'{r}'" in path or f"/{r}/" in path or
                     path.startswith(r) for r in _STACKED_ROOTS) else 0
    ndim = len(shape)
    dims = list(range(start, ndim))
    # divisible dims first, the widest of them first; equal keys keep the
    # earlier dim (``sorted`` stays stable under ``reverse``)
    for dim in sorted(dims, key=lambda i: (shape[i] % model_size == 0,
                                           shape[i]), reverse=True):
        if shape[dim] % model_size == 0 and shape[dim] >= model_size:
            spec = [None] * ndim
            spec[dim] = model_axis
            return P(*spec)
    return P()


def _specs(node, path: str, model_size: int, model_axis: str):
    if isinstance(node, dict):
        return {k: _specs(v, f"{path}['{k}']", model_size, model_axis)
                for k, v in node.items()}
    return _leaf_spec(path, tuple(node.shape), model_size, model_axis)


def param_specs(params: Any, model_size: int, model_axis: str = "model"):
    """The :class:`P` tree matching ``params`` (a tree of dicts whose
    leaves need only a ``shape``)."""
    return _specs(params, "", model_size, model_axis)


def spec_tree_like(tree: Any, spec) -> Any:
    return tree_map(lambda _: spec, tree)


@dataclass(frozen=True)
class NamedSharding:
    """A spec placed on a mesh: ``jax.sharding.NamedSharding``'s pair."""
    mesh: Mesh
    spec: P


def named_sharding_tree(mesh: Mesh, specs: Any) -> Any:
    """Map a :class:`P` tree to :class:`NamedSharding` leaves on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)
