"""Serving: prefill + one-token decode steps of a zoo model.

The port of the reference's ``repro/train/serve.py``.  OTA-DSGD is a
training-time technique; serving has no gradient aggregation, so a serve
step is plain decoding: :func:`repro_torch.models.model.decode_step` under
the placement the reference declares (params over ``'model'``, the batch
over the data axes, each KV cache over batch -> data and one inner dim ->
model).  The spec trees are those of the reference.

Serve-while-train (:func:`repro_torch.train.fedllm.serve_while_train`):
the streamed federated trainer hands each round's decoded global params to
:meth:`ServeStep.publish`, which puts the tree on the serve device with no
host copy (on one rank: the same tensors, as the reference's donated
identity returns them), and ``decode_fn`` answers requests against
whichever published tree the caller holds.

On a mesh of more than one rank the placement is metadata, as the sharded
trainer's (:mod:`repro_torch.train.trainer`): the spec trees are the
reference's for that mesh, and the tensors live whole on the serve device,
where one card's ranks would share its memory anyway.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.sharding import P
from repro_torch.sharding.specs import named_sharding_tree, param_specs
from repro_torch.train.trainer import abstract_params


def _cache_leaf_spec(shape, data_axes, axis_sizes) -> P:
    """(layers, B, ...) cache leaf: B over data axes, one inner dim -> model."""
    model = axis_sizes.get("model", 1)
    data = math.prod(axis_sizes[a] for a in data_axes) if data_axes else 1
    spec = [None] * len(shape)
    if len(shape) >= 2 and data > 1 and shape[1] % data == 0:
        spec[1] = data_axes if len(data_axes) > 1 else data_axes[0]
    if model > 1:
        for dim in range(2, len(shape)):
            if shape[dim] % model == 0 and shape[dim] >= model:
                spec[dim] = "model"
                break
    return P(*spec)


@dataclasses.dataclass
class ServeStep:
    arch: ArchConfig
    mesh: Any
    batch: int
    max_len: int
    decode_window: Optional[int]
    param_sharding: Any
    cache_sharding: Any
    decode_fn: Callable       # (params, cache, token, pos[, enc_out])
    prefill_fn: Callable      # (params, cache, tokens[, enc_out])
    publish_fn: Callable      # params -> params on the serve device
    device: Any = None

    def init_cache(self, dtype=torch.bfloat16):
        return model_lib.init_decode_cache(self.arch, self.batch,
                                           self.max_len, dtype,
                                           self.decode_window,
                                           device=self.device)

    def publish(self, params):
        """Swap a freshly decoded global param tree into the serve
        placement, device-side.  The caller treats its argument as
        consumed and serves from the returned tree."""
        return self.publish_fn(params)


def make_serve_step(arch: ArchConfig, mesh, batch: int, max_len: int,
                    decode_window: Optional[int] = None,
                    compute_dtype=torch.bfloat16,
                    cache_dtype=torch.bfloat16, device=None) -> ServeStep:
    """The serve step of ``arch`` for ``batch`` requests of up to
    ``max_len`` positions, on ``device`` (the card unless the caller names
    another).

    ``decode_fn(params, cache, token (B, 1), pos[, enc_out])`` returns the
    float32 logits ``(B, 1, V)`` and the cache; ``prefill_fn(params,
    cache, tokens (B, L)[, enc_out])`` runs one decode step per prompt
    position from position 0 and returns the last step's logits and the
    cache.  Both consume ``cache`` (its KV caches are written in place).
    """
    dev = resolve_device(device)
    axis_sizes = dict(zip(mesh.axis_names, mesh.shape))
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    pspecs = param_specs(abstract_params(arch), axis_sizes.get("model", 1))
    acache = model_lib.init_decode_cache(arch, batch, max_len, cache_dtype,
                                         decode_window, device="meta")
    cspecs = tree_map(
        lambda lf: _cache_leaf_spec(tuple(lf.shape), data_axes, axis_sizes),
        acache)

    def decode(params, cache, token, pos, enc_out=None):
        return model_lib.decode_step(
            params, arch, token, cache, pos, enc_out=enc_out,
            compute_dtype=compute_dtype, decode_window=decode_window)

    def prefill(params, cache, tokens, enc_out=None):
        # one decode step per prompt position: arch-generic (every family
        # defines decode_step), as the reference's scan of decode steps
        logits = None
        for i in range(tokens.shape[1]):
            logits, cache = decode(params, cache, tokens[:, i:i + 1], i,
                                   enc_out)
        return logits, cache

    def publish(params):
        # on the serve device already: the same tensors, no copy
        return tree_map(lambda a: a.to(dev), params)

    return ServeStep(arch=arch, mesh=mesh, batch=batch, max_len=max_len,
                     decode_window=decode_window,
                     param_sharding=named_sharding_tree(mesh, pspecs),
                     cache_sharding=named_sharding_tree(mesh, cspecs),
                     decode_fn=decode, prefill_fn=prefill,
                     publish_fn=publish, device=dev)
