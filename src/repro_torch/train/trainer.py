"""The flat-vector helpers of the reference's ``repro/train/trainer.py``.

The streamed federated LLM round (:mod:`repro_torch.train.fedllm`) needs
three of the sharded trainer's helpers, and they are ported here ahead of
the trainer itself: :func:`_pad_multiple`, :func:`abstract_params` and
:func:`ravel_meta`.  The flat layout is ``ravel_pytree``'s: a dict's keys
sorted at every level (:func:`repro_torch.convert.ravel`), so every
device and the PS agree on which gradient entry lands in which chunk.
"""
from __future__ import annotations

import functools

from repro_torch import rng
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import tree_leaves, unravel
from repro_torch.models import model as model_lib


def _pad_multiple(d: int, m: int) -> int:
    return -(-d // m) * m


@functools.lru_cache(maxsize=16)
def abstract_params(cfg: ArchConfig):
    """The model's param tree with shapes and dtypes only: the init run on
    torch's ``meta`` device, so nothing d-sized is materialised."""
    return model_lib.init_params(cfg, rng.PRNGKey(0, device="meta"))


def ravel_meta(aparams):
    """``(d, unravel)`` for an abstract param tree: the total parameter
    count and the flat-vector -> tree unraveller in ``ravel_pytree``'s leaf
    order.  ``unravel(flat)`` returns views into ``flat``."""
    d = int(sum(leaf.numel() for leaf in tree_leaves(aparams)))

    def unravel_flat(flat):
        return unravel(flat, aparams)

    return d, unravel_flat
