"""Checkpointing: trees of tensors <-> npz, in the reference's layout.

The port of ``repro/train/checkpoint.py``, file for file: a checkpoint the
JAX engine writes resumes in the port, and one the port writes loads with
the reference's ``load_checkpoint``.  The layout:

* keys are ``/``-joined paths; a tuple or list entry is ``#i``;
* empty containers are zero-length int8 sentinel leaves under
  ``__empty_dict__`` / ``__empty_tuple__``;
* the step is ``meta/step`` (int64), beside the tree under ``state/``;
* bfloat16, which npz cannot hold, is stored as a uint16 bit view under
  ``path::bfloat16`` and viewed back (the reference stores its other
  extended dtypes the same way; the port holds none of them and raises).

Tensors are gathered to the host to write and come back on the device the
caller names (the card unless it names another).  Writes are atomic: the
file is written beside its target and moved into place by ``os.replace``.
Tuples come back as tuples (the reference's NamedTuples do too), so a
restored carry is rebuilt against a template by
:func:`repro_torch.experiments.engine._restore_carry`.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

_EMPTY_DICT = "__empty_dict__"
_EMPTY_TUPLE = "__empty_tuple__"


def _encode_leaf(leaf) -> tuple:
    """(key suffix, storable numpy array) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return "::bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        return "", t.numpy()
    return "", np.asarray(leaf)


def _decode_leaf(key: str, val: np.ndarray, device) -> tuple:
    """Invert :func:`_encode_leaf`: (path, tensor of the original dtype)."""
    if "::" in key:
        path, name = key.rsplit("::", 1)
        if name != "bfloat16":
            raise ValueError(f"checkpoint leaf {path!r} has dtype {name!r}, "
                             "which the port does not hold")
        bits = torch.from_numpy(np.array(val, copy=True).view(np.int16))
        return path, bits.view(torch.bfloat16).to(device)
    return key, torch.from_numpy(np.array(val, copy=True)).to(device)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}{_EMPTY_DICT}"] = np.zeros((0,), np.int8)
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[f"{prefix}{_EMPTY_TUPLE}"] = np.zeros((0,), np.int8)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        suffix, arr = _encode_leaf(tree)
        out[prefix[:-1] + suffix] = arr
    return out


def _unflatten(flat: Dict[str, np.ndarray], device) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        key, val = _decode_leaf(key, val, device)
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if _EMPTY_DICT in node:
            return {}
        if _EMPTY_TUPLE in node:
            return ()
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return tuple(fix(v) for _, v in items)
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_checkpoint(path: str, state: Any, step: int = 0) -> None:
    """Write ``state`` (dicts, tuples, lists of tensors or arrays) and
    ``step`` to ``path``, atomically."""
    flat = _flatten({"state": state, "meta": {"step": np.asarray(int(step))}})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str, device=None):
    """Returns ``(state, step)`` with the state's tensors on ``device`` (the
    card unless the caller names another); ``step`` is the saved int (0 for
    a file without a ``meta`` block)."""
    dev = resolve_device(device)
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    step = int(flat.pop("meta/step")) if "meta/step" in flat else 0
    tree = _unflatten(flat, dev)
    if isinstance(tree, dict):
        tree.pop("meta", None)
        tree = tree.get("state", tree)
    return tree, step
