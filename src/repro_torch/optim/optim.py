"""Optimizers on dicts of tensors: SGD, momentum, Adam; warmup-cosine LR.

The port of the reference's ``repro/optim/optim.py``.  Adam is the paper's
§VI choice: the PS applies it to the reconstructed average gradient.
Parameters, gradients and optimizer moments are dicts of tensors with the
same keys, nested or flat (a zoo model's params nest); ``apply`` returns
new dicts and leaves its inputs untouched.

A sweep's grid gives every leaf a leading point axis.  The step count is
then shared by all points (0-dim), or one per point (``(G,)``) where a
guard may skip a point's step; the schedule's scalars follow it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.convert import tree_leaves, tree_map
from repro_torch.device import div_f32

Params = Dict[str, Any]


def _per_leaf(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A step-count scalar against a leaf: as it is when 0-dim; one per
    point, ``(G,)``, shaped to broadcast along the leaf's trailing axes."""
    if v.dim() == 0:
        return v
    return v.reshape(v.shape + (1,) * (leaf.dim() - v.dim()))


@dataclass(frozen=True)
class Optimizer:
    name: str = "adam"
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    momentum: float = 0.9
    weight_decay: float = 0.0
    warmup_steps: int = 0
    total_steps: int = 0  # 0 => constant LR after warmup
    grad_clip: float = 0.0

    # ------------------------------------------------------------------ state
    def init(self, params: Params) -> dict:
        device = tree_leaves(params)[0].device
        count = torch.zeros((), dtype=torch.int32, device=device)
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        if self.name == "adam":
            return {"m": zeros(), "v": zeros(), "count": count}
        if self.name == "momentum":
            return {"m": zeros(), "count": count}
        if self.name == "sgd":
            return {"count": count}
        raise ValueError(self.name)

    # --------------------------------------------------------------- schedule
    def lr_at(self, step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        lr = torch.full_like(step, self.lr)
        if self.warmup_steps > 0:
            lr = lr * torch.clamp(div_f32(step, self.warmup_steps), max=1.0)
        if self.total_steps > 0:
            span = max(self.total_steps - self.warmup_steps, 1)
            frac = torch.clamp(div_f32(step - self.warmup_steps, span), 0.0,
                               1.0)
            lr = lr * (0.5 * (1.0 + torch.cos(math.pi * frac)))
        return lr

    # ------------------------------------------------------------------ apply
    def apply(self, params: Params, grads: Params,
              state: dict) -> Tuple[Params, dict]:
        steps, state = self.steps(params, grads, state)
        return tree_map(torch.sub, params, steps), state

    def steps(self, params: Params, grads: Params,
              state: dict) -> Tuple[Params, dict]:
        """The step each parameter takes, ``apply`` being ``params -
        steps``, and the new state."""
        if self.grad_clip > 0:
            sq = sum((g.float() ** 2).sum() for g in tree_leaves(grads))
            scale = torch.clamp(self.grad_clip / torch.clamp(
                torch.sqrt(sq), min=1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        count = state["count"] + 1
        lr = self.lr_at(state["count"])
        wd = self.weight_decay

        if self.name == "adam":
            b1, b2 = self.b1, self.b2
            m = tree_map(lambda g, m_: b1 * m_ + (1 - b1) * g, grads,
                         state["m"])
            v = tree_map(lambda g, v_: b2 * v_ + (1 - b2) * g * g, grads,
                         state["v"])
            c = count.to(torch.float32)
            mhat_s = 1.0 / (1 - b1 ** c)
            vhat_s = 1.0 / (1 - b2 ** c)

            def upd(p, m_, v_):
                step_ = m_ * _per_leaf(mhat_s, p) / (
                    torch.sqrt(v_ * _per_leaf(vhat_s, p)) + self.eps)
                return _per_leaf(lr, p) * (step_ + wd * p)

            steps = tree_map(upd, params, m, v)
            return steps, {"m": m, "v": v, "count": count}
        if self.name == "momentum":
            m = tree_map(lambda g, m_: self.momentum * m_ + g, grads,
                         state["m"])
            steps = tree_map(lambda p, m_: _per_leaf(lr, p) * (m_ + wd * p),
                             params, m)
            return steps, {"m": m, "count": count}
        if self.name == "sgd":
            steps = tree_map(lambda p, g: _per_leaf(lr, p) * (g + wd * p),
                             params, grads)
            return steps, {"count": count}
        raise ValueError(self.name)


def make_optimizer(train_cfg) -> Optimizer:
    """The optimizer a :class:`~repro_torch.configs.base.TrainConfig`
    describes."""
    return Optimizer(
        name=train_cfg.optimizer,
        lr=train_cfg.lr,
        weight_decay=train_cfg.weight_decay,
        warmup_steps=train_cfg.warmup_steps,
        total_steps=train_cfg.total_steps,
        grad_clip=train_cfg.grad_clip,
    )
