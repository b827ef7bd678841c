"""Optimizers on dicts of tensors: SGD, momentum, Adam; warmup-cosine LR.

The port of the reference's ``repro/optim/optim.py``.  Adam is the paper's
§VI choice: the PS applies it to the reconstructed average gradient.
Parameters, gradients and optimizer moments are dicts of tensors with the
same keys; ``apply`` returns new dicts and leaves its inputs untouched.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


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
        device = next(iter(params.values())).device
        count = torch.zeros((), dtype=torch.int32, device=device)
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
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
            lr = lr * torch.clamp(step / self.warmup_steps, max=1.0)
        if self.total_steps > 0:
            span = max(self.total_steps - self.warmup_steps, 1)
            frac = torch.clamp((step - self.warmup_steps) / span, 0.0, 1.0)
            lr = lr * (0.5 * (1.0 + torch.cos(math.pi * frac)))
        return lr

    # ------------------------------------------------------------------ apply
    def apply(self, params: Params, grads: Params,
              state: dict) -> Tuple[Params, dict]:
        if self.grad_clip > 0:
            sq = sum((g.float() ** 2).sum() for g in grads.values())
            scale = torch.clamp(self.grad_clip / torch.clamp(
                torch.sqrt(sq), min=1e-9), max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        count = state["count"] + 1
        lr = self.lr_at(state["count"])
        wd = self.weight_decay

        if self.name == "adam":
            b1, b2 = self.b1, self.b2
            m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in grads.items()}
            v = {k: b2 * state["v"][k] + (1 - b2) * g * g
                 for k, g in grads.items()}
            c = count.to(torch.float32)
            mhat_s = 1.0 / (1 - b1 ** c)
            vhat_s = 1.0 / (1 - b2 ** c)

            def upd(p, m_, v_):
                step_ = m_ * mhat_s / (torch.sqrt(v_ * vhat_s) + self.eps)
                return p - lr * (step_ + wd * p)

            new_params = {k: upd(p, m[k], v[k]) for k, p in params.items()}
            return new_params, {"m": m, "v": v, "count": count}
        if self.name == "momentum":
            m = {k: self.momentum * state["m"][k] + g for k, g in grads.items()}
            new_params = {k: p - lr * (m[k] + wd * p) for k, p in params.items()}
            return new_params, {"m": m, "count": count}
        if self.name == "sgd":
            new_params = {k: p - lr * (grads[k] + wd * p)
                          for k, p in params.items()}
            return new_params, {"count": count}
        raise ValueError(self.name)
