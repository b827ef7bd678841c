"""Mixture-of-experts MLP (granite-moe): GShard-style einsum dispatch.

The port of the reference's ``repro/models/moe.py``.  Tokens are grouped
(group size g, walked down until it divides the token count), routed top-k
with a capacity limit ``C = max(1, int(g * K * capacity_factor / E))``
(``C >= g`` for groups of at most 64 tokens, so decode drops nothing),
dispatched to ``(E, C, D)`` buffers by one-hot einsums in the activations'
dtype, run through each expert's SwiGLU and combined with the renormalised
router weights.  Tokens past an expert's capacity are dropped; the residual
carries them.  The Switch aux loss ``E * sum_e me_e * fe_e`` is returned
for the trainer.

``jax.lax.top_k`` puts the lower index first among equal values; the port
takes the first K of a stable descending sort, which keeps that order
(``torch.topk`` promises none).  The products stay ``torch.einsum``, as
the reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.configs.base import MoEConfig
from repro_torch.device import div_f32
from repro_torch.models.layers import _dense_init

Params = Dict[str, torch.Tensor]


def init_moe(key, d: int, cfg: MoEConfig) -> Params:
    """A key ``(2,)`` or a stack of keys ``(n, 2)`` (the stacked layers)."""
    k1, k2, k3, k4 = rng.split(key, 4).unbind(-2)
    e, f = cfg.num_experts, cfg.d_expert
    sd, sf = float(np.sqrt(np.float32(d))), float(np.sqrt(np.float32(f)))
    return {
        "router": _dense_init(k1, d, e),
        "w_gate": div_f32(rng.normal(k2, (e, d, f)), sd),
        "w_up": div_f32(rng.normal(k3, (e, d, f)), sd),
        "w_down": div_f32(rng.normal(k4, (e, f, d)), sf),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def group_size_for(n_tok: int, group_size: int = 256) -> int:
    """The largest g <= ``group_size`` that divides ``n_tok``."""
    g = min(group_size, n_tok)
    while n_tok % g:
        g -= 1
    return g


def capacity(g: int, cfg: MoEConfig, capacity_factor: float = 1.25) -> int:
    c = max(1, int(g * cfg.top_k * capacity_factor / cfg.num_experts))
    # tiny groups (decode): lossless, so decode matches prefill exactly
    return max(c, g) if g <= 64 else c


class Routing(NamedTuple):
    probs: torch.Tensor   # (G, g, E) float32
    topv: torch.Tensor    # (G, g, K) renormalised router weights
    topi: torch.Tensor    # (G, g, K) int64 expert ids
    pos: torch.Tensor     # (G, g, K) slot in the expert's queue
    keep: torch.Tensor    # (G, g, K) bool: pos < C
    C: int


def route(p: Params, xt: torch.Tensor, cfg: MoEConfig,
          capacity_factor: float = 1.25) -> Routing:
    """The router of one ``(G, g, D)`` batch of groups."""
    E, K = cfg.num_experts, cfg.top_k
    G, g, _ = xt.shape
    logits = (xt @ p["router"].to(xt.dtype)).float()               # (G,g,E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :K], topi[..., :K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    C = capacity(g, cfg, capacity_factor)
    # position of each (token, k) choice within its expert's queue
    flat = F.one_hot(topi, E).reshape(G, g * K, E)
    pos_in_e = torch.cumsum(flat, dim=1) - flat
    pos = (pos_in_e * flat).sum(-1).reshape(G, g, K)
    return Routing(probs, topv, topi, pos, pos < C, C)


def moe_mlp(p: Params, x: torch.Tensor, cfg: MoEConfig,
            group_size: int = 256,
            capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, D) -> (out, aux_loss)."""
    B, L, D = x.shape
    E = cfg.num_experts
    n_tok = B * L
    g = group_size_for(n_tok, group_size)
    G = n_tok // g
    xt = x.reshape(G, g, D)
    r = route(p, xt, cfg, capacity_factor)
    dt = x.dtype
    # dispatch (G, g, K, E, C): 1 where the token goes to (expert, slot)
    disp = (_one_hot(r.topi, E, dt)[..., None]
            * _one_hot(r.pos, r.C, dt)[..., None, :]
            * r.keep[..., None, None].to(dt))
    combine = (disp * r.topv[..., None, None].to(dt)).sum(2)        # (G,g,E,C)
    disp = disp.sum(2)

    xe = torch.einsum("gsec,gsd->gecd", disp, xt)                   # (G,E,C,D)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt)))
    u = torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(dt))
    ye = torch.einsum("gecf,efd->gecd", h * u, p["w_down"].to(dt))
    out = torch.einsum("gsec,gecd->gsd", combine, ye)               # (G,g,D)

    # Switch-style load-balance aux: E * sum_e f_e * P_e
    me = r.probs.mean(dim=(0, 1))
    fe = _one_hot(r.topi[..., 0], E, torch.float32).mean(dim=(0, 1))
    aux = E * torch.sum(me * fe)
    return out.reshape(B, L, D), aux
